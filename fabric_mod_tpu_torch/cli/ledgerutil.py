"""ledger: operator maintenance and the snapshot CLI.

The port's copy of fabric_mod_tpu/cli/ledgerutil.py (reference: the
`peer node reset/rollback/rebuild-dbs` cobra commands of
internal/peer/node/*.go and the `peer snapshot` CLI), over the port's
ledger/admin.py and ledger/snapshot.py.  The ledgers are durable
KvLedgers.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_mod_tpu_torch.cli.main ledger")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("reset", "rebuild-dbs"):
        p = sub.add_parser(name)
        p.add_argument("--ledger", required=True,
                       help="ledger directory (peer data/<channel>)")
    p = sub.add_parser("rollback")
    p.add_argument("--ledger", required=True)
    p.add_argument("--block", type=int, required=True)
    p = sub.add_parser("snapshot")
    p.add_argument("--ledger", required=True)
    p.add_argument("--channel", required=True)
    p.add_argument("--output", required=True)
    p = sub.add_parser("join-from-snapshot")
    p.add_argument("--snapshot", required=True)
    p.add_argument("--ledger", required=True)
    args = ap.parse_args(argv)

    from fabric_mod_tpu_torch.ledger import admin
    if args.cmd in ("reset", "rebuild-dbs"):
        admin.rebuild_dbs(args.ledger)
        print(f"dropped derived stores under {args.ledger}; "
              f"state rebuilds from blocks on next start")
    elif args.cmd == "rollback":
        admin.rollback(args.ledger, args.block)
        print(f"rolled {args.ledger} back to block {args.block}")
    elif args.cmd == "snapshot":
        from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
        from fabric_mod_tpu_torch.ledger.snapshot import generate_snapshot
        led = KvLedger(args.channel, args.ledger)
        try:
            meta = generate_snapshot(led, args.output)
        finally:
            led.close()
        print(f"snapshot of {meta['channel']} at height "
              f"{meta['height']} -> {args.output}")
    else:
        from fabric_mod_tpu_torch.ledger.snapshot import \
            bootstrap_from_snapshot
        led = bootstrap_from_snapshot(args.snapshot, args.ledger)
        try:
            print(f"bootstrapped {led.ledger_id} at height {led.height} "
                  f"under {args.ledger}")
        finally:
            led.close()
    return 0
