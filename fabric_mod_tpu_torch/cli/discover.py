"""discover: query a channel's peers, config and endorsement layouts.

The port's copy of fabric_mod_tpu/cli/discover.py (reference:
cmd/discover and discovery/cmd — the discovery service's client CLI,
its peers, config and endorsers subcommands).  The tool builds the
discovery view from a genesis or config block and a membership JSON
({org: [endpoint, ...]}), the inputs the in-process service reads from
gossip.

The offline tool answers peers, config and endorsers, none of which
checks a signature.  The port's DiscoveryService requires a
`verify_many` for its Readers checks (discovery/service.py), so the
tool hands it one that raises: a query that reached a signature check
would fail loudly rather than verify on the host.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.protos import messages as m


def _load_bundle(genesis_path: str):
    with open(genesis_path, "rb") as f:
        block = m.Block.decode(f.read())
    cid, config = config_from_block(block)
    return cid, Bundle(cid, config, SwCSP())


def _membership_fn(path: Optional[str]):
    members: Dict[str, list] = {}
    if path:
        with open(path) as f:
            raw = json.load(f)
        for org, eps in raw.items():
            members[org] = [m.GossipMember(endpoint=e) for e in eps]
    return lambda: members


def _no_verify(items, *args, **kwargs):
    raise RuntimeError("the offline discover tool checks no signatures")


class _StaticVinfo:
    """Every chaincode endorsed by the channel's Endorsement policy."""

    def validation_info(self, ns):
        return "builtin", m.ApplicationPolicy(
            channel_config_policy_reference=(
                "/Channel/Application/Endorsement")).encode()


def query(cmd: str, genesis_path: str, membership_path: Optional[str] = None,
          chaincode: Optional[str] = None) -> dict:
    """The JSON answer of `cmd` ("peers", "config" or "endorsers") over
    the channel of the block at `genesis_path`."""
    from fabric_mod_tpu_torch.discovery.service import DiscoveryService
    cid, bundle = _load_bundle(genesis_path)
    svc = DiscoveryService(lambda: bundle, _StaticVinfo(),
                           _membership_fn(membership_path), _no_verify)
    if cmd == "peers":
        return {"channel": cid,
                "peers": {org: [mem.endpoint for mem in members]
                          for org, members in svc.peers().items()}}
    if cmd == "config":
        cfg = svc.config()
        return {"channel": cid, "config": {
            "msps": {k: [c.decode() for c in v]
                     for k, v in cfg["msps"].items()},
            "orderers": cfg["orderers"]}}
    if cmd != "endorsers":
        raise ValueError(f"unknown discover command {cmd!r}")
    desc = svc.peers_for_endorsement(chaincode)
    return {"channel": cid, "chaincode": chaincode,
            "layouts": [dict(lo.quantities_by_org) for lo in desc.layouts],
            "peers_by_org": {org: [mem.endpoint for mem in members]
                             for org, members in desc.peers_by_org.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_mod_tpu_torch.cli.main discover")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("peers", "config", "endorsers"):
        p = sub.add_parser(name)
        p.add_argument("--genesis", required=True,
                       help="channel genesis/config block file")
        p.add_argument("--membership",
                       help="JSON file: {org: [endpoint, ...]}")
        if name == "endorsers":
            p.add_argument("--chaincode", required=True)
    args = ap.parse_args(argv)
    out = query(args.cmd, args.genesis, args.membership,
                getattr(args, "chaincode", None))
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0
