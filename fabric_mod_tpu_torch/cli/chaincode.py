"""chaincode: invoke and query against running peers and an orderer.

The port's copy of fabric_mod_tpu/cli/chaincode.py (reference:
internal/peer/chaincode — `peer chaincode invoke` collects endorsements
over the Endorser service and broadcasts the transaction; `peer
chaincode query` evaluates on one peer and prints the payload).

    python -m fabric_mod_tpu_torch.cli.main chaincode invoke \\
        --channel ch --name mycc --args put,k,v --crypto crypto \\
        --org Org1 --user user0 --peers 127.0.0.1:7051,127.0.0.1:8051 \\
        --orderer 127.0.0.1:7050 [--tls-ca ca.crt] [--wait-event]

    python -m fabric_mod_tpu_torch.cli.main chaincode query \\
        --channel ch --name mycc --args get,k --crypto crypto \\
        --org Org1 --user user0 --peers 127.0.0.1:7051

Identities load through the port's X.509 layer (bccsp/x509.py).
"""
from __future__ import annotations

import json
import os
import sys


def _load_identity(crypto_dir: str, org: str, kind: str, name: str):
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                     deserialize_cert)
    base = os.path.join(crypto_dir, org, kind)
    with open(os.path.join(base, f"{name}.pem"), "rb") as f:
        cert = deserialize_cert(f.read())
    with open(os.path.join(base, f"{name}.key"), "rb") as f:
        key_pem = f.read()
    return SigningIdentity(org, cert, key_pem, SwCSP())


def main(argv=None) -> int:
    import argparse

    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
    from fabric_mod_tpu_torch.peer.endorserserver import (
        RemoteEndorser, invoke_remote, query_remote)

    ap = argparse.ArgumentParser(prog="chaincode")
    ap.add_argument("verb", choices=("invoke", "query"))
    ap.add_argument("--channel", required=True)
    ap.add_argument("--name", default="mycc")
    ap.add_argument("--args", required=True,
                    help="comma-separated chaincode args")
    ap.add_argument("--crypto", default="crypto-config")
    ap.add_argument("--org", default="Org1")
    ap.add_argument("--user", default="user0")
    ap.add_argument("--peers", required=True,
                    help="comma-separated endorser endpoints")
    ap.add_argument("--orderer", default="",
                    help="broadcast endpoint (invoke)")
    ap.add_argument("--tls-ca", default="",
                    help="PEM bundle to verify TLS servers")
    ap.add_argument("--tls-authority", default="",
                    help="expected TLS server name override")
    ap.add_argument("--wait-event", action="store_true",
                    help="after broadcast, wait on the first peer's "
                    "DeliverFiltered stream for the tx's validation "
                    "code (reference: peer chaincode invoke "
                    "--waitForEvent)")
    ap.add_argument("--wait-timeout", type=float, default=30.0)
    args = ap.parse_args(argv)

    root_pem = None
    if args.tls_ca:
        with open(args.tls_ca, "rb") as f:
            root_pem = f.read()
    signer = _load_identity(args.crypto, args.org, "users", args.user)
    cc_args = [a.encode() for a in args.args.split(",")]

    clients = [GRPCClient(addr, server_root_pem=root_pem,
                          override_authority=args.tls_authority or None)
               for addr in args.peers.split(",") if addr]
    endorsers = [RemoteEndorser(c) for c in clients]
    try:
        if args.verb == "query":
            payload = query_remote(args.channel, args.name, cc_args,
                                   signer, endorsers[0])
            sys.stdout.buffer.write(payload)
            sys.stdout.write("\n")
            return 0
        if not args.orderer:
            print("invoke needs --orderer", file=sys.stderr)
            return 2
        from fabric_mod_tpu_torch.peer.deliverevents import \
            EventDeliverClient
        from fabric_mod_tpu_torch.peer.grpcdeliver import GrpcBroadcaster
        oclient = GRPCClient(args.orderer, server_root_pem=root_pem,
                             override_authority=args.tls_authority or None)
        bcast = GrpcBroadcaster(oclient)
        try:
            wait_start = 0
            if args.wait_event:
                # pin the subscription before broadcasting: the tx can
                # only commit at a block >= the peer's current height,
                # so a stream starting there cannot miss it
                info = json.loads(query_remote(
                    args.channel, "qscc", [b"GetChainInfo"], signer,
                    endorsers[0]))
                wait_start = int(info["height"])
            tx_id = invoke_remote(args.channel, args.name, cc_args,
                                  signer, endorsers, bcast)
            if args.wait_event:
                waiter = EventDeliverClient(clients[0], args.channel,
                                            signer)
                code = waiter.wait_for_tx(tx_id, start=wait_start,
                                          timeout_s=args.wait_timeout)
                print(f"{tx_id} {code}")
                return 0 if code == 0 else 3   # 0 == VALID
            print(tx_id)
            return 0
        finally:
            bcast.close()
            oclient.close()
    except Exception as e:
        # one line for the expected failure classes: unreachable
        # endpoints (RpcError), missing files (OSError), rejected
        # endorsements or broadcasts (RuntimeError)
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        for c in clients:
            c.close()


if __name__ == "__main__":
    sys.exit(main())
