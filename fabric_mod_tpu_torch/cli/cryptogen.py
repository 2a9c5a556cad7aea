"""cryptogen: generate a test network's crypto tree from a config.

The port's copy of fabric_mod_tpu/cli/cryptogen.py (reference:
internal/cryptogen — ca.go and msp.go generating per-org CA hierarchies
and MSP directory layouts from crypto-config.yaml).  The config is read
by utils/yamlread.py, which takes the subset such documents use:

    PeerOrgs:
      - Name: Org1
        PeerCount: 2
        UserCount: 1
    OrdererOrgs:
      - Name: OrdererOrg
        OrdererCount: 1

Output layout per org under <out>/<org>/:
    ca/ca.pem ca.key
    peers/peer<N>.pem .key        (OU=peer)
    orderers/orderer<N>.pem .key  (OU=orderer)
    users/user<N>.pem .key        (OU=client)
    admin/admin.pem .key          (OU=admin)

Every key and serial number comes from `seed` (msp/ca.py); the command
line draws a fresh one from `secrets`, as the reference's keys are
random.  `network_material` reads such a tree and a genesis block back
as the e2e Network's material.
"""
from __future__ import annotations

import os
import secrets
from typing import Dict, Optional

from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.utils import yamlread


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _gen_org(out: str, name: str, node_kind: str, node_count: int,
             user_count: int, seed: bytes, now) -> calib.CA:
    ca = calib.CA(f"ca.{name.lower()}", name, seed=seed, now=now)
    base = os.path.join(out, name)
    _write(os.path.join(base, "ca", "ca.pem"), calib.cert_pem(ca.cert))
    _write(os.path.join(base, "ca", "ca.key"), calib.key_pem(ca.key))

    def issue(sub: str, stem: str, cn: str, ou: str) -> None:
        cert, key = ca.issue(cn, name, ous=[ou])
        _write(os.path.join(base, sub, f"{stem}.pem"), calib.cert_pem(cert))
        _write(os.path.join(base, sub, f"{stem}.key"), calib.key_pem(key))
    for i in range(node_count):
        issue(f"{node_kind}s", f"{node_kind}{i}",
              f"{node_kind}{i}.{name.lower()}", node_kind)
    for i in range(user_count):
        issue("users", f"user{i}", f"user{i}@{name.lower()}", "client")
    issue("admin", "admin", f"admin@{name.lower()}", "admin")
    return ca


def generate(config_path: str, out_dir: str, seed: Optional[bytes] = None,
             now=None) -> Dict[str, list]:
    """Write the crypto tree of the config at `config_path` under
    `out_dir`; {"peer_orgs": [...], "orderer_orgs": [...]}.  `seed`
    (default: 32 bytes from `secrets`) makes every key; `now` anchors
    the validity windows (default: the current time)."""
    conf = yamlread.load_file(config_path) or {}
    seed = secrets.token_bytes(32) if seed is None else seed
    generated: Dict[str, list] = {"peer_orgs": [], "orderer_orgs": []}
    for org in conf.get("PeerOrgs", []) or []:
        _gen_org(out_dir, org["Name"], "peer", int(org.get("PeerCount", 1)),
                 int(org.get("UserCount", 1)), seed, now)
        generated["peer_orgs"].append(org["Name"])
    for org in conf.get("OrdererOrgs", []) or []:
        _gen_org(out_dir, org["Name"], "orderer",
                 int(org.get("OrdererCount", 1)), 0, seed, now)
        generated["orderer_orgs"].append(org["Name"])
    return generated


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _signer(crypto_dir: str, org: str, sub: str, stem: str):
    base = os.path.join(crypto_dir, org, sub)
    return (org, _read(os.path.join(base, f"{stem}.pem")),
            _read(os.path.join(base, f"{stem}.key")))


def network_material(crypto_dir: str, genesis: bytes):
    """An e2e.NetworkMaterial from a cryptogen tree and an encoded
    genesis block made over it (configtxgen): every application org of
    the genesis contributes its CA, peer0 and admin; the client is the
    first org's user0; each orderer org's orderer0 signs blocks (an
    etcdraft genesis maps each consenter id "ordererN" to the orderer
    org's ordererN); the orderer org's admin signs its config updates."""
    from fabric_mod_tpu_torch.channelconfig import (Bundle,
                                                    config_from_block)
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.e2e import NetworkMaterial
    from fabric_mod_tpu_torch.protos import messages as m
    channel_id, config = config_from_block(m.Block.decode(genesis))
    bundle = Bundle(channel_id, config, SwCSP())
    orgs = list(bundle.application.org_mspids)
    orderer_orgs = list(bundle.orderer.org_mspids)
    if len(orderer_orgs) != 1:
        raise ValueError(f"one orderer org expected, got {orderer_orgs}")
    oorg = orderer_orgs[0]
    consenters = {oid: _signer(crypto_dir, oorg, "orderers", oid)
                  for oid in bundle.orderer.consenters()}
    return NetworkMaterial(
        ca_pems={org: _read(os.path.join(crypto_dir, org, "ca", "ca.pem"))
                 for org in orgs},
        orderer_ca_pem=_read(os.path.join(crypto_dir, oorg, "ca", "ca.pem")),
        client=_signer(crypto_dir, orgs[0], "users", "user0"),
        peers={org: _signer(crypto_dir, org, "peers", "peer0")
               for org in orgs},
        admins={org: _signer(crypto_dir, org, "admin", "admin")
                for org in orgs},
        orderer=(next(iter(consenters.values())) if consenters
                 else _signer(crypto_dir, oorg, "orderers", "orderer0")),
        genesis=genesis, consenters=consenters,
        orderer_admin=_signer(crypto_dir, oorg, "admin", "admin"))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="cryptogen")
    ap.add_argument("--config", required=True)
    ap.add_argument("--output", default="crypto-config")
    args = ap.parse_args(argv)
    got = generate(args.config, args.output)
    print(f"generated {got['peer_orgs']} + {got['orderer_orgs']} "
          f"under {args.output}")
    return 0
