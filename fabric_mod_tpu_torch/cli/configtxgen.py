"""configtxgen: render a genesis block from a profile and a crypto tree.

The port's copy of fabric_mod_tpu/cli/configtxgen.py (reference:
internal/configtxgen — encoder.go building the channel group from
configtx.yaml profiles, emitting the genesis block the orderer
bootstraps from).  The profile is read by utils/yamlread.py:

    ChannelID: mychannel
    PeerOrgs: [Org1, Org2]        # must exist in the crypto dir
    OrdererOrgs: [OrdererOrg]
    BatchSize:
      MaxMessageCount: 500
      AbsoluteMaxBytes: 10485760
      PreferredMaxBytes: 2097152
    BatchTimeout: 2s
    ConsensusType: solo           # or etcdraft, with
    Consenters: []                # its consenter ids

Each org's root is its `ca/ca.pem` under the crypto dir (cryptogen's
layout).
"""
from __future__ import annotations

import os
from typing import Tuple

from fabric_mod_tpu_torch.channelconfig import genesis
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils import yamlread


def _org_roots(crypto_dir: str, org: str) -> list:
    with open(os.path.join(crypto_dir, org, "ca", "ca.pem"), "rb") as f:
        return [f.read()]


def make_genesis(profile_path: str, crypto_dir: str) -> Tuple[str, m.Block]:
    """(channel id, genesis block) of the profile at `profile_path`."""
    prof = yamlread.load_file(profile_path) or {}
    channel_id = prof.get("ChannelID", "testchannel")
    batch = prof.get("BatchSize", {}) or {}
    block = genesis.standard_network(
        channel_id,
        {org: _org_roots(crypto_dir, org)
         for org in prof.get("PeerOrgs", [])},
        {org: _org_roots(crypto_dir, org)
         for org in prof.get("OrdererOrgs", [])},
        max_message_count=int(batch.get("MaxMessageCount", 500)),
        absolute_max_bytes=int(batch.get("AbsoluteMaxBytes",
                                         10 * 1024 * 1024)),
        preferred_max_bytes=int(batch.get("PreferredMaxBytes",
                                          2 * 1024 * 1024)),
        batch_timeout=str(prof.get("BatchTimeout", "2s")),
        consensus_type=str(prof.get("ConsensusType", "solo")),
        consenters=tuple(prof.get("Consenters", []) or ()))
    return channel_id, block


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="configtxgen")
    ap.add_argument("--profile", required=True)
    ap.add_argument("--crypto", default="crypto-config")
    ap.add_argument("--output", default="genesis.block")
    args = ap.parse_args(argv)
    channel_id, block = make_genesis(args.profile, args.crypto)
    with open(args.output, "wb") as f:
        f.write(block.encode())
    print(f"wrote genesis block for {channel_id!r} to {args.output}")
    return 0
