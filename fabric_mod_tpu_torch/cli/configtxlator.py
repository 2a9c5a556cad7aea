"""configtxlator: proto <-> JSON translation and config update
computation.

The port's copy of fabric_mod_tpu/cli/configtxlator.py (reference:
internal/configtxlator — the proto_encode, proto_decode and
compute_update commands, update/update.go).  The translation is
protos/jsonpb.py; compute_update is channelconfig/update.py's, whose
ConfigUpdate the channel's config processing accepts.
"""
from __future__ import annotations

import argparse
import json
import sys

from fabric_mod_tpu_torch.protos import jsonpb
from fabric_mod_tpu_torch.protos import messages as m


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_mod_tpu_torch.cli.main configtxlator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("proto_decode", help="wire bytes -> JSON on stdout")
    p.add_argument("--type", required=True,
                   help="message type name, e.g. Config, Block")
    p.add_argument("--input", required=True)

    p = sub.add_parser("proto_encode", help="JSON -> wire bytes")
    p.add_argument("--type", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("compute_update",
                       help="delta between two Config protos")
    p.add_argument("--channel_id", required=True)
    p.add_argument("--original", required=True)
    p.add_argument("--updated", required=True)
    p.add_argument("--output", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "proto_decode":
        json.dump(jsonpb.proto_decode(args.type, _read(args.input)),
                  sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if args.cmd == "proto_encode":
        with open(args.input) as f:
            raw = jsonpb.proto_encode(args.type, json.load(f))
        with open(args.output, "wb") as f:
            f.write(raw)
        return 0
    # the diff of the updated Config's channel group against the
    # original (the reference's command hands compute_update the whole
    # Config, where it takes the group, and raises AttributeError)
    from fabric_mod_tpu_torch.channelconfig import compute_update
    update = compute_update(args.channel_id,
                            m.Config.decode(_read(args.original)),
                            m.Config.decode(_read(args.updated)).channel_group)
    with open(args.output, "wb") as f:
        f.write(update.encode())
    return 0
