"""idemixgen: an issuer key and anonymous credentials.

The port's copy of fabric_mod_tpu/cli/idemixgen.py (reference:
common/tools/idemixgen — ca-keygen writes the issuer key pair,
signerconfig issues a credential for one signer; the artifacts are the
JSON forms the idemix MSP reads: `IssuerKey.json`,
`IssuerPublicKey.json` and `user/SignerConfig.json`).  The library
calls take `rng` (a random.Random) for reproducible artifacts; the
command line passes none, so every scalar comes from `secrets`, as the
reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

from fabric_mod_tpu_torch.idemix import credential as cred

DEFAULT_ATTRS = ("OU", "Role", "EnrollmentID", "RevocationHandle")


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def ca_keygen(out_dir: str, attrs: Sequence[str] = DEFAULT_ATTRS,
              rng=None) -> cred.IssuerKey:
    """Write an issuer key pair for `attrs` under `out_dir`."""
    ik = cred.IssuerKey(list(attrs), rng=rng)
    os.makedirs(out_dir, exist_ok=True)
    _dump(os.path.join(out_dir, "IssuerKey.json"), ik.to_dict())
    _dump(os.path.join(out_dir, "IssuerPublicKey.json"), ik.public_dict())
    return ik


def signerconfig(ca_input: str, out_dir: str, org_unit: str = "",
                 enrollment_id: str = "", role: int = 0,
                 rng=None) -> dict:
    """Issue a credential under the issuer key in `ca_input` and write
    the signer's config to `out_dir`/user/SignerConfig.json; returns
    that config."""
    with open(os.path.join(ca_input, "IssuerKey.json")) as f:
        ik = cred.IssuerKey.from_dict(json.load(f))
    sk = cred._rand_zr(rng)
    attrs = []
    for name in ik.attr_names:
        if name == "OU":
            attrs.append(cred._hash_to_zr(org_unit.encode()))
        elif name == "Role":
            attrs.append(role)
        elif name == "EnrollmentID":
            attrs.append(cred._hash_to_zr(enrollment_id.encode()))
        else:
            attrs.append(0)
    c = cred.issue(ik, sk, attrs, rng=rng)
    conf = {"sk": hex(sk), "credential": c.to_dict(),
            "organizational_unit": org_unit,
            "enrollment_id": enrollment_id, "role": role}
    user_dir = os.path.join(out_dir, "user")
    os.makedirs(user_dir, exist_ok=True)
    _dump(os.path.join(user_dir, "SignerConfig.json"), conf)
    return conf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_mod_tpu_torch.cli.main idemixgen")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ca-keygen", help="generate an issuer key pair")
    p.add_argument("--output", default="idemix-config")
    p.add_argument("--attrs", default=",".join(DEFAULT_ATTRS),
                   help="comma-separated attribute names")

    p = sub.add_parser("signerconfig",
                       help="issue a credential for one signer")
    p.add_argument("--ca-input", default="idemix-config")
    p.add_argument("--output", default="idemix-config")
    p.add_argument("--org-unit", default="")
    p.add_argument("--enrollment-id", default="")
    p.add_argument("--role", type=int, default=0)

    args = ap.parse_args(argv)
    if args.cmd == "ca-keygen":
        ca_keygen(args.output, [a for a in args.attrs.split(",") if a])
        print(f"issuer key written to {args.output}/")
        return 0
    signerconfig(args.ca_input, args.output, args.org_unit,
                 args.enrollment_id, args.role)
    print(f"signer config written to {os.path.join(args.output, 'user')}/")
    return 0
