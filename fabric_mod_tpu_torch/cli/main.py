"""The umbrella CLI: `python -m fabric_mod_tpu_torch.cli.main <tool> ...`

The port's copy of fabric_mod_tpu/cli/main.py (reference: the
cmd/{peer,orderer,configtxgen,cryptogen} binaries and internal/peer's
cobra tree, collapsed to subcommands of one entry).  The offline tools
are here; `node` and `chaincode` serve and dial over the transport,
which the port does not have yet, so they answer so and exit 2 without
importing anything.
"""
from __future__ import annotations

import sys

TOOLS = ("cryptogen", "configtxgen", "configtxlator", "idemixgen",
         "discover", "ledger")
WITH_TRANSPORT = ("node", "chaincode")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m fabric_mod_tpu_torch.cli.main "
              f"{{{'|'.join(TOOLS + WITH_TRANSPORT)}}} ...",
              file=sys.stderr)
        return 2
    tool, rest = argv[0], argv[1:]
    if tool in WITH_TRANSPORT:
        print(f"{tool}: not in the port yet; it comes with the transport "
              f"(comm/, the orderer and peer servers)", file=sys.stderr)
        return 2
    if tool == "cryptogen":
        from fabric_mod_tpu_torch.cli.cryptogen import main as run
    elif tool == "configtxgen":
        from fabric_mod_tpu_torch.cli.configtxgen import main as run
    elif tool == "configtxlator":
        from fabric_mod_tpu_torch.cli.configtxlator import main as run
    elif tool == "idemixgen":
        from fabric_mod_tpu_torch.cli.idemixgen import main as run
    elif tool == "discover":
        from fabric_mod_tpu_torch.cli.discover import main as run
    elif tool == "ledger":
        from fabric_mod_tpu_torch.cli.ledgerutil import main as run
    else:
        print(f"unknown tool {tool!r}", file=sys.stderr)
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main())
