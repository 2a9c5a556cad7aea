"""The umbrella CLI: `python -m fabric_mod_tpu_torch.cli.main <tool> ...`

The port's copy of fabric_mod_tpu/cli/main.py (reference: the
cmd/{peer,orderer,configtxgen,cryptogen} binaries and internal/peer's
cobra tree, collapsed to subcommands of one entry): the offline tools,
`node` (an orderer or a peer process) and `chaincode` (the client).
"""
from __future__ import annotations

import sys

TOOLS = ("cryptogen", "configtxgen", "configtxlator", "idemixgen",
         "discover", "node", "ledger", "chaincode")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m fabric_mod_tpu_torch.cli.main "
              f"{{{'|'.join(TOOLS)}}} ...",
              file=sys.stderr)
        return 2
    tool, rest = argv[0], argv[1:]
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
    elif tool == "node":
        from fabric_mod_tpu_torch.cli.node import main as run
    elif tool == "ledger":
        from fabric_mod_tpu_torch.cli.ledgerutil import main as run
    elif tool == "chaincode":
        from fabric_mod_tpu_torch.cli.chaincode import main as run
    else:
        print(f"unknown tool {tool!r}", file=sys.stderr)
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main())
