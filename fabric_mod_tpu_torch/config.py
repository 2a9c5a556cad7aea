"""Node configuration: YAML files and explicit overrides.

The port's copy of fabric_mod_tpu/config.py (reference: the viper config
system — core/peer/config.go reading core.yaml, orderer/common/
localconfig/config.go:505 reading orderer.yaml — collapsed to one typed
loader).

Lookup order (highest wins): `overrides` ({yaml_path: value}, the
reference's `<PREFIX>_SECTION_SUBKEY` environment overrides as an
argument: the port reads no environment), the YAML file (read by
utils/yamlread.py), the dataclass default.

`PeerConfig.bccsp` picks the peer's verifier: "GPU" (the default, the
card's `GpuVerifier`, which raises without a card) or "SW" (the host's
`SwVerifier`).  Any other value, the reference's "TPU" among them,
raises ValueError.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from fabric_mod_tpu_torch.utils import yamlread

BCCSP_CHOICES = ("GPU", "SW")


def _dig(data: Dict[str, Any], path: str) -> Optional[Any]:
    cur: Any = data
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        # tolerate case differences, as viper does
        lowered = {str(k).lower(): v for k, v in cur.items()}
        cur = lowered.get(part.lower())
    return cur


@dataclasses.dataclass
class PeerConfig:
    """(reference: core/peer/config.go Config — the subset in play)"""
    ledger_dir: str = "data/ledgers"
    validator_pool_size: int = 0        # 0 = device-batched (no pool)
    ops_listen_address: str = "127.0.0.1:0"
    ops_tls_cert: str = ""              # operations TLS (reference:
    ops_tls_key: str = ""               # core.yaml operations.tls.*)
    ops_tls_client_ca: str = ""
    log_spec: str = "info"
    deliver_queue_size: int = 8
    bccsp: str = "GPU"                  # GPU | SW

    FIELDS = {
        "ledger_dir": "peer.fileSystemPath",
        "validator_pool_size": "peer.validatorPoolSize",
        "ops_listen_address": "operations.listenAddress",
        "ops_tls_cert": "operations.tls.cert.file",
        "ops_tls_key": "operations.tls.key.file",
        "ops_tls_client_ca": "operations.tls.clientRootCAs.file",
        "log_spec": "logging.spec",
        "deliver_queue_size": "peer.deliverclient.queueSize",
        "bccsp": "peer.BCCSP.Default",
    }


@dataclasses.dataclass
class OrdererConfig:
    """(reference: orderer/common/localconfig/config.go)"""
    ledger_dir: str = "data/orderer"
    consensus_type: str = "solo"
    ops_listen_address: str = "127.0.0.1:0"
    log_spec: str = "info"

    FIELDS = {
        "ledger_dir": "general.fileSystemPath",
        "consensus_type": "general.consensusType",
        "ops_listen_address": "operations.listenAddress",
        "log_spec": "logging.spec",
    }


def load_config(cls, path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None):
    """A typed config: defaults <- YAML at `path` <- `overrides`
    ({yaml_path: value}, matched without regard to case)."""
    data: Dict[str, Any] = {}
    if path and os.path.exists(path):
        data = yamlread.load_file(path) or {}
    over = {k.lower(): v for k, v in (overrides or {}).items()}
    out = cls()
    for attr, yaml_path in cls.FIELDS.items():
        val = _dig(data, yaml_path)
        if yaml_path.lower() in over:
            val = over[yaml_path.lower()]
        if val is None:
            continue
        default = getattr(out, attr)
        if isinstance(default, bool):
            val = str(val).lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            val = int(val)
        else:
            val = str(val)
        setattr(out, attr, val)
    if hasattr(out, "bccsp"):
        if out.bccsp.upper() not in BCCSP_CHOICES:
            raise ValueError(f"peer.BCCSP.Default {out.bccsp!r}: the port "
                             f"takes one of {BCCSP_CHOICES}")
    return out
