"""Hierarchical logging with runtime level specs.

The port's copy of fabric_mod_tpu/observability/logging.py (:33-97;
reference: common/flogging — per-logger level specs, `loggerlevels.go:174`
ActivateSpec parsing "gossip=debug:info", the observer hook feeding
log-count metrics, and the /logspec admin endpoint that
observability/opsserver.py serves).

Built over stdlib logging: `get_logger("peer.validator")` returns a
logger under the "fabric_mod_tpu_torch" root (the port's modules log
through `logging.getLogger(__name__)`, so they sit in the same tree);
`activate_spec` applies "name=level[:name2=level2]:default" at runtime,
setting the same level as the reference's for each logger suffix.  The
counting handler counts emitted records per level on a MetricsProvider
(`logging_entries_total{level=...}`).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        MetricsProvider)

ROOT = "fabric_mod_tpu_torch"

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "warning": logging.WARNING,
           "error": logging.ERROR, "fatal": logging.CRITICAL,
           "panic": logging.CRITICAL}

_spec_lock = threading.Lock()
_current_spec = "info"


class _CountingHandler(logging.Handler):
    """The flogging observer: counts emitted records per level."""

    def __init__(self, provider: MetricsProvider):
        super().__init__(level=logging.DEBUG)
        self._counter = provider.new_counter(MetricOpts(
            "logging", "", "entries_total",
            "Number of log entries emitted", ("level",)))

    def emit(self, record: logging.LogRecord) -> None:
        self._counter.with_labels(record.levelname.lower()).add()


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}" if name else ROOT)


def init_logging(provider: Optional[MetricsProvider] = None,
                 spec: str = "info") -> None:
    """A stream handler on the root logger (once), the counting handler
    on `provider` (once, when given), then `activate_spec(spec)`."""
    root = logging.getLogger(ROOT)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).4s [%(name)s] %(message)s"))
        root.addHandler(h)
    if provider is not None and not any(
            isinstance(h, _CountingHandler) for h in root.handlers):
        root.addHandler(_CountingHandler(provider))
    activate_spec(spec)


def activate_spec(spec: str) -> None:
    """Apply a level spec: "debug", "peer=debug:info",
    "gossip=warn:ledger=debug:info" (reference: ActivateSpec).  An
    unknown level raises ValueError and changes nothing."""
    global _current_spec
    default = logging.INFO
    overrides: Dict[str, int] = {}
    for part in spec.split(":"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, lvl = part.partition("=")
            if lvl.lower() not in _LEVELS:
                raise ValueError(f"unknown level {lvl!r}")
            overrides[name.strip()] = _LEVELS[lvl.lower()]
        else:
            if part.lower() not in _LEVELS:
                raise ValueError(f"unknown level {part!r}")
            default = _LEVELS[part.lower()]
    with _spec_lock:
        logging.getLogger(ROOT).setLevel(default)
        # loggers overridden by an earlier spec inherit again
        for name, logger in list(logging.Logger.manager.loggerDict.items()):
            if isinstance(logger, logging.Logger) and \
                    name.startswith(ROOT + "."):
                logger.setLevel(logging.NOTSET)
        for name, lvl in overrides.items():
            logging.getLogger(f"{ROOT}.{name}").setLevel(lvl)
        _current_spec = spec


def current_spec() -> str:
    with _spec_lock:
        return _current_spec
