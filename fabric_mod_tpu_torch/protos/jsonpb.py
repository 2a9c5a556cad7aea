"""Generic Msg <-> JSON translation (the configtxlator surface).

The port's copy of fabric_mod_tpu/protos/jsonpb.py (reference:
internal/configtxlator — protolator's proto<->JSON round trip behind
`configtxlator proto_encode/proto_decode`).  The wire layer's FIELDS
metadata (protos/wire.py) plays protolator's reflection role.

Bytes fields are base64 strings, sub-messages nested objects and
repeated fields arrays.  Fields at their default are left out of the
JSON and defaulted when it is read back, so the round trip is stable.
A key that names no field of its message, or a type name that names no
message, raises JsonPbError.
"""
from __future__ import annotations

import base64
from typing import Any, Dict, Type

from fabric_mod_tpu_torch.protos import messages as _messages  # noqa: F401
from fabric_mod_tpu_torch.protos.wire import _REGISTRY, Msg


class JsonPbError(Exception):
    pass


def _cls(name: str) -> Type[Msg]:
    if name not in _REGISTRY:
        raise JsonPbError(f"unknown message type {name!r}")
    return _REGISTRY[name]


def to_json(msg: Msg) -> Dict[str, Any]:
    """Msg -> a plain JSON-serializable dict."""
    out: Dict[str, Any] = {}
    for _num, attr, kind in msg.FIELDS:
        val = getattr(msg, attr)
        if isinstance(kind, list):
            if not val:
                continue
            inner = kind[0]
            if isinstance(inner, tuple):
                out[attr] = [to_json(v) for v in val]
            elif inner == "b":
                out[attr] = [base64.b64encode(v).decode() for v in val]
            else:
                out[attr] = list(val)
        elif isinstance(kind, tuple):
            if val is not None:
                out[attr] = to_json(val)
        elif val:                          # "b", "s", "u", "i"
            out[attr] = (base64.b64encode(val).decode() if kind == "b"
                         else val)
    return out


def from_json(cls_or_name, data: Dict[str, Any]) -> Msg:
    """JSON dict -> a Msg of `cls_or_name` (a class or a type name)."""
    cls = _cls(cls_or_name) if isinstance(cls_or_name, str) else cls_or_name
    known = {attr for _n, attr, _k in cls.FIELDS}
    for key in data:
        if key not in known:
            raise JsonPbError(f"{cls.__name__} has no field {key!r}")
    kwargs: Dict[str, Any] = {}
    for _num, attr, kind in cls.FIELDS:
        if attr not in data:
            continue
        val = data[attr]
        if isinstance(kind, list):
            inner = kind[0]
            if isinstance(inner, tuple):
                kwargs[attr] = [from_json(_cls(inner[1]), v) for v in val]
            elif inner == "b":
                kwargs[attr] = [base64.b64decode(v) for v in val]
            else:
                kwargs[attr] = list(val)
        elif isinstance(kind, tuple):
            kwargs[attr] = from_json(_cls(kind[1]), val)
        elif kind == "b":
            kwargs[attr] = base64.b64decode(val)
        else:
            kwargs[attr] = val
    return cls(**kwargs)


def proto_decode(type_name: str, raw: bytes) -> Dict[str, Any]:
    """Wire bytes -> JSON (configtxlator proto_decode)."""
    return to_json(_cls(type_name).decode(raw))


def proto_encode(type_name: str, data: Dict[str, Any]) -> bytes:
    """JSON -> wire bytes (configtxlator proto_encode)."""
    return from_json(type_name, data).encode()
