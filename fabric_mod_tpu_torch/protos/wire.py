"""Deterministic protobuf-wire-format message layer.

The L0 of the framework (reference: protoutil/ and the external
fabric-protos-go module): every envelope, block, proposal, and rwset
is a `Msg` dataclass with numbered fields, serialized in the protobuf
wire format (varint / length-delimited).  Hand-rolled rather than
protoc-generated for two reasons that matter here:

* **Determinism is a consensus requirement** — commit results must be
  bit-identical across peers (SURVEY.md §7 hard part #7).  This
  encoder always writes fields in ascending field-number order and
  repeated fields in list order, so `encode(decode(x)) == x` holds
  and hashes over encodings are stable.
* The host marshal path feeds device batches; owning the encoder lets
  later rounds move hot unmarshal loops into the C++ host bridge
  without fighting a generated API.

Field kinds: "u" varint uint64, "i" zigzag-free int32/enum (encoded as
varint, two's-complement 64-bit for negatives like protobuf), "b"
bytes, "s" str, ("m", cls) submessage, and list-wrapped variants for
repeated fields.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Iterable, Type


def write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_tag(out: bytearray, num: int, wt: int) -> None:
    write_varint(out, (num << 3) | wt)


def _write_len_delim(out: bytearray, num: int, data: bytes) -> None:
    _write_tag(out, num, 2)
    write_varint(out, len(data))
    out.extend(data)


class Msg:
    """Base for wire messages.  Subclasses are dataclasses that set
    FIELDS = ((num, attr, kind), ...) with num ascending."""

    FIELDS: ClassVar[tuple] = ()

    def encode(self) -> bytes:
        out = bytearray()
        for num, attr, kind in self.FIELDS:
            val = getattr(self, attr)
            rep = isinstance(kind, list)
            k = kind[0] if rep else kind
            items: Iterable[Any] = val if rep else (
                () if _is_default(val, k) else (val,))
            for item in items:
                if k == "u" or k == "i":
                    _write_tag(out, num, 0)
                    write_varint(out, int(item))
                elif k == "b":
                    _write_len_delim(out, num, bytes(item))
                elif k == "s":
                    _write_len_delim(out, num, item.encode())
                elif isinstance(k, tuple) and k[0] == "m":
                    _write_len_delim(out, num, item.encode())
                else:
                    raise TypeError(f"bad field kind {k!r}")
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Msg":
        by_num = {num: (attr, kind) for num, attr, kind in cls.FIELDS}
        kwargs: dict[str, Any] = {}
        pos = 0
        while pos < len(buf):
            tag, pos = read_varint(buf, pos)
            num, wt = tag >> 3, tag & 7
            if wt == 0:
                val, pos = read_varint(buf, pos)
                payload: Any = val
            elif wt == 2:
                ln, pos = read_varint(buf, pos)
                if pos + ln > len(buf):
                    raise ValueError("truncated length-delimited field")
                payload = buf[pos:pos + ln]
                pos += ln
            elif wt == 5:
                if pos + 4 > len(buf):
                    raise ValueError("truncated fixed32 field")
                payload = buf[pos:pos + 4]
                pos += 4
            elif wt == 1:
                if pos + 8 > len(buf):
                    raise ValueError("truncated fixed64 field")
                payload = buf[pos:pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if num not in by_num:
                continue                      # unknown fields tolerated
            attr, kind = by_num[num]
            rep = isinstance(kind, list)
            k = kind[0] if rep else kind
            # Wire type must match the declared kind: a varint arriving on
            # a bytes field (or vice versa) is a malformed message, not a
            # value to coerce — this runs on untrusted envelope bytes.
            expect_wt = 0 if k in ("u", "i") else 2
            if wt != expect_wt:
                raise ValueError(
                    f"field {num}: wire type {wt}, expected {expect_wt}")
            if k == "u" or k == "i":
                item: Any = int(payload)
                if k == "i" and item >= 1 << 63:
                    item -= 1 << 64
            elif k == "b":
                item = bytes(payload)
            elif k == "s":
                item = bytes(payload).decode()
            elif isinstance(k, tuple) and k[0] == "m":
                item = _resolve(k[1]).decode(bytes(payload))
            else:
                raise TypeError(f"bad field kind {k!r}")
            if rep:
                kwargs.setdefault(attr, []).append(item)
            else:
                kwargs[attr] = item
        return cls(**kwargs)


def _is_default(val: Any, k: Any) -> bool:
    if val is None:
        return True
    if k in ("u", "i"):
        return val == 0
    if k == "b":
        return len(val) == 0
    if k == "s":
        return val == ""
    return False


_REGISTRY: dict[str, Type[Msg]] = {}


def _resolve(name_or_cls) -> Type[Msg]:
    if isinstance(name_or_cls, str):
        return _REGISTRY[name_or_cls]
    return name_or_cls


def message(cls):
    """Decorator: dataclass + registry entry for by-name submessages."""
    cls = dataclasses.dataclass(cls)
    _REGISTRY[cls.__name__] = cls
    return cls
