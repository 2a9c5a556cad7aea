"""Chaincode packages: build, parse, store.

The port's copy of fabric_mod_tpu/peer/ccpackage.py (reference:
core/chaincode/persistence — chaincode_package.go's tar.gz of
metadata.json and the code, and persistence.go's package store keyed
by package id = label:sha256).

A package is a gzip'd tar of two members, `metadata.json` ({"label",
"type"}, sorted keys) and `code.bin` (a Python contract's source, a
ccaas connection.json, a script or an external builder's input), each
with mtime 0.  The bytes, and so the ids, are the reference's for the
same label, type and code built in the same second: the gzip header
carries the build time, in both packages.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tarfile
from typing import List, Optional, Tuple


class PackageError(Exception):
    pass


def build_package(label: str, code: bytes,
                  cc_type: str = "python") -> bytes:
    """-> tar.gz bytes with metadata.json + code payload
    (reference: chaincode_package.go's two-member archive)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        meta = json.dumps({"label": label, "type": cc_type},
                          sort_keys=True).encode()

        def add(name: str, data: bytes) -> None:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = 0                 # deterministic package id
            tar.addfile(info, io.BytesIO(data))
        add("metadata.json", meta)
        add("code.bin", code)
    return buf.getvalue()


def parse_package(raw: bytes) -> Tuple[str, str, bytes]:
    """-> (label, type, code) with the reference's validation rules
    (label required, exactly the two members)."""
    try:
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
            names = sorted(tar.getnames())
            if names != ["code.bin", "metadata.json"]:
                raise PackageError(
                    "package must contain exactly metadata.json "
                    f"+ code.bin, got {names}")
            meta = json.loads(
                tar.extractfile("metadata.json").read())
            code = tar.extractfile("code.bin").read()
    except PackageError:
        raise
    except Exception as e:
        raise PackageError(f"bad package: {e}") from e
    label = meta.get("label", "")
    if not _label_ok(label):
        raise PackageError(f"invalid label {label!r}")
    return label, meta.get("type", ""), code


_LABEL_RE = re.compile(r"^[a-zA-Z0-9]+([.+\-_][a-zA-Z0-9]+)*$")


def _label_ok(label: str) -> bool:
    """One label rule shared by parse and the store's id guard — the
    reference's regex: alnum runs joined by single . + - _ separators
    (no edge or consecutive separators)."""
    return bool(_LABEL_RE.fullmatch(label))


def package_id(label: str, raw: bytes) -> str:
    """label:sha256 (reference: persistence.go PackageID)."""
    return f"{label}:{hashlib.sha256(raw).hexdigest()}"


class PackageStore:
    """Installed-package store (reference: persistence.go Store)."""

    def __init__(self, dir_path: str):
        self._dir = dir_path
        os.makedirs(dir_path, exist_ok=True)

    @staticmethod
    def _validate_id(pkg_id: str) -> None:
        """Caller-supplied ids hit the filesystem: enforce the
        label:hexdigest shape (path-traversal guard)."""
        label, sep, digest = pkg_id.partition(":")
        if (not sep or len(digest) != 64
                or not all(c in "0123456789abcdef" for c in digest)
                or not _label_ok(label)):
            raise PackageError(f"invalid package id {pkg_id!r}")

    def _path(self, pkg_id: str) -> str:
        self._validate_id(pkg_id)
        return os.path.join(self._dir,
                            pkg_id.replace(":", ".") + ".tar.gz")

    def save(self, raw: bytes) -> str:
        label, _t, _code = parse_package(raw)
        pid = package_id(label, raw)
        path = self._path(pid)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return pid

    def load(self, pkg_id: str) -> Optional[bytes]:
        path = self._path(pkg_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def list(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self._dir)):
            if name.endswith(".tar.gz"):
                base = name[:-len(".tar.gz")]
                label, _, digest = base.rpartition(".")
                out.append(f"{label}:{digest}")
        return out
