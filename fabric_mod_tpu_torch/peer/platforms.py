"""Chaincode language platforms registry.

The port's copy of fabric_mod_tpu/peer/platforms.py (`PythonPlatform`
:39, `CCaaSPlatform` :63, `ScriptPlatform` :84, `LaunchContext`,
`PlatformRegistry`; reference: core/chaincode/platforms/platforms.go:62
Registry — one Platform per language, selected by the package's type,
each owning validation and build for its language — with :198 the
build dispatch `PlatformRegistry.build_for` mirrors).

Platforms: "python" execs the package's module in-process and takes its
`contract` (or wraps a callable `invoke`); "ccaas" dials the
connection.json's running server; "script" / "binary" launch the
payload as its own process (`sys.executable` for a payload without a
shebang), which serves the chaincode protocol and publishes its
newline-terminated address to the file its run metadata names.  Types
no platform claims go to the external builders (peer/extbuilder.py).

A python package names the contract classes it builds on by module.  It
runs with the port's modules in place of the JAX package's: an import
of `fabric_mod_tpu.X` in the package's code resolves to
`fabric_mod_tpu_torch.X`, so a package built against the reference
(`from fabric_mod_tpu.peer.chaincode import KvContract`) gives a
contract of the port, and the port never imports the reference.
"""
from __future__ import annotations

import builtins
import json
import os
import shutil
import stat
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from fabric_mod_tpu_torch.peer.extbuilder import ExternalBuilderError

_REFERENCE_PKG = "fabric_mod_tpu"
_PORT_PKG = "fabric_mod_tpu_torch"


def _port_name(name: str) -> str:
    """The port's module for a module name of the JAX package; any other
    name as it is."""
    if name == _REFERENCE_PKG or name.startswith(_REFERENCE_PKG + "."):
        return _PORT_PKG + name[len(_REFERENCE_PKG):]
    return name


def _package_import(name, globals=None, locals=None, fromlist=(), level=0):
    """`__import__` for a package's code: the JAX package's modules
    resolve to the port's."""
    if level == 0:
        name = _port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


class PlatformError(ExternalBuilderError):
    """Subclass of ExternalBuilderError so launcher callers keep one
    failure surface across platforms and external builders."""


class PythonPlatform:
    """In-process contracts: the code payload is a module defining
    `contract` (or a callable `invoke`) — the runtime's native unit."""

    name = "python"

    def handles(self, cc_type: str) -> bool:
        return cc_type == "python"

    def build(self, label: str, code: bytes, ctx: "LaunchContext"):
        from fabric_mod_tpu_torch.peer.chaincode import FuncContract
        ns = {"__builtins__": dict(vars(builtins),
                                   __import__=_package_import)}
        exec(compile(code, f"<chaincode {label}>", "exec"), ns)
        contract = ns.get("contract")
        if contract is None and callable(ns.get("invoke")):
            contract = FuncContract(ns["invoke"])
        if contract is None:
            raise PlatformError(
                f"package {label}: defines no `contract`")
        return contract


class CCaaSPlatform:
    """Chaincode-as-a-service: the payload is connection.json; the
    peer dials the already-running server (reference: the ccaas
    external builder shipped with the reference)."""

    name = "ccaas"

    def handles(self, cc_type: str) -> bool:
        return cc_type == "ccaas"

    def build(self, label: str, code: bytes, ctx: "LaunchContext"):
        from fabric_mod_tpu_torch.peer.extbuilder import ExternalContract
        try:
            conn = json.loads(code)
        except Exception as e:
            raise PlatformError(
                f"package {label}: bad connection.json: {e}") from e
        return ExternalContract(conn)


class ScriptPlatform:
    """Generic script language: the payload is an executable script
    (shebang or python) launched as its own OS process; it must speak
    the chaincode-server protocol and publish its listen address —
    NEWLINE-TERMINATED — to the path given in its run metadata (the
    newline marks write completion; write-to-temp-then-rename also
    works).  Same contract as an external builder's bin/run (the
    reference's per-language build+launch collapsed to one runnable
    artifact)."""

    name = "script"

    def handles(self, cc_type: str) -> bool:
        return cc_type in ("script", "binary")

    def build(self, label: str, code: bytes, ctx: "LaunchContext"):
        work = tempfile.mkdtemp(prefix=f"ccscript-{label}-")
        try:
            return self._launch(label, code, ctx, work)
        except BaseException:
            # failed build: reap the workdir (nothing dials into it);
            # on success it must persist — the script runs from it
            shutil.rmtree(work, ignore_errors=True)
            raise

    def _launch(self, label: str, code: bytes, ctx: "LaunchContext",
                work: str):
        from fabric_mod_tpu_torch.peer.extbuilder import ExternalContract
        script = os.path.join(work, "chaincode")
        with open(script, "wb") as f:
            f.write(code)
        os.chmod(script, os.stat(script).st_mode | stat.S_IXUSR)
        addr_file = os.path.join(work, "address")
        meta_path = os.path.join(work, "chaincode.json")
        with open(meta_path, "w") as f:
            json.dump({"address_file": addr_file}, f)
        if code.startswith(b"#!"):
            cmd = [script, meta_path]
        else:
            # no shebang: treat as python source (the common case on
            # this runtime; a compiled binary would carry no shebang
            # but also not parse as text — operators label those
            # "binary" and ship a shebang'd wrapper)
            cmd = [sys.executable, script, meta_path]
        proc = subprocess.Popen(cmd, cwd=work)
        ctx.track(proc)
        deadline = time.monotonic() + ctx.launch_timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(addr_file):
                # The publish contract REQUIRES a newline-terminated
                # address: existence of the file is not completion of
                # the write (a non-atomic writer can be caught
                # mid-write and we would dial a truncated address).
                # Retry until the trailing newline lands.  NOTE this
                # binds atomic-rename writers too — their content must
                # also end with "\n" (the newline is the completion
                # marker, rename or not).
                raw = open(addr_file).read()
                if raw.endswith("\n") and raw.strip():
                    return ExternalContract({"address": raw.strip()})
            if proc.poll() is not None:
                raise PlatformError(
                    f"package {label}: script exited rc="
                    f"{proc.returncode} before publishing an address")
            time.sleep(0.05)
        proc.kill()
        proc.wait(timeout=5)
        raise PlatformError(
            f"package {label}: script never published an address "
            f"(the address file must be newline-terminated)")


class LaunchContext:
    """What a platform may ask of the launcher: process tracking (so
    close() reaps) and the launch timeout."""

    def __init__(self, track, launch_timeout_s: float = 30.0):
        self.track = track
        self.launch_timeout_s = launch_timeout_s


class PlatformRegistry:
    """(reference: platforms.go:62 NewRegistry + :198 the per-type
    dispatch).  Ordered; first platform claiming the type wins; None
    when no platform claims it (caller falls back to the external
    builders)."""

    def __init__(self, platforms: Optional[List] = None):
        self._platforms = (list(platforms) if platforms is not None
                           else [PythonPlatform(), CCaaSPlatform(),
                                 ScriptPlatform()])

    def register(self, platform) -> None:
        self._platforms.append(platform)

    def platform_for(self, cc_type: str):
        for p in self._platforms:
            if p.handles(cc_type):
                return p
        return None

    def build_for(self, label: str, cc_type: str, code: bytes,
                  ctx: LaunchContext):
        """Build via the claiming platform, or None if unclaimed."""
        p = self.platform_for(cc_type)
        if p is None:
            return None
        return p.build(label, code, ctx)
