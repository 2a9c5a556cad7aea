"""External chaincode builders and chaincode-as-a-service.

The port's copy of fabric_mod_tpu/peer/extbuilder.py (`ChaincodeServer`
:178, `ExternalContract` :250, `ExternalBuilderRegistry` :402,
`ChaincodeLauncher` :425; reference: core/container/externalbuilder.go:428
— operator-supplied builder directories whose bin/detect, bin/build,
bin/release and bin/run run as subprocesses — and the
chaincode-as-a-service pattern, where the package's payload is a
connection.json naming an ALREADY-RUNNING chaincode server the peer
dials as a client).

Out-of-process chaincode speaks a line-JSON protocol over TCP in place
of the reference's gRPC shim stream, with the same callback shape: the
peer sends `invoke`; the chaincode answers with state requests
(get/put/del/range/query and set_state_metadata, public and private)
that the peer runs against the live simulator through the port's
ChaincodeStub, each answered by a `state_response`; `complete` or
`error` ends the exchange.  Bytes travel base64, every object is one
line of JSON with sorted keys: the wire is the reference's, so either
package's server answers the other's ExternalContract.

* `ChaincodeServer` — the service side: any Contract served from its
  own process (`start()` serves on a thread until `stop()`).
* `ExternalContract` — the peer-side Contract over a connection.json
  address.  A server that is down, or an exchange cut short, raises
  ChaincodeError("external chaincode unreachable: ...") and drops the
  connection; nothing runs the contract in-process instead.
* `ExternalBuilderRegistry` + `ChaincodeLauncher` — the builders
  (detect, build, release, run as subprocesses) and the resolver that
  turns an installed package into a live Contract on first use, through
  the language platforms (peer/platforms.py) and then the builders;
  plug it in with `ChaincodeRegistry.set_resolver(launcher.resolve)`.
"""
from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredLock, RegisteredThread
from fabric_mod_tpu_torch.peer.chaincode import ChaincodeError, ChaincodeStub


class ExternalBuilderError(Exception):
    pass


# ---------------------------------------------------------------------------
# Wire protocol: newline-delimited JSON, bytes base64-encoded
# ---------------------------------------------------------------------------

def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _send(sock_file, obj: Dict) -> None:
    sock_file.write(json.dumps(obj, sort_keys=True) + "\n")
    sock_file.flush()


def _recv(sock_file) -> Dict:
    line = sock_file.readline()
    if not line:
        # transport-level: the exchange is dead, not a contract error
        raise ConnectionError("chaincode connection closed")
    return json.loads(line)


# the state callbacks the protocol proxies (name -> stub driver)
def _dispatch_state_op(stub: ChaincodeStub, msg: Dict) -> Dict:
    op = msg.get("op")
    if op == "get_state":
        v = stub.get_state(msg["key"])
        return {"value": _b64(v) if v is not None else None}
    if op == "put_state":
        stub.put_state(msg["key"], _unb64(msg["value"]))
        return {}
    if op == "del_state":
        stub.del_state(msg["key"])
        return {}
    if op == "get_state_range":
        out = [[k, _b64(v)] for k, v in
               stub.get_state_range(msg["start"], msg["end"])]
        return {"results": out}
    if op == "get_query_result":
        results, bookmark = stub.get_query_result(msg["query"])
        return {"results": [[k, d] for k, d in results],
                "bookmark": bookmark}
    if op == "set_state_metadata":
        stub.set_state_metadata(msg["key"], msg["name"],
                                _unb64(msg["value"]))
        return {}
    if op == "put_private_data":
        stub.put_private_data(msg["collection"], msg["key"],
                              _unb64(msg["value"]))
        return {}
    if op == "get_private_data":
        v = stub.get_private_data(msg["collection"], msg["key"])
        return {"value": _b64(v) if v is not None else None}
    if op == "del_private_data":
        stub.del_private_data(msg["collection"], msg["key"])
        return {}
    raise ChaincodeError(f"unknown state op {op!r}")


# ---------------------------------------------------------------------------
# Service side (runs in the chaincode's own process)
# ---------------------------------------------------------------------------

class _ProxyStub:
    """Looks like a ChaincodeStub to the remote contract; every state
    call travels back to the peer over the live exchange."""

    def __init__(self, sock_file, args: List[bytes],
                 transient: Dict[str, bytes], txid: str,
                 namespace: str = "", channel_id: str = ""):
        self._f = sock_file
        self.args = args
        self.transient = transient
        self.txid = txid
        # same public surface as ChaincodeStub: contracts read these
        self.namespace = namespace
        self.channel_id = channel_id

    def _call(self, **msg) -> Dict:
        _send(self._f, {"type": "state", **msg})
        resp = _recv(self._f)
        if resp.get("type") != "state_response":
            raise ChaincodeError("protocol violation from peer")
        if "error" in resp:
            raise ChaincodeError(resp["error"])
        return resp

    def get_state(self, key: str) -> Optional[bytes]:
        v = self._call(op="get_state", key=key).get("value")
        return _unb64(v) if v is not None else None

    def put_state(self, key: str, value: bytes) -> None:
        self._call(op="put_state", key=key, value=_b64(value))

    def del_state(self, key: str) -> None:
        self._call(op="del_state", key=key)

    def get_state_range(self, start: str, end: str):
        out = self._call(op="get_state_range", start=start, end=end)
        return iter([(k, _unb64(v)) for k, v in out["results"]])

    def get_query_result(self, query):
        if isinstance(query, bytes):
            query = query.decode()
        out = self._call(op="get_query_result", query=query)
        return [(k, d) for k, d in out["results"]], out["bookmark"]

    def set_state_metadata(self, key: str, name: str,
                           value: bytes) -> None:
        self._call(op="set_state_metadata", key=key, name=name,
                   value=_b64(value))

    def put_private_data(self, collection: str, key: str,
                         value: bytes) -> None:
        self._call(op="put_private_data", collection=collection,
                   key=key, value=_b64(value))

    def get_private_data(self, collection: str,
                         key: str) -> Optional[bytes]:
        v = self._call(op="get_private_data", collection=collection,
                       key=key).get("value")
        return _unb64(v) if v is not None else None

    def del_private_data(self, collection: str, key: str) -> None:
        self._call(op="del_private_data", collection=collection,
                   key=key)


class ChaincodeServer:
    """Serves one Contract out-of-process (the CCaaS server —
    reference: the peer.connects-to-chaincode mode of external
    builders; here the protocol server the ExternalContract dials)."""

    def __init__(self, contract, host: str = "127.0.0.1",
                 port: int = 0):
        self._contract = contract
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                f = _SockFile(self.rfile, self.wfile)
                while True:
                    try:
                        msg = _recv(f)
                    except Exception:
                        return
                    if msg.get("type") != "invoke":
                        return
                    stub = _ProxyStub(
                        f,
                        [_unb64(a) for a in msg["args"]],
                        {k: _unb64(v)
                         for k, v in msg.get("transient", {}).items()},
                        msg.get("txid", ""),
                        namespace=msg.get("namespace", ""),
                        channel_id=msg.get("channel_id", ""))
                    try:
                        payload = outer._contract.invoke(stub)
                        _send(f, {"type": "complete",
                                  "payload": _b64(payload or b"")})
                    except Exception as e:
                        _send(f, {"type": "error", "message": str(e)})

        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.address = "%s:%d" % self._srv.server_address
        self._thread = RegisteredThread(target=self._srv.serve_forever,
                                        name="chaincode-server",
                                        structure="peer.extbuilder")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, join the serving thread and close the listener
        (idempotent).  Connections already open end with their peer."""
        if self._thread.is_alive():
            self._srv.shutdown()
            self._thread.join()
        self._srv.server_close()


class _SockFile:
    """read/write adapter shared by both protocol ends."""

    def __init__(self, rfile, wfile):
        self._r = rfile
        self._w = wfile

    def readline(self) -> str:
        line = self._r.readline()
        return line.decode() if isinstance(line, bytes) else line

    def write(self, s) -> None:
        self._w.write(s.encode() if isinstance(s, str) else s)

    def flush(self) -> None:
        self._w.flush()


# ---------------------------------------------------------------------------
# Peer side
# ---------------------------------------------------------------------------

class ExternalContract:
    """Contract adapter: forwards invoke() to a chaincode server named
    by connection.json (reference: the ccaas connection.json contract
    — {"address": "host:port"}).  One connection, invokes serialized
    (the endorser already serializes per-proposal)."""

    def __init__(self, connection: Dict, timeout_s: float = 30.0):
        address = connection.get("address", "")
        host, _, port = address.partition(":")
        if not host or not port:
            raise ExternalBuilderError(
                f"connection.json address invalid: {address!r}")
        self._addr = (host, int(port))
        self._timeout = timeout_s
        # re-entrant: the invoke error path closes the connection while
        # holding it
        self._lock = RegisteredLock("peer.extbuilder.ExternalContract._lock")
        self._sock: Optional[socket.socket] = None
        self._file: Optional[_SockFile] = None

    def _connect(self) -> _SockFile:
        if self._file is None:
            s = socket.create_connection(self._addr,
                                         timeout=self._timeout)
            self._sock = s
            rf = s.makefile("rb")
            wf = s.makefile("wb")
            self._file = _SockFile(rf, wf)
        return self._file

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None
                    self._file = None

    def invoke(self, stub: ChaincodeStub) -> bytes:
        with self._lock:
            try:
                return self._invoke_locked(stub)
            except ChaincodeError:
                # the contract reported an error over a COMPLETED
                # exchange: the connection stays usable
                raise
            except Exception as e:
                # transport-level (EOF, refused, protocol violation):
                # the socket may be dead or desynchronized mid-exchange
                # — never reuse it for the next transaction
                self.close()
                raise ChaincodeError(
                    f"external chaincode unreachable: {e}") from e

    def _invoke_locked(self, stub: ChaincodeStub) -> bytes:
        f = self._connect()
        _send(f, {"type": "invoke", "txid": stub.txid,
                  "namespace": getattr(stub, "namespace", ""),
                  "channel_id": getattr(stub, "channel_id", ""),
                  "args": [_b64(a) for a in stub.args],
                  "transient": {k: _b64(v)
                                for k, v in stub.transient.items()}})
        while True:
            msg = _recv(f)
            kind = msg.get("type")
            if kind == "state":
                try:
                    out = _dispatch_state_op(stub, msg)
                    _send(f, {"type": "state_response", **out})
                except Exception as e:
                    _send(f, {"type": "state_response",
                              "error": str(e)})
            elif kind == "complete":
                return _unb64(msg.get("payload", ""))
            elif kind == "error":
                raise ChaincodeError(msg.get("message", "chaincode error"))
            else:
                raise ConnectionError(f"protocol violation: {kind!r}")


# ---------------------------------------------------------------------------
# Script-contract builders (reference: externalbuilder.go detect/
# build/release/run)
# ---------------------------------------------------------------------------

class ExternalBuilder:
    """One builder directory with bin/{detect,build,release,run}.

    detect(BUILD_OUTPUT_DIR=metadata dir) exit 0 claims the package;
    build(SOURCE, METADATA, OUTPUT) materializes runnable output;
    release(OUTPUT, RELEASE) exports artifacts; run(OUTPUT, RUN_META)
    launches the chaincode (long-running subprocess)."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path.rstrip("/"))

    def _script(self, name: str) -> Optional[str]:
        p = os.path.join(self.path, "bin", name)
        return p if os.access(p, os.X_OK) else None

    def _run(self, name: str, args: List[str],
             timeout_s: float = 60.0) -> Tuple[int, bytes]:
        """-> (returncode, stderr).  A hung script counts as failure
        (rc 1), never an escaping TimeoutExpired."""
        script = self._script(name)
        if script is None:
            # detect and build are MANDATORY in the reference's
            # contract; only release (and run, handled separately) are
            # optional — a missing build must not silently "succeed"
            if name == "detect":
                return 1, b""
            if name == "build":
                raise ExternalBuilderError(
                    f"builder {self.name} has no bin/build")
            return 0, b""
        try:
            proc = subprocess.run([script] + args, timeout=timeout_s,
                                  capture_output=True)
        except subprocess.TimeoutExpired:
            return 1, b"timed out after %ds" % int(timeout_s)
        return proc.returncode, proc.stderr or b""

    def detect(self, metadata_dir: str) -> bool:
        return self._run("detect", [metadata_dir])[0] == 0

    def build(self, source_dir: str, metadata_dir: str,
              output_dir: str) -> None:
        rc, stderr = self._run("build", [source_dir, metadata_dir,
                                         output_dir])
        if rc != 0:
            raise ExternalBuilderError(
                f"builder {self.name}: build failed: "
                f"{stderr[-500:].decode(errors='replace')}")

    def release(self, output_dir: str, release_dir: str) -> None:
        rc, stderr = self._run("release", [output_dir, release_dir])
        if rc != 0:
            raise ExternalBuilderError(
                f"builder {self.name}: release failed: "
                f"{stderr[-500:].decode(errors='replace')}")

    def run(self, output_dir: str, run_meta_dir: str
            ) -> subprocess.Popen:
        script = self._script("run")
        if script is None:
            raise ExternalBuilderError(f"builder {self.name} has no "
                                       "bin/run")
        return subprocess.Popen([script, output_dir, run_meta_dir])


class ExternalBuilderRegistry:
    """Ordered builder list scanned from a root dir (reference: the
    externalBuilders core.yaml section; first detect() wins)."""

    def __init__(self, root: Optional[str] = None):
        self.builders: List[ExternalBuilder] = []
        if root and os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                p = os.path.join(root, name)
                if os.path.isdir(p):
                    self.builders.append(ExternalBuilder(p))

    def detect(self, metadata_dir: str) -> Optional[ExternalBuilder]:
        for b in self.builders:
            if b.detect(metadata_dir):
                return b
        return None


# ---------------------------------------------------------------------------
# The launcher: installed package -> live Contract
# ---------------------------------------------------------------------------

class ChaincodeLauncher:
    """Resolves a namespace to a Contract from the installed packages
    on first use (reference: chaincode_support.go:93 Launch).  Wire it
    as the ChaincodeRegistry's resolver.

    Package types route through the language platforms registry
    (peer/platforms.py — python in-proc, ccaas dial-out, script
    launch; reference: core/chaincode/platforms/platforms.go:62);
    types no platform claims are offered to the external builders.
    """

    def __init__(self, package_store, builders=None, platforms=None):
        from fabric_mod_tpu_torch.peer.platforms import (LaunchContext,
                                                         PlatformRegistry)
        self._store = package_store
        self._builders = builders or ExternalBuilderRegistry()
        self._platforms = platforms or PlatformRegistry()
        self._live: Dict[str, object] = {}
        self._procs: List[subprocess.Popen] = []
        self._lock = RegisteredLock("peer.extbuilder.ChaincodeLauncher._lock")
        self._launch_ctx = LaunchContext(self._procs.append)

    def resolve(self, name: str):
        with self._lock:
            if name in self._live:
                return self._live[name]
            contract = self._build(name)
            if contract is not None:
                self._live[name] = contract
            return contract

    def _find_package(self, name: str) -> Optional[Tuple[str, str, bytes]]:
        from fabric_mod_tpu_torch.peer.ccpackage import parse_package
        matches = sorted(pid for pid in self._store.list()
                         if pid.partition(":")[0] == name)
        if not matches:
            return None
        if len(matches) > 1:
            # two installs sharing a label must not resolve by listdir
            # luck — peers would run different code for the same name
            raise ExternalBuilderError(
                f"ambiguous chaincode {name!r}: {len(matches)} "
                f"installed packages share the label ({matches}); "
                "remove the stale install")
        raw = self._store.load(matches[0])
        return parse_package(raw)

    def _build(self, name: str):
        got = self._find_package(name)
        if got is None:
            return None
        label, cc_type, code = got
        # language platforms first (platforms.go:198 dispatch), then
        # the external-builder fallback for unclaimed types
        contract = self._platforms.build_for(label, cc_type, code,
                                             self._launch_ctx)
        if contract is not None:
            return contract
        return self._build_external(label, cc_type, code)

    def _build_external(self, label: str, cc_type: str, code: bytes):
        """Offer an unknown package type to the external builders:
        detect -> build -> release; the artifacts must yield a
        connection.json (directly, via release, or written by a
        launched bin/run — which receives the address file path in
        its run metadata)."""
        import shutil
        import tempfile
        import time as _time
        work = tempfile.mkdtemp(prefix=f"ccbuild-{label}-")
        src, meta, out, rel, run_meta = (
            os.path.join(work, d)
            for d in ("src", "meta", "out", "rel", "run"))
        keep_work = False
        try:
            for d in (src, meta, out, rel, run_meta):
                os.makedirs(d)
            with open(os.path.join(src, "code.bin"), "wb") as f:
                f.write(code)
            with open(os.path.join(meta, "metadata.json"), "w") as f:
                json.dump({"label": label, "type": cc_type}, f)
            builder = self._builders.detect(meta)
            if builder is None:
                raise ExternalBuilderError(
                    f"package {label}: no builder claims type "
                    f"{cc_type!r}")
            builder.build(src, meta, out)
            builder.release(out, rel)
            for d in (rel, out):
                conn_path = os.path.join(d, "connection.json")
                if os.path.exists(conn_path):
                    return ExternalContract(json.load(open(conn_path)))
            # no connection artifact: launch bin/run, which must write
            # its listen address to the advertised file
            addr_file = os.path.join(run_meta, "address")
            with open(os.path.join(run_meta, "chaincode.json"),
                      "w") as f:
                json.dump({"address_file": addr_file}, f)
            proc = builder.run(out, run_meta)
            self._procs.append(proc)
            deadline = _time.monotonic() + 30.0
            while _time.monotonic() < deadline:
                if os.path.exists(addr_file):
                    addr = open(addr_file).read().strip()
                    if addr:
                        # success: the run output stays alive with the
                        # process; failure paths below clean up
                        keep_work = True
                        return ExternalContract({"address": addr})
                if proc.poll() is not None:
                    raise ExternalBuilderError(
                        f"builder {builder.name}: run exited rc="
                        f"{proc.returncode} before publishing an "
                        "address")
                _time.sleep(0.05)
            proc.kill()
            proc.wait(timeout=5)           # no zombies
            raise ExternalBuilderError(
                f"builder {builder.name}: run never published an "
                "address")
        finally:
            if not keep_work:
                shutil.rmtree(work, ignore_errors=True)

    def close(self) -> None:
        """Stop (and reap) launched chaincode processes."""
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass                       # reaped by the OS later
        self._procs.clear()
