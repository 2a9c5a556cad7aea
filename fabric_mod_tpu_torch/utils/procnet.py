"""A process network of the port: Raft orderers and committing peers,
each `python -m fabric_mod_tpu_torch.cli.main node` in an OS process of
its own (the reference's integration/nwo network builder, as its
tests/test_procnet.py drives it).

`ProcNet(root, ...)` writes the material with the port's own tools —
cryptogen and configtxgen through `cli.main`, TLS directories from
comm/tls.TlsCA (each orderer a server and a client certificate, for the
Raft cluster's mutual TLS; the peers one server certificate), and a
core.yaml for each node with its operations address and
`peer.BCCSP.Default` — and the node command lines; `start_all()` spawns
them from the repository's root, each child's output to
`<root>/<name>.log`.  A child is asked to die with its parent (Linux's
parent-death signal), and `teardown()` sends SIGTERM to each and SIGKILL
to any that lingers.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from typing import Callable, Dict, List, Sequence, Tuple

from fabric_mod_tpu_torch.cli.main import main as cli
from fabric_mod_tpu_torch.comm.tls import TlsCA

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def http_json(url: str, timeout: float = 2.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def metric_value(url: str, name: str, timeout: float = 2.0):
    """The largest sample of metric `name` on a /metrics page, or None."""
    with urllib.request.urlopen(url, timeout=timeout) as r:
        text = r.read().decode()
    vals = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(name) and not line.startswith("#")
            and line[len(name):len(name) + 1] in (" ", "{")]
    return max(vals) if vals else None


def wait(pred: Callable[[], bool], t: float = 60.0, dt: float = 0.1) -> bool:
    """Poll `pred` until it is true (an exception counts as false) or `t`
    seconds pass."""
    deadline = time.time() + t
    while time.time() < deadline:
        try:
            if pred():
                return True
        except Exception:
            pass
        time.sleep(dt)
    return False


try:                                       # resolved here, not in the child
    import ctypes
    _PRCTL = ctypes.CDLL(None, use_errno=True).prctl
except (OSError, AttributeError):
    _PRCTL = None
_PR_SET_PDEATHSIG = 1


def _die_with_parent() -> None:
    """In the child, between fork and exec: SIGTERM when the thread that
    spawned it ends (spawn from a thread that outlives the network)."""
    if _PRCTL is not None:
        _PRCTL(_PR_SET_PDEATHSIG, signal.SIGTERM)


class ProcNet:
    """Artifacts, ports and node command lines of one network: `orderers`
    Raft orderers of OrdererOrg (ids o0, o1, ...) and one peer per entry
    of `peers` ((name, org), each org a peer org of the crypto).  The
    peers verify on the card (`bccsp="GPU"`, as PeerConfig's default)
    unless the caller asks for the host with `bccsp="SW"`."""

    def __init__(self, root: str, channel: str = "procchan",
                 peer_orgs: Sequence[str] = ("Org1", "Org2"),
                 peers: Sequence[Tuple[str, str]] = (("p0", "Org1"),
                                                     ("p1", "Org2")),
                 orderers: int = 3, bccsp: str = "GPU",
                 batch_txs: int = 5, batch_timeout: str = "250ms",
                 tls_seed: bytes = b"procnet"):
        self.root = str(root)
        self.channel = channel
        self.bccsp = bccsp
        self.o_ids = [f"o{i}" for i in range(orderers)]
        self.peers = list(peers)
        self.procs: Dict[str, subprocess.Popen] = {}
        self.logs: Dict[str, object] = {}
        self.tls = TlsCA(seed=tls_seed)
        ports = iter(free_ports(3 * orderers + 2 * len(self.peers)))
        self.bports = {o: next(ports) for o in self.o_ids}
        self.cports = {o: next(ports) for o in self.o_ids}
        self.oops = {o: next(ports) for o in self.o_ids}
        self.pops = {p: next(ports) for p, _ in self.peers}
        self.eports = {p: next(ports) for p, _ in self.peers}
        self._artifacts(list(peer_orgs), batch_txs, batch_timeout)

    def _write(self, rel: str, data) -> str:
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb" if isinstance(data, bytes) else "w") as f:
            f.write(data)
        return path

    def _artifacts(self, orgs, batch_txs, batch_timeout) -> None:
        crypto_yaml = self._write("crypto.yaml", (
            "PeerOrgs:\n"
            + "".join(f"  - Name: {org}\n    PeerCount: 1\n"
                      f"    UserCount: 1\n" for org in orgs)
            + "OrdererOrgs:\n  - Name: OrdererOrg\n"
            f"    OrdererCount: {len(self.o_ids)}\n"))
        self.crypto_dir = os.path.join(self.root, "crypto")
        if cli(["cryptogen", "--config", crypto_yaml,
                "--output", self.crypto_dir]) != 0:
            raise RuntimeError("cryptogen failed")
        profile = self._write("configtx.yaml", (
            f"ChannelID: {self.channel}\n"
            f"PeerOrgs: [{', '.join(orgs)}]\n"
            "OrdererOrgs: [OrdererOrg]\n"
            "ConsensusType: etcdraft\n"
            f"Consenters: [{', '.join(self.o_ids)}]\n"
            f"BatchTimeout: {batch_timeout}\n"
            f"BatchSize:\n  MaxMessageCount: {batch_txs}\n"))
        self.genesis = os.path.join(self.root, "genesis.block")
        if cli(["configtxgen", "--profile", profile, "--crypto",
                self.crypto_dir, "--output", self.genesis]) != 0:
            raise RuntimeError("configtxgen failed")
        for oid in self.o_ids:
            scert, skey = self.tls.issue(
                f"{oid}.example.com",
                sans=(f"{oid}.example.com", "localhost", "127.0.0.1"))
            ccert, ckey = self.tls.issue(f"{oid}.client", server=False)
            for name, data in (("ca.crt", self.tls.cert_pem),
                               ("server.crt", scert), ("server.key", skey),
                               ("client.crt", ccert), ("client.key", ckey)):
                self._write(os.path.join("tls", oid, name), data)
            self._write(os.path.join("config", f"{oid}.yaml"),
                        self._core_yaml(self.oops[oid]))
        pcert, pkey = self.tls.issue("peer.example.com",
                                     sans=("localhost", "127.0.0.1"))
        for name, data in (("ca.crt", self.tls.cert_pem),
                           ("server.crt", pcert), ("server.key", pkey)):
            self._write(os.path.join("tls", "peer", name), data)
        for pid, _org in self.peers:
            self._write(os.path.join("config", f"{pid}.yaml"),
                        self._core_yaml(self.pops[pid]))

    def _core_yaml(self, ops_port: int) -> str:
        return ("peer:\n"
                "  fileSystemPath: ledgers\n"
                "  BCCSP:\n"
                f"    Default: {self.bccsp}\n"
                "operations:\n"
                f"  listenAddress: 127.0.0.1:{ops_port}\n"
                "logging:\n"
                "  spec: info\n")

    # -- command lines ------------------------------------------------------
    def orderer_args(self, oid: str) -> List[str]:
        peers = ",".join(f"{j}=127.0.0.1:{self.cports[j]}"
                         for j in self.o_ids)
        return ["node", "--role", "orderer", "--id", oid,
                "--genesis", self.genesis, "--crypto", self.crypto_dir,
                "--orderer-org", "OrdererOrg",
                "--data", os.path.join(self.root, "data", oid),
                "--config", os.path.join(self.root, "config", f"{oid}.yaml"),
                "--listen", f"127.0.0.1:{self.bports[oid]}",
                "--cluster-listen", f"127.0.0.1:{self.cports[oid]}",
                "--cluster-peers", peers,
                "--tls-dir", os.path.join(self.root, "tls", oid)]

    def peer_args(self, pid: str, org: str) -> List[str]:
        orderers = ",".join(f"127.0.0.1:{self.bports[j]}"
                            for j in self.o_ids)
        return ["node", "--role", "peer", "--org", org,
                "--genesis", self.genesis, "--crypto", self.crypto_dir,
                "--data", os.path.join(self.root, "data", pid),
                "--config", os.path.join(self.root, "config", f"{pid}.yaml"),
                "--orderers", orderers,
                "--peer-listen", f"127.0.0.1:{self.eports[pid]}",
                "--tls-dir", os.path.join(self.root, "tls", "peer")]

    def all_args(self) -> List[Tuple[str, List[str]]]:
        return ([(oid, self.orderer_args(oid)) for oid in self.o_ids]
                + [(pid, self.peer_args(pid, org))
                   for pid, org in self.peers])

    # -- processes ---------------------------------------------------------
    def spawn(self, name: str, args: List[str]) -> None:
        log = open(os.path.join(self.root, f"{name}.log"), "wb")
        self.logs[name] = log
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", "fabric_mod_tpu_torch.cli.main"] + args,
            stdout=log, stderr=log, cwd=ROOT, preexec_fn=_die_with_parent)

    def start_all(self) -> None:
        for name, args in self.all_args():
            self.spawn(name, args)

    def kill(self, name: str) -> None:
        """SIGKILL one child (a crash) and reap it."""
        p = self.procs[name]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)

    def teardown(self, grace_s: float = 20.0) -> None:
        """SIGTERM every live child, SIGKILL what outlives `grace_s`."""
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + grace_s
        for p in self.procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for log in self.logs.values():
            log.close()

    def log_text(self, name: str) -> str:
        with open(os.path.join(self.root, f"{name}.log"), "rb") as f:
            return f.read().decode(errors="replace")

    def alive(self, name: str) -> bool:
        p = self.procs.get(name)
        return p is None or p.poll() is None

    # -- observation -------------------------------------------------------
    def channel_info(self, oid: str) -> dict:
        return http_json(f"http://127.0.0.1:{self.oops[oid]}"
                         "/participation/v1/channels")["channels"][0]

    def leader(self):
        """The orderer that says it leads, or None."""
        for oid in self.o_ids:
            if not self.alive(oid):
                continue
            try:
                if self.channel_info(oid).get("is_leader"):
                    return oid
            except Exception:
                continue
        return None

    def leader_known_by_all(self) -> bool:
        """One live orderer leads and every live one names it."""
        leaders, known = [], []
        for oid in self.o_ids:
            if not self.alive(oid):
                continue
            chan = self.channel_info(oid)
            if chan.get("is_leader"):
                leaders.append(oid)
            known.append(chan.get("leader_id"))
        return (len(leaders) == 1 and len(known) > 1
                and all(k is not None and k == known[0] for k in known))

    def peer_metric(self, pid: str, name: str):
        return metric_value(f"http://127.0.0.1:{self.pops[pid]}/metrics",
                            name)

    def peer_height(self, pid: str) -> int:
        return int(self.peer_metric(pid, "ledger_blockchain_height") or 0)

    def cc_args(self, verb: str, cc_args: str, peers=None,
                orderer: str = "o0", name: str = "mycc",
                extra=()) -> List[str]:
        """`chaincode <verb>` arguments as Org1's user0, to `peers`
        (default: every peer) and, for invoke, orderer `orderer`."""
        peers = peers or [p for p, _ in self.peers]
        argv = ["chaincode", verb, "--channel", self.channel, "--name",
                name, "--args", cc_args, "--crypto", self.crypto_dir,
                "--org", self.peers[0][1], "--user", "user0",
                "--peers", ",".join(f"127.0.0.1:{self.eports[p]}"
                                    for p in peers),
                "--tls-ca", os.path.join(self.root, "tls", "peer", "ca.crt")]
        if verb == "invoke":
            argv += ["--orderer", f"127.0.0.1:{self.bports[orderer]}"]
        return argv + list(extra)
