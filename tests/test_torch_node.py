"""The port's node configuration and node entry points
(fabric_mod_tpu_torch/config.py, cli/node.py, cli/chaincode.py).

- `load_config` gives the reference's PeerConfig and OrdererConfig on
  the same core.yaml / orderer.yaml with no environment, and the port's
  `overrides=` equals the reference's `CORE_*` environment override of
  the same key; `peer.BCCSP.Default` takes GPU or SW and refuses TPU.
- Three Raft orderers and two peers of the tools-built network run in
  threads of the test's process (`run_orderer`, `run_peer` with
  `stop_event=`): a leader is elected over the cluster's mutual TLS,
  `chaincode invoke --wait-event` endorses on both peers, orders and
  learns VALID from the first peer's event stream, `chaincode query`
  reads the value back from each peer, both peers commit the same
  chain, and every node stops on the event.
"""
import contextlib
import dataclasses
import io
import os
import threading
import time

import pytest
from fabric_mod_tpu import config as jconfig


from fabric_mod_tpu_torch.cli.main import main as cli
from fabric_mod_tpu_torch.config import (OrdererConfig, PeerConfig,
                                         load_config)
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import procnet as pn

CORE = """\
# a core.yaml with every key the peer's config reads
peer:
  fileSystemPath: /var/hyperledger/production
  validatorPoolSize: 4
  deliverclient:
    queueSize: 16
  BCCSP:
    Default: SW
operations:
  listenAddress: 127.0.0.1:9443
  tls:
    cert:
      file: /etc/tls/server.crt
    key:
      file: /etc/tls/server.key
    clientRootCAs:
      file: /etc/tls/ca.crt
logging:
  spec: debug
"""
ORDERER = """\
General:
  FileSystemPath: /var/orderer
  ConsensusType: etcdraft
Operations:
  ListenAddress: 0.0.0.0:8443
"""


@pytest.fixture()
def no_env(monkeypatch):
    import os as _os
    for key in list(_os.environ):
        if key.startswith(("CORE_", "ORDERER_")):
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.mark.parametrize("cls,doc", [("PeerConfig", CORE),
                                     ("OrdererConfig", ORDERER),
                                     ("PeerConfig", "")])
def test_load_config_equals_the_references(tmp_path, no_env, cls, doc):
    path = tmp_path / "config.yaml"
    path.write_text(doc)
    mine = load_config({"PeerConfig": PeerConfig,
                        "OrdererConfig": OrdererConfig}[cls], str(path))
    theirs = jconfig.load_config(getattr(jconfig, cls), str(path))
    want = dataclasses.asdict(theirs)
    if cls == "PeerConfig" and not doc:
        # the one default that differs: the card, not the TPU
        assert (want.pop("bccsp"), mine.bccsp) == ("TPU", "GPU")
        want["bccsp"] = "GPU"
    assert dataclasses.asdict(mine) == want


def test_overrides_equal_the_references_environment(tmp_path, no_env):
    path = tmp_path / "core.yaml"
    path.write_text(CORE)
    no_env.setenv("CORE_BCCSP_DEFAULT", "GPU")
    no_env.setenv("CORE_DELIVERCLIENT_QUEUESIZE", "32")
    theirs = jconfig.load_config(jconfig.PeerConfig, str(path))
    mine = load_config(PeerConfig, str(path), overrides={
        "peer.BCCSP.Default": "GPU", "peer.deliverclient.queueSize": "32"})
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (mine.bccsp, mine.deliver_queue_size) == ("GPU", 32)
    with pytest.raises(ValueError, match="TPU"):
        load_config(PeerConfig, str(path),
                    overrides={"peer.bccsp.default": "TPU"})


def run_in_threads(net):
    """Every node of `net` through cli.node.run_orderer / run_peer on a
    thread of this process; (stop event, threads, ready), where
    `ready[name]` is what the node handed its `ready` callback (a peer's
    ledger among it) once it served."""
    from fabric_mod_tpu_torch.cli import node
    stop = threading.Event()
    threads, ready = [], {}

    def cfg(name):
        return load_config(PeerConfig, os.path.join(net.root, "config",
                                                    f"{name}.yaml"))

    def tls(name):
        return node._read_tls_dir(os.path.join(net.root, "tls", name))
    cluster = {j: f"127.0.0.1:{net.cports[j]}" for j in net.o_ids}
    for oid in net.o_ids:
        threads.append(threading.Thread(
            target=node.run_orderer, name=oid, daemon=True,
            args=(oid, net.genesis, net.crypto_dir, "OrdererOrg",
                  os.path.join(net.root, "data", oid),
                  f"127.0.0.1:{net.bports[oid]}",
                  f"127.0.0.1:{net.cports[oid]}", cluster, cfg(oid)),
            kwargs={"tls": tls(oid), "stop_event": stop,
                    "ready": lambda info, k=oid: ready.__setitem__(k, info)}))
    for pid, org in net.peers:
        threads.append(threading.Thread(
            target=node.run_peer, name=pid, daemon=True,
            args=(org, net.genesis, net.crypto_dir,
                  os.path.join(net.root, "data", pid),
                  [f"127.0.0.1:{net.bports[j]}" for j in net.o_ids],
                  cfg(pid)),
            kwargs={"tls": tls("peer"), "stop_event": stop,
                    "peer_listen": f"127.0.0.1:{net.eports[pid]}",
                    "ready": lambda info, k=pid: ready.__setitem__(k, info)}))
    for t in threads:
        t.start()
    return stop, threads, ready


def _cc(argv):
    out = io.StringIO()
    out.buffer = io.BytesIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    # a query writes its payload to the binary buffer, then a newline
    return rc, out.buffer.getvalue().decode() + out.getvalue()


def test_orderers_and_peers_in_threads_serve_chaincode(tmp_path):
    net = pn.ProcNet(tmp_path, bccsp="SW")
    stop, threads, ready = run_in_threads(net)
    try:
        assert pn.wait(lambda: len(ready) == 5, t=60), sorted(ready)
        assert pn.wait(net.leader_known_by_all, t=60), "no leader"
        ledgers = {p: ready[p]["ledger"] for p, _ in net.peers}
        assert pn.wait(lambda: all(led.height >= 1
                                   for led in ledgers.values()), t=30)
        rc, out = _cc(net.cc_args("invoke", "put,nodekey,nodevalue",
                                  orderer=net.leader(),
                                  extra=["--wait-event", "--wait-timeout",
                                         "60"]))
        assert rc == 0, out
        assert out.split()[-1] == "0"          # VALID
        for p, _org in net.peers:
            assert pn.wait(lambda p=p: ledgers[p].height >= 2, t=30)
            rc, out = _cc(net.cc_args("query", "get,nodekey", peers=(p,)))
            assert (rc, out) == (0, "nodevalue\n"), p
        h = min(led.height for led in ledgers.values())
        assert h >= 2
        for n in range(h):
            assert len({protoutil.block_header_hash(
                led.get_block_by_number(n).header)
                for led in ledgers.values()}) == 1
    finally:
        stop.set()
        deadline = time.time() + 60
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.time()))
    assert not [t.name for t in threads if t.is_alive()]
    assert os.path.exists(os.path.join(net.root, "data", "p0", "ledgers"))
