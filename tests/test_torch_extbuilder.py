"""External chaincode in the port (fabric_mod_tpu_torch/peer/extbuilder.py,
platforms.py, ccpackage.py), mirroring tests/test_extbuilder.py,
test_platforms.py and test_ccpackage.py and held to the reference's:

* a ccaas round trip: a contract served over TCP answers like the
  in-process one, state callbacks, transient maps and private data
  included, and endorses like it (the same proposal response payload:
  response and write set); a contract error comes back as an error, and
  a server that is down is a clean ChaincodeError;
* across packages: the reference's ChaincodeServer answers the port's
  ExternalContract, and the port's server the reference's, each equal to
  the in-process contract (payloads and writes);
* the launcher resolves python (a reference-built package gives a port
  contract), ccaas, script and external-builder packages, refuses an
  unknown type and an ambiguous label;
* package bytes and ids equal to the reference's, each package parsing
  the other's and reading the other's store.
"""
import json
import os
import pathlib
import stat
import sys

import pytest

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.peer.ccpackage import (PackageError, PackageStore,
                                                 build_package, package_id,
                                                 parse_package)
from fabric_mod_tpu_torch.peer.chaincode import (ChaincodeError,
                                                 ChaincodeRegistry,
                                                 ChaincodeStub, KvContract)
from fabric_mod_tpu_torch.peer.extbuilder import (ChaincodeLauncher,
                                                  ChaincodeServer,
                                                  ExternalBuilderError,
                                                  ExternalBuilderRegistry,
                                                  ExternalContract)
from fabric_mod_tpu_torch.peer.platforms import (CCaaSPlatform,
                                                 PlatformError,
                                                 PlatformRegistry,
                                                 PythonPlatform,
                                                 ScriptPlatform)
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

REPO = str(pathlib.Path(__file__).resolve().parents[1])
KV_PACKAGE = (b"from fabric_mod_tpu.peer.chaincode import KvContract\n"
              b"contract = KvContract()\n")
# the ops each side drives: (args, transient)
OPS = [
    ([b"put", b"k1", b"v1"], {}),
    ([b"get", b"k1"], {}),
    ([b"get", b"missing"], {}),
    ([b"put", b"k2", b"v2"], {}),
    ([b"del", b"k2"], {}),
    ([b"setvp", b"k1", b"policy-bytes"], {}),
    ([b"putpvt", b"col1", b"pk"], {"value": b"secret"}),
    ([b"getpvt", b"col1", b"pk"], {}),
    ([b"nosuch"], {}),
]


class _Sim:
    """A dict-backed simulator recording every write, for driving a
    contract without a ledger (both packages' stubs call these)."""

    def __init__(self):
        self.kv, self.writes = {}, []

    def get_state(self, ns, key):
        return self.kv.get((ns, key))

    def set_state(self, ns, key, value):
        self.kv[(ns, key)] = value
        self.writes.append(("put", ns, key, value))

    def delete_state(self, ns, key):
        self.kv.pop((ns, key), None)
        self.writes.append(("del", ns, key))

    def get_state_range(self, ns, start, end):
        return iter(sorted((k, v) for (n, k), v in self.kv.items()
                           if n == ns and start <= k < end))

    def set_state_metadata(self, ns, key, name, value):
        self.writes.append(("meta", ns, key, name, value))

    def set_private_data(self, ns, coll, key, value):
        self.kv[(ns + "$" + coll, key)] = value
        self.writes.append(("pvt", ns, coll, key, value))

    def get_private_data(self, ns, coll, key):
        return self.kv.get((ns + "$" + coll, key))

    def delete_private_data(self, ns, coll, key):
        self.kv.pop((ns + "$" + coll, key), None)
        self.writes.append(("pvtdel", ns, coll, key))


def _drive(contract, stub_cls, error_cls):
    """Every op of OPS through `contract` on one simulator: (results,
    writes); an error op's result is ("error", message)."""
    sim = _Sim()
    out = []
    for i, (args, transient) in enumerate(OPS):
        stub = stub_cls("kv", sim, list(args), f"tx{i}", "ch",
                        transient=dict(transient))
        try:
            out.append(contract.invoke(stub))
        except error_cls as e:
            out.append(("error", str(e)))
    return out, sim.writes


@pytest.fixture()
def port_server():
    srv = ChaincodeServer(KvContract())
    srv.start()
    yield srv
    srv.stop()


def test_port_server_answers_like_the_in_process_contract(port_server):
    ext = ExternalContract({"address": port_server.address})
    try:
        got = _drive(ext, ChaincodeStub, ChaincodeError)
    finally:
        ext.close()
    assert got == _drive(KvContract(), ChaincodeStub, ChaincodeError)
    assert got[0][-1] == ("error", "unknown op 'nosuch'")


def test_reference_server_answers_the_port_contract():
    from fabric_mod_tpu.peer.chaincode import KvContract as JKvContract
    from fabric_mod_tpu.peer.extbuilder import \
        ChaincodeServer as JChaincodeServer
    srv = JChaincodeServer(JKvContract())
    srv.start()
    ext = ExternalContract({"address": srv.address})
    try:
        got = _drive(ext, ChaincodeStub, ChaincodeError)
    finally:
        ext.close()
        srv.stop()
    assert got == _drive(KvContract(), ChaincodeStub, ChaincodeError)


def test_port_server_answers_the_reference_contract(port_server):
    from fabric_mod_tpu.peer.chaincode import ChaincodeError as JError
    from fabric_mod_tpu.peer.chaincode import ChaincodeStub as JStub
    from fabric_mod_tpu.peer.chaincode import KvContract as JKvContract
    from fabric_mod_tpu.peer.extbuilder import \
        ExternalContract as JExternalContract
    ext = JExternalContract({"address": port_server.address})
    try:
        got = _drive(ext, JStub, JError)
    finally:
        ext.close()
    assert got == _drive(JKvContract(), JStub, JError) == \
        _drive(KvContract(), ChaincodeStub, ChaincodeError)


def test_ccaas_endorsement_equals_the_in_process_one(tmp_path, port_server):
    """The same signed proposal endorsed through the TCP contract and
    the in-process one: the same proposal response payload (response,
    write set, chaincode id), state callbacks and range reads included;
    a contract error is a 500."""
    net = e2e.Network(str(tmp_path), material=fixtures.make_network_material(
        71, max_message_count=10, batch_timeout="100ms"),
        verifier=sw.SwVerifier())
    ext = ExternalContract({"address": port_server.address})
    try:
        net.chaincodes.register("kvx", KvContract())
        net.invoke([b"put", b"seen", b"v0"], chaincode="kvx")
        assert net.pump_committed(1) == 1
        # the two contracts under one name, swapped between endorsements
        for args in ([b"put", b"k1", b"v1"], [b"get", b"seen"],
                     [b"del", b"seen"], [b"get", b"missing"]):
            sp, _p, _txid = protoutil.create_chaincode_proposal(
                net.channel_id, "kvx", args, net.client)
            net.chaincodes.register("kvx", ext)
            remote = net.endorsers["Org1"].process_proposal(sp)
            net.chaincodes.register("kvx", KvContract())
            local = net.endorsers["Org1"].process_proposal(sp)
            assert remote.response.status == 200
            assert remote.payload == local.payload
            assert remote.response.payload == local.response.payload
        net.chaincodes.register("kvx", ext)
        sp, _p, _ = protoutil.create_chaincode_proposal(
            net.channel_id, "kvx", [b"nosuch"], net.client)
        assert net.endorsers["Org1"].process_proposal(
            sp).response.status == 500
    finally:
        ext.close()
        net.close()


def test_a_server_that_is_down_is_a_clean_error():
    ext = ExternalContract({"address": "127.0.0.1:1"})
    stub = ChaincodeStub("x", None, [b"get", b"k"], "tx1", "chan")
    with pytest.raises(ChaincodeError, match="unreachable"):
        ext.invoke(stub)
    with pytest.raises(ExternalBuilderError):
        ExternalContract({"address": "no-port"})


def test_python_package_built_by_the_reference_gives_a_port_contract(
        tmp_path):
    from fabric_mod_tpu.peer.ccpackage import build_package as jbuild
    store = PackageStore(str(tmp_path / "pkgs"))
    store.save(jbuild("pycc", KV_PACKAGE, cc_type="python"))
    launcher = ChaincodeLauncher(store)
    reg = ChaincodeRegistry()
    reg.set_resolver(launcher.resolve)
    cc = reg.get("pycc")
    # the package's import of the reference's module gave the port's
    assert type(cc) is KvContract
    assert reg.get("pycc") is cc                  # cached
    assert reg.get("absent") is None
    with pytest.raises(PlatformError, match="no `contract`"):
        PythonPlatform().build("bad", b"x = 1\n", None)


def test_launcher_resolves_ccaas_and_refuses_unknown_and_ambiguous(
        tmp_path, port_server):
    store = PackageStore(str(tmp_path / "pkgs"))
    store.save(build_package("remote-cc", json.dumps(
        {"address": port_server.address}).encode(), cc_type="ccaas"))
    store.save(build_package("gocc", b"package main", cc_type="golang"))
    store.save(build_package("dupcc", b"v1", cc_type="python"))
    store.save(build_package("dupcc", b"v2", cc_type="python"))
    launcher = ChaincodeLauncher(store)
    cc = launcher.resolve("remote-cc")
    try:
        assert isinstance(cc, ExternalContract)
        sim = _Sim()
        assert cc.invoke(ChaincodeStub("kv", sim, [b"put", b"a", b"1"],
                                       "t", "ch")) == b"ok"
        assert sim.writes == [("put", "kv", "a", b"1")]
    finally:
        cc.close()
    with pytest.raises(ExternalBuilderError, match="no builder"):
        launcher.resolve("gocc")
    with pytest.raises(ExternalBuilderError, match="ambiguous"):
        launcher.resolve("dupcc")
    reg = PlatformRegistry()
    assert isinstance(reg.platform_for("ccaas"), CCaaSPlatform)
    assert isinstance(reg.platform_for("binary"), ScriptPlatform)
    assert reg.platform_for("golang") is None


_SERVER_MAIN = (
    "import json, os, sys, time\n"
    "sys.path.insert(0, %r)\n"
    "from fabric_mod_tpu_torch.peer.chaincode import KvContract\n"
    "from fabric_mod_tpu_torch.peer.extbuilder import ChaincodeServer\n"
    "meta = json.load(open(%s))\n"
    "srv = ChaincodeServer(KvContract())\n"
    "srv.start()\n"
    "with open(meta['address_file'] + '.tmp', 'w') as f:\n"
    "    f.write(srv.address + '\\n')\n"
    "os.replace(meta['address_file'] + '.tmp', meta['address_file'])\n"
    "time.sleep(600)\n")


def test_launcher_runs_a_script_package_in_its_own_process(tmp_path):
    store = PackageStore(str(tmp_path / "pkgs"))
    script = (_SERVER_MAIN % (REPO, "sys.argv[1]")).encode()
    store.save(build_package("scc", script, cc_type="script"))
    store.save(build_package("dies", b"import sys; sys.exit(3)\n",
                             cc_type="script"))
    launcher = ChaincodeLauncher(store)
    try:
        cc = launcher.resolve("scc")
        sim = _Sim()
        assert cc.invoke(ChaincodeStub("kv", sim, [b"put", b"sk", b"sv"],
                                       "t", "ch")) == b"ok"
        assert sim.kv == {("kv", "sk"): b"sv"}
        cc.close()
        with pytest.raises(ExternalBuilderError, match="rc=3"):
            launcher.resolve("dies")
    finally:
        launcher.close()


def test_launcher_builds_and_runs_through_an_external_builder(tmp_path):
    """detect / build / run as subprocesses: the first builder whose
    detect exits 0 claims the package, and its bin/run publishes the
    address the launcher dials."""
    root = tmp_path / "builders"
    runner = tmp_path / "runner.py"
    runner.write_text(_SERVER_MAIN % (
        REPO, "sys.argv[1] + '/chaincode.json'"))
    scripts = {
        "never": {"detect": "#!/bin/sh\nexit 1\n"},
        "pyrun": {"detect": "#!/bin/sh\nexit 0\n",
                  "build": "#!/bin/sh\ncp -r \"$1\"/. \"$3\"/\n",
                  "run": f"#!/bin/sh\nexec {sys.executable} {runner} "
                         f"\"$2\"\n"}}
    for builder, bodies in scripts.items():
        os.makedirs(root / builder / "bin")
        for name, body in bodies.items():
            p = root / builder / "bin" / name
            p.write_text(body)
            p.chmod(p.stat().st_mode | stat.S_IEXEC)
    builders = ExternalBuilderRegistry(str(root))
    assert [b.name for b in builders.builders] == ["never", "pyrun"]
    store = PackageStore(str(tmp_path / "pkgs"))
    store.save(build_package("runcc", b"payload", cc_type="custom"))
    launcher = ChaincodeLauncher(store, builders)
    try:
        cc = launcher.resolve("runcc")
        assert isinstance(cc, ExternalContract)
        with pytest.raises(ChaincodeError, match="unknown op"):
            cc.invoke(ChaincodeStub("runcc", _Sim(), [b"nosuch"], "t", "ch"))
        cc.close()
    finally:
        launcher.close()


def test_package_bytes_ids_and_stores_equal_the_reference(tmp_path,
                                                          monkeypatch):
    from fabric_mod_tpu.peer import ccpackage as jpkg
    import gzip
    # the gzip header carries the build second in both packages
    monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)
    for label, code, cc_type in (("mycc_1.0", b"def invoke(stub): ...",
                                  "python"),
                                 ("remote-cc", b'{"address": "h:1"}',
                                  "ccaas"),
                                 ("a.b+c-d_e", KV_PACKAGE, "script")):
        raw = build_package(label, code, cc_type)
        assert raw == jpkg.build_package(label, code, cc_type)
        assert package_id(label, raw) == jpkg.package_id(label, raw)
        assert parse_package(raw) == jpkg.parse_package(raw) == \
            (label, cc_type, code)
    for bad in (b"not a tarball", build_package("evil/../label", b"x")):
        with pytest.raises(PackageError):
            parse_package(bad)
        with pytest.raises(jpkg.PackageError):
            jpkg.parse_package(bad)
    jstore = jpkg.PackageStore(str(tmp_path / "pkgs"))
    ids = [jstore.save(build_package("cc%d" % i, b"code%d" % i))
           for i in range(3)]
    store = PackageStore(str(tmp_path / "pkgs"))
    assert store.list() == jstore.list() == sorted(ids)
    assert [store.load(pid) for pid in ids] == \
        [jstore.load(pid) for pid in ids]
    for bad in ("../secret:" + "0" * 64, "a:short", "noseparator"):
        with pytest.raises(PackageError):
            store.load(bad)
