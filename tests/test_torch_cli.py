"""The port's cryptogen and configtxgen against the reference's, and its
YAML reader against PyYAML.

* The port's cryptogen -> the port's configtxgen: the genesis opens in
  the reference's Bundle with the profile's MSP ids, batch config and
  consensus type (solo and etcdraft).
* The reference's cryptogen tree -> the port's configtxgen, opened by
  the port's Bundle.
* The same tree and profile through both configtxgens decode to equal
  Configs (the genesis header carries a random nonce, so the blocks'
  bytes differ; the configs must not).
* utils/yamlread.load equals yaml.safe_load on every YAML document of
  the reference's tools (their docstrings and tests/test_cli.py), and
  raises on what is outside its subset.
"""
import ast
import os
import textwrap

import pytest
import yaml

from fabric_mod_tpu_torch.utils import yamlread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CRYPTO = """\
PeerOrgs:
  - Name: Org1
    PeerCount: 2
    UserCount: 1
  - Name: Org2
    PeerCount: 1
  - Name: Org3
    PeerCount: 1
    UserCount: 2
OrdererOrgs:
  - Name: OrdererOrg
    OrdererCount: 3
"""
SOLO = """\
ChannelID: mychan
PeerOrgs: [Org1, Org2, Org3]   # must exist in the crypto dir
OrdererOrgs: [OrdererOrg]
BatchSize:
  MaxMessageCount: 123
  PreferredMaxBytes: 524288
BatchTimeout: 750ms
"""
RAFT = """\
ChannelID: raftchan
PeerOrgs: [Org1, Org2]
OrdererOrgs: [OrdererOrg]
BatchSize:
  MaxMessageCount: 1000
  AbsoluteMaxBytes: 1048576
BatchTimeout: 2s
ConsensusType: etcdraft
Consenters: [orderer0, orderer1, orderer2]
"""
PROFILES = {"solo": (SOLO, "mychan", ("Org1", "Org2", "Org3"), 123, 0.75,
                     "solo"),
            "etcdraft": (RAFT, "raftchan", ("Org1", "Org2"), 1000, 2.0,
                         "etcdraft")}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    from fabric_mod_tpu_torch.cli.main import main
    d = tmp_path_factory.mktemp("port_tree")
    out = str(d / "crypto")
    assert main(["cryptogen", "--config", _write(d, "c.yaml", CRYPTO),
                 "--output", out]) == 0
    return out


def _layout_ok(out):
    for rel in ("Org1/ca/ca.pem", "Org1/ca/ca.key", "Org1/peers/peer1.pem",
                "Org1/peers/peer1.key", "Org1/users/user0.key",
                "Org3/users/user1.pem", "Org1/admin/admin.pem",
                "OrdererOrg/orderers/orderer2.pem",
                "OrdererOrg/admin/admin.key"):
        assert os.path.exists(os.path.join(out, rel)), rel
    assert not os.path.exists(os.path.join(out, "Org2/users/user1.pem"))


@pytest.mark.parametrize("kind", ["solo", "etcdraft"])
def test_port_genesis_opens_in_the_reference_bundle(tmp_path, port_tree,
                                                    kind):
    from fabric_mod_tpu.bccsp.sw import SwCSP as RefCSP
    from fabric_mod_tpu.channelconfig import Bundle as RefBundle
    from fabric_mod_tpu.channelconfig.configtx import \
        config_from_block as ref_config_from_block
    from fabric_mod_tpu.protos import messages as rm
    from fabric_mod_tpu_torch.cli.main import main
    text, cid, orgs, count, timeout_s, ctype = PROFILES[kind]
    _layout_ok(port_tree)
    gen = str(tmp_path / "genesis.block")
    assert main(["configtxgen", "--profile", _write(tmp_path, "p.yaml", text),
                 "--crypto", port_tree, "--output", gen]) == 0
    with open(gen, "rb") as f:
        block = rm.Block.decode(f.read())
    got_cid, config = ref_config_from_block(block)
    bundle = RefBundle(got_cid, config, RefCSP())
    assert got_cid == cid
    assert bundle.application.org_mspids == orgs
    assert bundle.orderer.org_mspids == ("OrdererOrg",)
    bc = bundle.batch_config()
    assert bc.max_message_count == count
    assert abs(bc.batch_timeout_s - timeout_s) < 1e-9
    assert bundle.orderer.consensus_type == ctype
    if kind == "etcdraft":
        assert tuple(bundle.orderer.consenters()) == (
            "orderer0", "orderer1", "orderer2")
        assert bc.absolute_max_bytes == 1048576
    else:
        assert bc.preferred_max_bytes == 524288
    # every org's MSP takes the tree's own certificates
    for org in orgs:
        with open(os.path.join(port_tree, org, "peers", "peer0.pem"),
                  "rb") as f:
            ident = bundle.msp_manager.deserialize_identity(
                rm.SerializedIdentity(mspid=org, id_bytes=f.read()).encode())
        bundle.msp_manager.validate(ident)


def test_reference_tree_through_the_port_configtxgen(tmp_path):
    from fabric_mod_tpu.cli.cryptogen import generate as ref_generate
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.cli.configtxgen import make_genesis
    from fabric_mod_tpu_torch.protos import messages as m
    out = str(tmp_path / "crypto")
    ref_generate(_write(tmp_path, "c.yaml", CRYPTO), out)
    _layout_ok(out)
    cid, block = make_genesis(_write(tmp_path, "p.yaml", SOLO), out)
    got_cid, config = config_from_block(m.Block.decode(block.encode()))
    bundle = Bundle(got_cid, config, SwCSP())
    assert (cid, got_cid) == ("mychan", "mychan")
    assert bundle.application.org_mspids == ("Org1", "Org2", "Org3")
    assert bundle.batch_config().max_message_count == 123
    for org in ("Org1", "Org2", "Org3"):
        with open(os.path.join(out, org, "users", "user0.pem"), "rb") as f:
            ident = bundle.msp_manager.deserialize_identity(
                m.SerializedIdentity(mspid=org, id_bytes=f.read()).encode())
        bundle.msp_manager.validate(ident)


@pytest.mark.parametrize("kind", ["solo", "etcdraft"])
def test_both_configtxgens_give_equal_configs(tmp_path, port_tree, kind):
    from fabric_mod_tpu.channelconfig.configtx import \
        config_from_block as ref_config_from_block
    from fabric_mod_tpu.cli.configtxgen import make_genesis as ref_make
    from fabric_mod_tpu_torch.channelconfig import config_from_block
    from fabric_mod_tpu_torch.cli.configtxgen import make_genesis
    from fabric_mod_tpu_torch.protos import messages as m
    prof = _write(tmp_path, "p.yaml", PROFILES[kind][0])
    ref_cid, ref_block = ref_make(prof, port_tree)
    cid, block = make_genesis(prof, port_tree)
    assert cid == ref_cid
    _, ref_cfg = ref_config_from_block(ref_block)
    _, cfg = config_from_block(m.Block.decode(block.encode()))
    assert cfg.encode() == ref_cfg.encode()
    assert block.encode() != ref_block.encode()       # the header nonce


def test_network_material_from_the_tree(tmp_path, port_tree):
    """The tree and a genesis read back as e2e material: the client is
    Org1's user0, each org's peer0 and admin sign, the consenters map to
    the orderer org's ordererN."""
    from fabric_mod_tpu_torch.cli.configtxgen import make_genesis
    from fabric_mod_tpu_torch.cli.cryptogen import network_material
    _cid, block = make_genesis(_write(tmp_path, "p.yaml", RAFT), port_tree)
    mat = network_material(port_tree, block.encode())
    with open(os.path.join(port_tree, "Org1", "users", "user0.pem"),
              "rb") as f:
        assert mat.client == ("Org1", f.read(), mat.client[2])
    assert sorted(mat.peers) == ["Org1", "Org2"]
    assert sorted(mat.consenters) == ["orderer0", "orderer1", "orderer2"]
    assert mat.orderer == mat.consenters["orderer0"]
    assert mat.orderer_admin[0] == "OrdererOrg"


def test_cryptogen_is_seeded_in_the_library_and_random_on_the_command(
        tmp_path):
    from fabric_mod_tpu_torch.cli.cryptogen import generate
    conf = _write(tmp_path, "c.yaml", "PeerOrgs:\n  - Name: Org1\n")
    import datetime
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    pems = []
    for i, seed in enumerate((b"s", b"s", None)):
        out = str(tmp_path / f"t{i}")
        generate(conf, out, seed=seed, now=now)
        with open(os.path.join(out, "Org1", "peers", "peer0.key"),
                  "rb") as f:
            pems.append(f.read())
    assert pems[0] == pems[1] != pems[2]


# -- the YAML reader ----------------------------------------------------------

def _docstring_block(path, after):
    """The indented YAML block under the line `after` of a module
    docstring."""
    with open(path) as f:
        doc = ast.get_docstring(ast.parse(f.read()), clean=False)
    lines = doc.split("\n")
    i = next(k for k, ln in enumerate(lines) if ln.strip() == after) + 1
    block = []
    for ln in lines[i:]:
        if ln.strip() and not ln.startswith("    "):
            break
        block.append(ln)
    return textwrap.dedent("\n".join(block)).strip() + "\n"


def _reference_documents():
    docs = [
        _docstring_block(os.path.join(REPO, "fabric_mod_tpu/cli/cryptogen.py"),
                         "Config (YAML):"),
        _docstring_block(os.path.join(REPO,
                                      "fabric_mod_tpu/cli/configtxgen.py"),
                         "Profile (YAML):")]
    with open(os.path.join(REPO, "tests/test_cli.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "write_text"
                and node.args and isinstance(node.args[0], ast.Constant)):
            docs.append(node.args[0].value)
    return docs


def test_reader_equals_safe_load_on_the_reference_documents():
    docs = _reference_documents()
    assert len(docs) == 5
    for doc in docs + [CRYPTO, SOLO, RAFT, "", "# a comment only\n",
                       "---\nA: [x, 'y z', 3]\nB:\n- 'it''s'\n- \"q\\\"\"\n"
                       "C:\nD: -7\n"]:
        assert yamlread.load(doc) == yaml.safe_load(doc), doc


@pytest.mark.parametrize("doc, why", [
    ("A: &anchor 1\nB: *anchor\n", "an anchor"),
    ("A: !!str 1\n", "a tag"),
    ("A: 1\n---\nB: 2\n", "a second document"),
    ("A: |\n  text\n", "a block scalar"),
    ("A: {B: 1}\n", "a flow mapping"),
    ("A: yes\n", "a boolean"),
    ("A: 1.5\n", "a float"),
    ("A: 0x1f\n", "a non-decimal integer"),
    ("A: ~\n", "a null"),
    ("A: 2026-10-18\n", "a timestamp"),
    ("A:\n\tB: 1\n", "a tab"),
    ("%YAML 1.1\n---\nA: 1\n", "a directive"),
])
def test_reader_raises_outside_its_subset(doc, why):
    with pytest.raises(yamlread.YamlSubsetError, match=why):
        yamlread.load(doc)
