"""The port's configtxlator, idemixgen, discover and ledger tools
against the reference's, on the same inputs.

* configtxlator: proto_decode JSON and proto_encode bytes equal the
  reference's; compute_update's ConfigUpdate bytes equal the reference
  library's diff of the same configs, and the port's channelconfig
  accepts it.
* idemixgen: the port's issuer key and signer config load in the
  reference (and the reference's in the port); the credential is valid
  in both; a presentation made by the port verifies under the
  reference's host check and the port's plain path.
* discover: peers, config and endorsers JSON equal the reference's.
* ledger: snapshot, join-from-snapshot, rollback and rebuild-dbs over
  the same blocks give the same heights and fingerprints in both.
* main: node and chaincode parse their arguments (usage errors exit 2).
"""
import io
import json
import os
import random
from contextlib import redirect_stdout

import pytest

from fabric_mod_tpu_torch.cli.main import main

ORGS = ("Org1", "Org2", "Org3")


def _run(fn, argv, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(argv, **kw) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    """A cryptogen tree of three orgs and a solo genesis at 1000 txs a
    block, made by the port's tools; and a membership file."""
    d = tmp_path_factory.mktemp("net")
    (d / "c.yaml").write_text(
        "PeerOrgs:\n" + "".join(f"  - Name: {o}\n    PeerCount: 2\n"
                                for o in ORGS)
        + "OrdererOrgs:\n  - Name: OrdererOrg\n")
    (d / "p.yaml").write_text(
        "ChannelID: toolchan\nPeerOrgs: [Org1, Org2, Org3]\n"
        "OrdererOrgs: [OrdererOrg]\nBatchSize:\n  MaxMessageCount: 1000\n")
    crypto, gen = str(d / "crypto"), str(d / "genesis.block")
    from fabric_mod_tpu_torch.cli.cryptogen import generate
    generate(str(d / "c.yaml"), crypto, seed=b"cli-tools")
    _run(main, ["configtxgen", "--profile", str(d / "p.yaml"),
                "--crypto", crypto, "--output", gen])
    members = {o: [f"peer{i}.{o.lower()}:7051" for i in range(2)]
               for o in ORGS}
    (d / "members.json").write_text(json.dumps(members))
    return {"dir": d, "crypto": crypto, "genesis": gen,
            "members": str(d / "members.json")}


# -- configtxlator -----------------------------------------------------------

def test_configtxlator_json_and_bytes_equal_the_reference(tmp_path, network):
    from fabric_mod_tpu.cli.configtxlator import main as ref_main
    gen = network["genesis"]
    for type_name in ("Block", "Envelope", "Config"):
        if type_name == "Block":
            src = gen
        else:
            from fabric_mod_tpu_torch.channelconfig import config_from_block
            from fabric_mod_tpu_torch.protos import messages as m
            with open(gen, "rb") as f:
                block = m.Block.decode(f.read())
            raw = (block.data.data[0] if type_name == "Envelope"
                   else config_from_block(block)[1].encode())
            src = str(tmp_path / f"{type_name}.pb")
            with open(src, "wb") as f:
                f.write(raw)
        argv = ["proto_decode", "--type", type_name, "--input", src]
        got = _run(lambda a: main(["configtxlator"] + a), argv)
        assert got == _run(ref_main, argv)
        jpath = tmp_path / f"{type_name}.json"
        jpath.write_text(got)
        out, ref_out = str(tmp_path / "o.pb"), str(tmp_path / "r.pb")
        _run(lambda a: main(["configtxlator"] + a),
             ["proto_encode", "--type", type_name, "--input", str(jpath),
              "--output", out])
        _run(ref_main, ["proto_encode", "--type", type_name, "--input",
                        str(jpath), "--output", ref_out])
        with open(out, "rb") as a, open(ref_out, "rb") as b, \
                open(src, "rb") as c:
            assert a.read() == b.read() == c.read()


def test_configtxlator_compute_update(tmp_path, network):
    from fabric_mod_tpu.channelconfig import compute_update as ref_compute
    from fabric_mod_tpu.cli.configtxlator import main as ref_main
    from fabric_mod_tpu.protos import messages as rm
    from fabric_mod_tpu_torch.channelconfig import (Bundle,
                                                    config_from_block)
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP, SwVerifier
    from fabric_mod_tpu_torch.channelconfig import signed_update_envelope
    from fabric_mod_tpu_torch.channelconfig.configtx import (
        extract_config_update, propose_config_update)
    from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                     deserialize_cert)
    from fabric_mod_tpu_torch.protos import messages as m
    with open(network["genesis"], "rb") as f:
        cid, config = config_from_block(m.Block.decode(f.read()))
    new = m.Config.decode(config.encode())
    for g in new.channel_group.groups:
        if g.key == "Orderer":
            for v in g.value.values:
                if v.key == "BatchSize":
                    bs = m.BatchSize.decode(v.value.value)
                    bs.max_message_count = 500
                    v.value.value = bs.encode()
    orig, upd = tmp_path / "orig.pb", tmp_path / "upd.pb"
    orig.write_bytes(config.encode())
    upd.write_bytes(new.encode())
    out = tmp_path / "update.pb"
    argv = ["compute_update", "--channel_id", cid, "--original", str(orig),
            "--updated", str(upd), "--output", str(out)]
    _run(lambda a: main(["configtxlator"] + a), argv)
    want = ref_compute(cid, rm.Config.decode(config.encode()),
                       rm.Config.decode(new.encode()).channel_group)
    assert out.read_bytes() == want.encode()
    # the reference's command hands compute_update the whole Config
    with pytest.raises(AttributeError):
        ref_main(argv)
    # the port's config processing takes the update signed by the
    # orderer org's admin: sequence 1, 500 txs a block
    csp = SwCSP()
    with open(os.path.join(network["crypto"], "OrdererOrg", "admin",
                           "admin.pem"), "rb") as f:
        cert = deserialize_cert(f.read())
    with open(os.path.join(network["crypto"], "OrdererOrg", "admin",
                           "admin.key"), "rb") as f:
        admin = SigningIdentity("OrdererOrg", cert, f.read(), csp)
    env = signed_update_envelope(cid, m.ConfigUpdate.decode(
        out.read_bytes()), [admin])
    next_cfg = propose_config_update(Bundle(cid, config, csp),
                                     extract_config_update(env),
                                     SwVerifier().verify_many)
    bundle = Bundle(cid, next_cfg, csp)
    assert (next_cfg.sequence, bundle.batch_config().max_message_count) == \
        (1, 500)


# -- idemixgen ----------------------------------------------------------------

def test_idemixgen_artifacts_cross_the_packages(tmp_path):
    from fabric_mod_tpu.cli.idemixgen import main as ref_main
    from fabric_mod_tpu.idemix import credential as Jcred
    from fabric_mod_tpu.msp import idemixmsp as Jmsp
    from fabric_mod_tpu_torch import convert
    from fabric_mod_tpu_torch.cli import idemixgen
    from fabric_mod_tpu_torch.idemix import credential as Tcred
    rng = random.Random(2121)
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ik = idemixgen.ca_keygen(port_dir, rng=rng)
    conf = idemixgen.signerconfig(port_dir, port_dir, org_unit="Org1",
                                  enrollment_id="alice", role=1, rng=rng)
    _run(ref_main, ["ca-keygen", "--output", ref_dir])
    _run(ref_main, ["signerconfig", "--ca-input", ref_dir, "--output",
                    ref_dir, "--org-unit", "Org1", "--enrollment-id", "bob"])
    for d, tag in ((port_dir, "port"), (ref_dir, "ref")):
        with open(os.path.join(d, "IssuerKey.json")) as f:
            key_d = json.load(f)
        with open(os.path.join(d, "IssuerPublicKey.json")) as f:
            pub_d = json.load(f)
        with open(os.path.join(d, "user", "SignerConfig.json")) as f:
            signer = json.load(f)
        assert set(signer) == {"sk", "credential", "organizational_unit",
                               "enrollment_id", "role"}, tag
        for K, cred_mod in ((Tcred.IssuerKey, Tcred),
                            (Jcred.IssuerKey, Jcred)):
            pub = K.from_dict(pub_d)
            assert K.from_dict(key_d).public_dict() == pub_d
            c = cred_mod.Credential.from_dict(signer["credential"])
            assert cred_mod.credential_valid(pub, c), tag
    # a presentation by the port under its own issuer key
    with open(os.path.join(port_dir, "user", "SignerConfig.json")) as f:
        signer = json.load(f)
    cred = Tcred.Credential.from_dict(signer["credential"])
    sk = int(signer["sk"], 16)
    disclosed = {0: cred.attrs[0]}
    sig = Tcred.sign(ik, cred, sk, b"msg", disclosed, rng=rng)
    bad = Tcred.sign(ik, cred, sk, b"msg", disclosed, rng=rng)
    bad.z_sk = (bad.z_sk + 1) % Tcred.R
    assert conf["credential"] == signer["credential"]
    ref_ik = Jcred.IssuerKey.from_dict(ik.public_dict())
    ref_items = [(Jmsp._sig_from_dict(json.loads(
        convert.presentation_to_reference(s))), b"msg", disclosed)
        for s in (sig, bad)]
    assert Jcred.batch_verify(ref_ik, ref_items, use_device=False) == \
        [True, False]
    assert Tcred.batch_verify(ik, [(sig, b"msg", disclosed),
                                   (bad, b"msg", disclosed)],
                              device="cpu") == [True, False]


# -- discover -----------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["peers", "config", "endorsers"])
def test_discover_answers_equal_the_reference(network, cmd):
    from fabric_mod_tpu.cli.discover import main as ref_main
    from fabric_mod_tpu_torch.cli.discover import main as port_main
    argv = [cmd, "--genesis", network["genesis"], "--membership",
            network["members"]]
    if cmd == "endorsers":
        argv += ["--chaincode", "mycc"]
    got = json.loads(_run(port_main, argv))
    assert got == json.loads(_run(ref_main, argv))
    if cmd == "endorsers":
        assert sorted(sorted(lo) for lo in got["layouts"]) == [
            ["Org1", "Org2"], ["Org1", "Org3"], ["Org2", "Org3"]]


def test_discover_checks_no_signatures(network):
    """The offline tool answers without a verifier: its service's
    verify_many raises, so a query that reached a signature check would
    fail instead of verifying anywhere."""
    from fabric_mod_tpu_torch.cli import discover
    got = discover.query("endorsers", network["genesis"], network["members"],
                         "mycc")
    assert len(got["layouts"]) == 3
    with pytest.raises(RuntimeError, match="checks no signatures"):
        discover._no_verify([])


# -- ledger -------------------------------------------------------------------

def _blocks(n_blocks, per_block, seed):
    """Encoded chained blocks of endorser txs writing seeded keys."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    rng = random.Random(seed)
    out, prev = [], b""
    for b in range(n_blocks):
        envs = []
        for t in range(per_block):
            rw = RWSetBuilder()
            rw.add_write("ns", f"k{rng.randrange(40)}", b"v%d-%d" % (b, t))
            cca = m.ChaincodeAction(results=rw.build().encode())
            prp = m.ProposalResponsePayload(proposal_hash=b"\x01" * 32,
                                            extension=cca.encode())
            cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
                proposal_response_payload=prp.encode(), endorsements=[]))
            tx = m.Transaction(actions=[m.TransactionAction(
                payload=cap.encode())])
            txid = f"tx{b}-{t}"
            ch = protoutil.make_channel_header(
                m.HeaderType.ENDORSER_TRANSACTION, "toolchan", tx_id=txid)
            sh = protoutil.make_signature_header(b"creator", txid.encode())
            envs.append(m.Envelope(payload=protoutil.make_payload(
                ch, sh, tx.encode()).encode()))
        block = protoutil.new_block(b, prev, envs)
        prev = protoutil.block_header_hash(block.header)
        out.append(block.encode())
    return out


def test_ledger_tools_give_equal_heights_and_fingerprints(tmp_path):
    from fabric_mod_tpu.cli.ledgerutil import main as ref_main
    from fabric_mod_tpu.ledger.kvledger import KvLedger as RefLedger
    from fabric_mod_tpu.protos import messages as rm
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.protos import messages as m
    blocks = _blocks(6, 5, 6)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    led = KvLedger("toolchan", port)
    rled = RefLedger(ref, "toolchan")
    for raw in blocks:
        led.commit_block(m.Block.decode(raw), [0] * 5)
        rled.commit_block(rm.Block.decode(raw), [0] * 5)
    led.close()
    rled.close()

    def state(kind, path):
        lg = (KvLedger("toolchan", path) if kind == "port"
              else RefLedger(path, "toolchan"))
        try:
            return lg.height, lg.state_fingerprint()
        finally:
            lg.close()

    def both(port_argv, ref_argv):
        _run(lambda a: main(["ledger"] + a), port_argv)
        _run(ref_main, ref_argv)

    assert state("port", port) == state("ref", ref)
    both(["snapshot", "--ledger", port, "--channel", "toolchan",
          "--output", str(tmp_path / "ps")],
         ["snapshot", "--ledger", ref, "--channel", "toolchan",
          "--output", str(tmp_path / "rs")])
    with open(tmp_path / "ps" / "_snapshot_signable_metadata.json") as a, \
            open(tmp_path / "rs" / "_snapshot_signable_metadata.json") as b:
        assert json.load(a) == json.load(b)
    both(["join-from-snapshot", "--snapshot", str(tmp_path / "ps"),
          "--ledger", str(tmp_path / "pj")],
         ["join-from-snapshot", "--snapshot", str(tmp_path / "rs"),
          "--ledger", str(tmp_path / "rj")])
    joined = state("port", str(tmp_path / "pj"))
    assert joined == state("ref", str(tmp_path / "rj"))
    assert joined == state("port", port)
    both(["rollback", "--ledger", port, "--block", "3"],
         ["rollback", "--ledger", ref, "--block", "3"])
    rolled = state("port", port)
    assert rolled == state("ref", ref) and rolled[0] == 4
    both(["rebuild-dbs", "--ledger", port], ["rebuild-dbs", "--ledger", ref])
    assert state("port", port) == state("ref", ref) == rolled


@pytest.mark.parametrize("tool", ["node", "chaincode"])
def test_transport_tools_exit_2(tool, capsys):
    """node and chaincode are in the port: without their required
    arguments they exit 2 as a usage error (argparse), with --help 0."""
    with pytest.raises(SystemExit) as got:
        main([tool])
    assert got.value.code == 2
    assert "the following arguments are required" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        main([tool, "--help"])
    assert got.value.code == 0
    assert f"usage: {tool}" in capsys.readouterr().out
    assert main([]) == 2
    assert main(["nope"]) == 2
