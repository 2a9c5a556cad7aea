"""The broker consenter in the port (fabric_mod_tpu_torch/orderer/broker.py),
mirroring tests/test_aux_components.py's broker cases and held to the
reference's fabric_mod_tpu/orderer/broker.py:

* two registrars consuming one topic cut identical blocks, the last by
  the time-to-cut message, and the reference's chain cuts the same
  blocks (header hashes) from the same envelopes;
* a chain reopened over its store and a reopened broker resumes from the
  offset in its tip block and cuts nothing twice;
* a byte-overflow cut loses no pending envelope across a restart;
* the registrar selects the consenter by ConsensusType;
* a topic file written by one package is read by the other, message for
  message, torn tail cropped alike.
"""
import os
import struct
import time

import pytest

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.orderer.broker import Broker, BrokerChain
from fabric_mod_tpu_torch.orderer.consensus import SoloChain
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

CHANNEL = "bchan"


def _material(seed=51, channel=CHANNEL, **batch):
    batch.setdefault("max_message_count", 3)
    batch.setdefault("batch_timeout", "150ms")
    return fixtures.make_network_material(
        seed, channel, consensus_type="kafka", orderers=2, **batch)


def _env(client, k, channel=CHANNEL):
    ch = protoutil.make_channel_header(
        m.HeaderType.ENDORSER_TRANSACTION, channel, tx_id=f"broker-{k}")
    sh = protoutil.make_signature_header(client.serialize(),
                                         protoutil.new_nonce())
    return protoutil.sign_envelope(
        protoutil.make_payload(ch, sh, b"key%d" % k), client)


def _registrar(path, mat, broker, oid="orderer0"):
    csp = sw.SwCSP()
    reg = Registrar(str(path), _signer(csp, mat.consenters[oid]), csp,
                    consenters={"kafka":
                                lambda sup: BrokerChain(broker, sup)})
    if reg.get_chain(CHANNEL) is None:
        reg.create_channel(m.Block.decode(mat.genesis))
    return reg


def _txs(store):
    return sum(len(store.get_block_by_number(n).data.data)
               for n in range(1, store.height))


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _headers(store):
    return [protoutil.block_header_hash(store.get_block_by_number(n).header)
            for n in range(store.height)]


def _reference_chain_headers(tmp_path, mat, envs):
    """The reference's BrokerChain over its own broker, fed the same
    envelopes: its store's header hashes."""
    from cryptography import x509 as jx509
    from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
    from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
    from fabric_mod_tpu.orderer.broker import Broker as JBroker
    from fabric_mod_tpu.orderer.broker import BrokerChain as JBrokerChain
    from fabric_mod_tpu.orderer.registrar import Registrar as JRegistrar
    from fabric_mod_tpu.protos import messages as jm
    from fabric_mod_tpu.protos import protoutil as jprotoutil
    mspid, cert_pem, key_pem = mat.consenters["orderer0"]
    jcsp = JSwCSP()
    jbroker = JBroker()
    jreg = JRegistrar(
        str(tmp_path / "ref"),
        JSigner(mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem,
                jcsp), jcsp,
        chain_factory=lambda sup: JBrokerChain(jbroker, sup))
    try:
        sup = jreg.create_channel(jm.Block.decode(mat.genesis))
        for env in envs:
            sup.chain.order(jm.Envelope.decode(env.encode()), 0)
        _wait(lambda: _txs(sup.store) == len(envs))
        return [jprotoutil.block_header_hash(
            sup.store.get_block_by_number(n).header)
            for n in range(sup.store.height)]
    finally:
        jreg.close()


def test_two_consumers_cut_identical_blocks_and_equal_the_reference(
        tmp_path):
    # a batch timeout long enough that only the last envelope waits for
    # the time-to-cut message, however slowly the consumers run
    mat = _material(batch_timeout="1s")
    client = _signer(sw.SwCSP(), mat.client)
    broker = Broker()
    regs = [_registrar(tmp_path / "b0", mat, broker, "orderer0"),
            _registrar(tmp_path / "b1", mat, broker, "orderer1")]
    envs = [_env(client, k) for k in range(7)]
    try:
        sups = [r.get_chain(CHANNEL) for r in regs]
        assert all(isinstance(s.chain, BrokerChain) for s in sups)
        # two size cuts of 3, then one pending envelope a TTC cuts
        for env in envs:
            sups[0].chain.order(env, 0)
        _wait(lambda: all(_txs(s.store) == 7 for s in sups))
        assert [len(sups[0].store.get_block_by_number(n).data.data)
                for n in range(1, sups[0].store.height)] == [3, 3, 1]
        assert _headers(sups[0].store) == _headers(sups[1].store)
        # the offset slot holds the last message each block includes
        # (the TTC at offset 7 stamps the pending envelope's, 6)
        slot = BrokerChain.OFFSET_MD_SLOT
        assert [struct.unpack("<q", sups[0].store.get_block_by_number(
            n).metadata.metadata[slot])[0] for n in (1, 2, 3)] == [2, 5, 6]
        port_headers = _headers(sups[0].store)
    finally:
        for reg in regs:
            reg.close()
    assert _reference_chain_headers(tmp_path, mat, envs) == port_headers


def test_restart_resumes_from_the_offset_and_recuts_nothing(tmp_path):
    mat = _material(52, batch_timeout="1s")
    client = _signer(sw.SwCSP(), mat.client)
    broker = Broker(str(tmp_path / "broker"))
    reg = _registrar(tmp_path / "b0", mat, broker)
    try:
        sup = reg.get_chain(CHANNEL)
        for k in range(6):
            sup.chain.order(_env(client, k), 0)
        _wait(lambda: _txs(sup.store) == 6)
        height, headers = sup.store.height, _headers(sup.store)
    finally:
        reg.close()
        broker.close()
    broker2 = Broker(str(tmp_path / "broker"))
    reg2 = _registrar(tmp_path / "b0", mat, broker2)
    try:
        sup2 = reg2.get_chain(CHANNEL)
        # the tip block stamps offset 5: the chain reads from 6
        assert sup2.chain.consumed == 6
        assert sup2.store.height == height
        sup2.chain.order(_env(client, 99), 0)
        _wait(lambda: sup2.store.height == height + 1)
        # one block of the one new envelope: nothing was cut twice
        assert _txs(sup2.store) == 7
        assert _headers(sup2.store)[:height] == headers
    finally:
        reg2.close()
        broker2.close()


def test_overflow_cut_loses_no_pending_envelope_across_a_restart(tmp_path):
    """A byte-overflow cut writes the OLD batch and keeps the triggering
    envelope pending: the block is stamped with the last INCLUDED
    offset, so a restart consumes the pending envelope again."""
    client_mat = _material(53)
    client = _signer(sw.SwCSP(), client_mat.client)
    env_len = len(_env(client, 0).encode())
    mat = _material(53, max_message_count=50, batch_timeout="30s",
                    preferred_max_bytes=int(env_len * 2.5))
    broker = Broker(str(tmp_path / "broker"))
    reg = _registrar(tmp_path / "ord", mat, broker)
    sup = reg.get_chain(CHANNEL)
    # e0, e1 fit; e2 overflows: [e0, e1] is cut, e2 stays pending
    for k in range(3):
        sup.chain.order(_env(client, k), 0)
    _wait(lambda: sup.store.height == 2)
    assert len(sup.store.get_block_by_number(1).data.data) == 2
    reg.close()                       # a crash with e2 pending
    broker.close()
    broker2 = Broker(str(tmp_path / "broker"))
    reg2 = _registrar(tmp_path / "ord", mat, broker2)
    try:
        sup2 = reg2.get_chain(CHANNEL)
        sup2.chain.order(_env(client, 3), 0)
        sup2.chain.order(_env(client, 4), 0)
        _wait(lambda: _txs(sup2.store) >= 4)
        ids = [protoutil.envelope_channel_header(
            m.Envelope.decode(raw)).tx_id
            for n in range(1, sup2.store.height)
            for raw in sup2.store.get_block_by_number(n).data.data]
        assert len(ids) == len(set(ids))
        assert {"broker-0", "broker-1", "broker-2", "broker-3"} <= set(ids)
    finally:
        reg2.close()
        broker2.close()


def test_registrar_selects_the_consenter_by_consensus_type(tmp_path):
    kafka = _material(54, channel="kchan")
    solo = fixtures.make_network_material(54, "schan")
    csp = sw.SwCSP()
    broker = Broker()
    reg = Registrar(str(tmp_path / "ord"), _signer(csp, solo.orderer), csp,
                    consenters={"kafka":
                                lambda sup: BrokerChain(broker, sup)})
    try:
        sup_k = reg.create_channel(m.Block.decode(kafka.genesis))
        sup_s = reg.create_channel(m.Block.decode(solo.genesis))
        assert isinstance(sup_k.chain, BrokerChain)
        assert isinstance(sup_s.chain, SoloChain)
    finally:
        reg.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_topic_files_cross_between_the_packages(tmp_path, writer):
    """One package appends, the other opens the topic: the same messages
    at the same offsets, and the same bytes on disk; a torn tail is
    cropped and truncated alike."""
    from fabric_mod_tpu.orderer import broker as jbroker
    from fabric_mod_tpu_torch.orderer import broker as pbroker
    w, r = (pbroker, jbroker) if writer == "port" else (jbroker, pbroker)
    mat = _material(55)
    client = _signer(sw.SwCSP(), mat.client)
    msgs = [w._encode(w._NORMAL, _env(client, k).encode(), k % 2)
            for k in range(5)]
    msgs.append(w._encode(w._TTC, b"", 3))
    msgs.append(w._encode(w._CONFIG, b"cfg", 1))
    wdir, other = str(tmp_path / "w"), str(tmp_path / "other")
    b = w.Broker(wdir)
    assert [b.append(CHANNEL, x) for x in msgs] == list(range(len(msgs)))
    b.close()
    b = r.Broker(other)
    for x in msgs:
        b.append(CHANNEL, x)
    b.close()
    path = os.path.join(wdir, CHANNEL + ".topic")
    with open(path, "rb") as f:
        written = f.read()
    with open(os.path.join(other, CHANNEL + ".topic"), "rb") as f:
        assert f.read() == written
    # a torn frame: a header promising more bytes than follow
    with open(path, "ab") as f:
        f.write(struct.pack("<II", 100, 0) + b"torn")
    got = r.Broker(wdir)
    try:
        assert got.read(CHANNEL, 0, timeout_s=0) == list(enumerate(msgs))
        assert [r._decode(x) for _i, x in got.read(CHANNEL, 0, 0)] == \
            [w._decode(x) for x in msgs]
    finally:
        got.close()
    with open(path, "rb") as f:
        assert f.read() == written
