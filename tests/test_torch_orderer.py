"""The ordering service, port against reference: both packages'
Registrars are created from the same genesis block bytes (the port's
seeded fixture, `max_message_count=8`, a 60 s batch timeout, so blocks
cut on count alone), and the same envelopes go through both
`Broadcast.submit`s.  The blocks both solo chains cut must hold the
same data and have the same header hashes; the Writers check must
reject the same envelopes (a non-member's, a tampered signature, a
wrong channel); and each package's MCS must accept the other's blocks
(the orderer signatures differ in bytes — ECDSA nonces — not in
validity).  Everything verifies on the host."""
import pytest

from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.orderer import (
    Broadcast as JBroadcast, BroadcastError as JBroadcastError,
    DeliverService as JDeliverService, Registrar as JRegistrar)
from fabric_mod_tpu.peer.mcs import MessageCryptoService as JMcs
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil
from cryptography import x509 as jx509

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.orderer import (
    Broadcast, BroadcastError, DeliverService, Registrar)
from fabric_mod_tpu_torch.peer.mcs import MessageCryptoService
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

CHANNEL = "ordchannel"
N_TX = 16


def _ref_signer(pems):
    mspid, cert_pem, key_pem = pems
    return JSigner(mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem,
                   JSwCSP())


def _envelopes(mat):
    """(envelope bytes, accepted) in submission order: N_TX valid
    2-of-3 endorsed puts, with a non-member's, a tampered and a
    wrong-channel envelope planted among them."""
    csp = sw.SwCSP()
    client = _signer(csp, mat.client)
    peers = [_signer(csp, p) for p in mat.peers.values()]
    outsider_ca = calib.CA("ca.outsider", "Org1", seed=b"outsider",
                           now=fixtures.CERT_EPOCH)
    cert, key = outsider_ca.issue("client@outsider", "Org1", ous=["client"])
    outsider = _signer(csp, ("Org1", cert.pem(), calib.key_pem(key)))

    def tx(signer, i, channel=CHANNEL):
        rw = RWSetBuilder()
        rw.add_write("mycc", f"k{i}", b"v%d" % i)
        return protoutil.create_signed_tx(
            channel, "mycc", rw.build().encode(), signer,
            [peers[i % 3], peers[(i + 1) % 3]])
    out = []
    for i in range(N_TX):
        if i == 3:
            out.append((tx(outsider, 100).encode(), False))
        if i == 6:
            env = tx(client, 101)
            out.append((m.Envelope(payload=env.payload, signature=fixtures
                                   ._flip(env.signature)).encode(), False))
        if i == 9:
            out.append((tx(client, 102, channel="elsewhere").encode(), False))
        out.append((tx(client, i).encode(), True))
    return out


@pytest.fixture()
def registrars(tmp_path):
    mat = fixtures.make_network_material(
        3, channel_id=CHANNEL, max_message_count=8, batch_timeout="60s")
    reg = Registrar(str(tmp_path / "port"), _signer(sw.SwCSP(), mat.orderer),
                    sw.SwCSP())
    jreg = JRegistrar(str(tmp_path / "ref"), _ref_signer(mat.orderer),
                      JSwCSP())
    support = reg.create_channel(m.Block.decode(mat.genesis))
    jsupport = jreg.create_channel(jm.Block.decode(mat.genesis))
    yield mat, (reg, support), (jreg, jsupport)
    reg.close()
    jreg.close()


def test_same_envelopes_cut_the_same_blocks(registrars):
    mat, (reg, support), (jreg, jsupport) = registrars
    bc, jbc = Broadcast(reg), JBroadcast(jreg)
    accepted, jaccepted = [], []
    for raw, ok in _envelopes(mat):
        try:
            bc.submit(m.Envelope.decode(raw))
            accepted.append(True)
        except BroadcastError:
            accepted.append(False)
        try:
            jbc.submit(jm.Envelope.decode(raw))
            jaccepted.append(True)
        except JBroadcastError:
            jaccepted.append(False)
        assert accepted[-1] == jaccepted[-1] == ok
    assert accepted.count(False) == 3

    n_blocks = N_TX // 8
    blocks = list(DeliverService(support).blocks(1, stop=n_blocks,
                                                  timeout_s=30))
    jblocks = list(JDeliverService(jsupport).blocks(1, stop=n_blocks,
                                                    timeout_s=30))
    assert len(blocks) == len(jblocks) == n_blocks
    for b, jb in zip(blocks, jblocks):
        assert len(b.data.data) == 8
        assert [bytes(d) for d in b.data.data] == \
            [bytes(d) for d in jb.data.data]
        assert protoutil.block_header_hash(b.header) == \
            jprotoutil.block_header_hash(jb.header)

    # each package's MCS accepts the other's orderer signatures
    _, cfg = config_from_block(m.Block.decode(mat.genesis))
    bundle = Bundle(CHANNEL, cfg, sw.SwCSP())
    jbundle = JBundle(CHANNEL, j_cfb(jm.Block.decode(mat.genesis))[1],
                      JSwCSP())
    mcs, jmcs = MessageCryptoService(lambda: bundle), JMcs(lambda: jbundle)
    for b, jb in zip(blocks, jblocks):
        mcs.verify_block(CHANNEL, m.Block.decode(jb.encode()))
        jmcs.verify_block(CHANNEL, jm.Block.decode(b.encode()))
        mcs.verify_block(CHANNEL, b)
