"""The end-to-end differential both e2e test files run: the JAX
package's `Network` and the port's `Network`, built from the same
material, order and commit the same envelopes.

The reference network is built first (its own CAs and genesis, its
FakeBatchVerifier(SwCSP()) on the host, tensor policy and the commit
pipeline knob off, so no XLA compile); `convert.network_material_from_
reference` carries its certificates, keys and genesis block across as
bytes.  Both order in blocks of 8 on count (a 60 s batch timeout).

The stream, endorsed up front against empty state, alternating the
port's and the reference's endorsers tx by tx, so envelopes of both
packages cross into the other:

  block 1 (8 txs)     put, put, put endorsed by one org only, put with
                      one endorsement's signature flipped after
                      endorsing, get of the key tx 0 writes, tx 0
                      resubmitted, a setvp pin (a barrier), put; and a
                      tampered creator signature that both Broadcasts
                      reject
  block 2 (config)    the reference's config update (two org admins)
                      turning /Channel/Application/Endorsement from
                      MAJORITY to ANY: a barrier, and a bundle swap on
                      both sides of the network
  block 3 (8 txs)     the same kinds, endorsers alternating the other
                      way; under ANY the one-org and the flipped
                      endorsements are VALID
"""
import os

from fabric_mod_tpu.channelconfig import compute_update, signed_update_envelope
from fabric_mod_tpu.channelconfig.configtx import (
    config_from_block as j_config_from_block)
from fabric_mod_tpu.channelconfig.bundle import (
    APPLICATION, groups_of, policies_of, set_group, set_policy)
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.orderer import BroadcastError as JBroadcastError
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.channelconfig import config_from_block
from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.orderer import BroadcastError
from fabric_mod_tpu_torch.policy import from_string
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

V = m.TxValidationCode
BLOCK_TXS = 8
# the key-level endorsement policy the setvp txs pin
PIN_POLICY = m.ApplicationPolicy(
    signature_policy=from_string("OR('Org1.peer')")).encode()


def reference_network(root, monkeypatch):
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE"):
        monkeypatch.delenv(knob, raising=False)
    return JNetwork(os.path.join(root, "ref"), max_message_count=BLOCK_TXS,
                    batch_timeout="60s")


def _endorse(net, pkg_protoutil, args, orgs, flip=None):
    """Endorse `args` on `net` (either package) by `orgs`; `flip`: the
    index of an endorsement whose signature is flipped after
    endorsing.  The envelope's bytes."""
    sp, prop, _ = pkg_protoutil.create_chaincode_proposal(
        net.channel_id, "mycc", args, net.client)
    responses = [net.endorsers[o].process_proposal(sp) for o in orgs]
    if flip is not None:
        e = responses[flip].endorsement
        e.signature = fixtures._flip(e.signature)
    env = pkg_protoutil.create_tx_from_responses(prop, responses, net.client)
    return env.encode()


def _block_stream(nets, blk):
    """(envelope bytes, accepted) of one 8-tx block, and the flags the
    construction expects under MAJORITY and under ANY."""
    def by(i):
        net, pu = nets[(i + blk) % 2]
        return net, pu
    k0 = b"b%dk0" % blk
    out = []
    put = [b"put", k0, b"v"]
    out.append((_endorse(*by(0), put, ("Org1", "Org2")), True))
    out.append((_endorse(*by(1), [b"put", b"b%dk1" % blk, b"v"],
                         ("Org2", "Org3")), True))
    out.append((_endorse(*by(2), [b"put", b"b%dk2" % blk, b"v"],
                         ("Org1",)), True))
    out.append((_endorse(*by(3), [b"put", b"b%dk3" % blk, b"v"],
                         ("Org1", "Org3"), flip=1), True))
    # a tampered creator signature: both Broadcasts reject it
    env = m.Envelope.decode(_endorse(*by(4), [b"put", b"b%dx" % blk, b"v"],
                                     ("Org1", "Org2")))
    out.append((m.Envelope(payload=env.payload,
                           signature=fixtures._flip(env.signature)).encode(),
                False))
    out.append((_endorse(*by(4), [b"get", k0], ("Org1", "Org2")), True))
    out.append((out[0][0], True))
    out.append((_endorse(*by(6), [b"setvp", b"pin%d" % blk, PIN_POLICY],
                         ("Org2", "Org3")), True))
    out.append((_endorse(*by(7), [b"put", b"b%dk7" % blk, b"v"],
                         ("Org1", "Org3")), True))
    majority = [V.VALID, V.VALID, V.ENDORSEMENT_POLICY_FAILURE,
                V.ENDORSEMENT_POLICY_FAILURE, V.MVCC_READ_CONFLICT,
                V.DUPLICATE_TXID, V.VALID, V.VALID]
    anyone = [V.VALID] * 4 + majority[4:]
    return out, majority, anyone


def _any_endorsement_update(ref):
    cur = ref.channel.bundle().config
    desired = jm.ConfigGroup.decode(cur.channel_group.encode())
    app = groups_of(desired)[APPLICATION]
    pol = policies_of(app)["Endorsement"]
    pol.policy = jm.Policy(
        type=jm.PolicyType.IMPLICIT_META,
        value=jm.ImplicitMetaPolicy(sub_policy="Endorsement",
                                    rule=jm.ImplicitMetaRule.ANY).encode())
    set_policy(app, "Endorsement", pol)
    set_group(desired, APPLICATION, app)
    update = compute_update(ref.channel_id, cur, desired)
    return signed_update_envelope(
        ref.channel_id, update,
        [ref.admins["Org1"], ref.admins["Org2"]]).encode()


def _submit_both(ref, port, raw):
    """Submit to both Broadcasts; (port accepted, reference accepted)."""
    got = []
    for submit, decode, err in (
            (port.broadcast.submit, m.Envelope.decode, BroadcastError),
            (ref.broadcast.submit, jm.Envelope.decode, JBroadcastError)):
        try:
            submit(decode(raw))
            got.append(True)
        except err:
            got.append(False)
    return tuple(got)


def run(tmp_path, monkeypatch, verifier, tensor_policy):
    """The whole differential, both networks closed at the end."""
    root = str(tmp_path)
    ref = reference_network(root, monkeypatch)
    port = None
    try:
        port = e2e.Network(os.path.join(root, "port"),
                       material=convert.network_material_from_reference(ref),
                       verifier=verifier, tensor_policy=tensor_policy)
        nets = ((port, protoutil), (ref, jprotoutil))
        block1, want1, _ = _block_stream(nets, 0)
        block3, _, want3 = _block_stream(nets, 1)
        stream = block1 + [(_any_endorsement_update(ref), True)] + block3
        for raw, ok in stream:
            assert _submit_both(ref, port, raw) == (ok, ok)

        # two blocks of txs and the config block; each side's own
        # deliver helper
        n_txs = 2 * BLOCK_TXS + 1
        assert ref.pump_committed(n_txs, timeout=120) == n_txs
        assert e2e.commit_until(port, n_txs, 600)[1] == n_txs
        assert port.ledger.height == ref.ledger.height == 4
        want = [want1, [V.VALID], want3]
        for num, flags in enumerate(want, 1):
            b = port.ledger.get_block_by_number(num)
            jb = ref.ledger.get_block_by_number(num)
            assert list(protoutil.block_txflags(b)) == \
                list(jprotoutil.block_txflags(jb)) == flags
            if num == 2:
                # the orderer wraps the update into a CONFIG envelope of
                # its own (a fresh nonce, its signature): compare the
                # Config it carries; every later header hash differs
                assert config_from_block(b)[1].encode() == \
                    j_config_from_block(jb)[1].encode()
                continue
            assert [bytes(d) for d in b.data.data] == \
                [bytes(d) for d in jb.data.data]
            if num == 1:
                assert protoutil.block_header_hash(b.header) == \
                    jprotoutil.block_header_hash(jb.header)
        assert port.channel.bundle().sequence == \
            ref.channel.bundle().sequence == 1
        assert port.support.bundle().sequence == 1
        assert port.ledger.state_fingerprint() == \
            ref.ledger.state_fingerprint()
    finally:
        if port is not None:
            port.close()
        ref.close()
