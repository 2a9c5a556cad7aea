"""The port's deliver fan-out (peer/fanout.py), its commit notifier
(ledger/notifier.py), the filtered-action scanner
(protos/batchdecode.decode_filtered_actions) and the ACL provider
(peer/aclmgmt.py), against the reference on the same inputs.

- Frames: `filtered_block` and `encode_frame` (both forms, `batch` True
  and False) byte-equal to the reference's on the same blocks — the
  fan-out cell's chain (`fixtures.make_fanout_chain`), an adversarial
  chain (the reference tests' shape: events, event-less, multi-action,
  absent and empty actions, malformed bodies, CONFIG and MESSAGE txs)
  and a block-commit fixture block — each side decoding the other's
  frame.
- The scanner under seeded mutation against the reference's, and sound
  against the per-tx projection (reference tests/test_fanout.py:170).
- The ring, the notifier, the ACL groups and the config memo (the
  reference's cases of tests/test_fanout.py, on the port; its fault-point
  case becomes a failing ledger read, since the port has no fault
  points).
- `ACLProvider` on a real channel Bundle through `sw.SwVerifier`, with
  the reference's provider on the same signed data.
"""
import random
import threading
import time

import pytest
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.peer import aclmgmt as jaclmgmt
from fabric_mod_tpu.peer import fanout as jfanout
from fabric_mod_tpu.protos import batchdecode as jbatchdecode
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos.protoutil import SignedData as JSignedData

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.ledger.notifier import CommitNotifier
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.peer.aclmgmt import ACLError, ACLProvider
from fabric_mod_tpu_torch.peer.fanout import (AclGroups, FanoutEngine,
                                              _ConfigMemo, _filtered_actions,
                                              encode_frame, filtered_block)
from fabric_mod_tpu_torch.protos import batchdecode
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.protos.protoutil import SignedData
from fabric_mod_tpu_torch.utils import fixtures

CH = "fanout-ch"
V = m.TxValidationCode
SEED = 17


# ---------------------------------------------------------------------------
# An adversarial chain (the reference tests' shape, built with the port)
# ---------------------------------------------------------------------------

def _tx_bytes(txid, event_name=None, event_payload=b"secret",
              nactions=1, no_action=False, empty_action=False):
    actions = []
    for _ in range(nactions):
        if no_action:
            cap = m.ChaincodeActionPayload()
        elif empty_action:
            cap = m.ChaincodeActionPayload(
                action=m.ChaincodeEndorsedAction())
        else:
            ev = b""
            if event_name is not None:
                ev = m.ChaincodeEvent(chaincode_id="cc", tx_id=txid,
                                      event_name=event_name,
                                      payload=event_payload).encode()
            cca = m.ChaincodeAction(results=b"rw", events=ev)
            prp = m.ProposalResponsePayload(proposal_hash=b"h",
                                            extension=cca.encode())
            cap = m.ChaincodeActionPayload(
                chaincode_proposal_payload=b"cpp",
                action=m.ChaincodeEndorsedAction(
                    proposal_response_payload=prp.encode(),
                    endorsements=[m.Endorsement(endorser=b"e",
                                                signature=b"s")]))
        actions.append(m.TransactionAction(header=b"sh",
                                           payload=cap.encode()))
    return m.Transaction(actions=actions).encode()


def _env(txid, htype=m.HeaderType.ENDORSER_TRANSACTION, data=b""):
    ch = protoutil.make_channel_header(htype, CH, tx_id=txid)
    sh = protoutil.make_signature_header(b"creator", protoutil.new_nonce())
    payload = protoutil.make_payload(ch, sh, data)
    return m.Envelope(payload=payload.encode(), signature=b"sig")


def _mk_block(num, envs, prev=b"\x00" * 32):
    blk = protoutil.new_block(num, prev, envs)
    protoutil.set_block_txflags(
        blk, bytes([V.VALID if i % 3 else V.MVCC_READ_CONFLICT
                    for i in range(len(envs))]))
    return blk


def _chain(n, config_at=()):
    blocks = []
    for b in range(n):
        if b in config_at:
            envs = [_env(f"cfg-{b}", htype=m.HeaderType.CONFIG,
                         data=b"new-config")]
        else:
            envs = [
                _env(f"t{b}-ev", data=_tx_bytes(f"t{b}-ev",
                                                event_name="moved")),
                _env(f"t{b}-plain", data=_tx_bytes(f"t{b}-plain")),
                _env(f"t{b}-multi", data=_tx_bytes(
                    f"t{b}-multi", event_name="m", nactions=2)),
                _env(f"t{b}-noact", data=_tx_bytes(f"t{b}-noact",
                                                   no_action=True)),
                _env(f"t{b}-empty", data=_tx_bytes(f"t{b}-empty",
                                                   empty_action=True)),
                _env(f"t{b}-bad", data=b"\xff\xff\xff\xff"),
                _env(f"t{b}-msg", htype=m.HeaderType.MESSAGE,
                     data=b"not a tx"),
            ]
        blocks.append(_mk_block(b, envs))
    return blocks


def _commit_fixture_block():
    world = fixtures.make_commit_world(seed=b"fanout")
    raw, _ = fixtures.make_commit_blocks(world, 1, 16, plant_every=16)
    return m.Block.decode(raw[0])


class _Ledger:
    """Ledger-shaped fake: height, height_changed, get_block_by_number,
    the commit notified outside any store lock (the kvledger order)."""

    def __init__(self, blocks, revealed=None):
        self._blocks = list(blocks)
        self._revealed = len(blocks) if revealed is None else revealed
        self.height_changed = threading.Condition()
        self.fail_reads = 0

    @property
    def height(self):
        return self._revealed

    def get_block_by_number(self, num):
        if self.fail_reads:
            self.fail_reads -= 1
            raise OSError("block store read failed")
        if 0 <= num < self._revealed:
            return self._blocks[num]
        return None

    def reveal(self, n=1):
        self._revealed = min(len(self._blocks), self._revealed + n)
        with self.height_changed:
            self.height_changed.notify_all()


class _SeqAcl:
    """A counting ACL whose verdict depends only on (creator, sequence),
    the real provider's shape."""

    def __init__(self):
        self.seq = 0
        self.checks = 0
        self.deny = False

    def config_sequence(self):
        return self.seq

    def check_acl(self, resource, sds):
        self.checks += 1
        if self.deny:
            raise PermissionError("revoked")


# ---------------------------------------------------------------------------
# Frames: port against reference, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["fanout", "adversarial", "commit"])
def test_frames_equal_reference_both_ways(chain):
    if chain == "fanout":
        blocks = fixtures.make_fanout_chain(CH)
        assert len(blocks) == fixtures.FANOUT_BLOCKS
    elif chain == "adversarial":
        blocks = _chain(6, config_at=(3,))
    else:
        blocks = [_commit_fixture_block()]
    for blk in blocks:
        jblk = jm.Block.decode(blk.encode())
        assert jfanout._is_config_block(jblk) == \
            (chain != "commit" and blk.header.number in
             ((fixtures.FANOUT_CONFIG_AT,) if chain == "fanout" else (3,)))
        got = filtered_block(CH, blk, batch=True).encode()
        assert got == filtered_block(CH, blk, batch=False).encode()
        assert got == jfanout.filtered_block(CH, jblk).encode()
        for form in ("full", "filtered"):
            for batch in (True, False):
                frame = encode_frame(CH, form, blk, batch=batch)
                jframe = jfanout.encode_frame(CH, form, jblk, batch=batch)
                assert frame == jframe, (blk.header.number, form, batch)
                # each side decodes the other's frame
                assert jm.DeliverResponse.decode(frame).encode() == frame
                assert m.DeliverResponse.decode(jframe).encode() == jframe


def test_malformed_endorsement_frame_follows_the_per_tx_projection():
    """A tx whose only fault is inside an endorsement: the port's batch
    frame equals its per-tx frame and the reference's per-tx frame (the
    reference's batch frame does not: its scanner skips endorsements)."""
    good = _tx_bytes("e-ok", event_name="evt")
    bad = good.replace(b"\x12\x01s", b"\x12\x05s")   # signature overruns
    assert bad != good
    envs = [_env(f"t{i}", data=good) for i in range(3)]
    envs.append(_env("t-bad", data=bad))
    blk = _mk_block(1, envs)
    jblk = jm.Block.decode(blk.encode())
    frame = encode_frame(CH, "filtered", blk)
    assert frame == encode_frame(CH, "filtered", blk, batch=False)
    assert frame == jfanout.encode_frame(CH, "filtered", jblk, batch=False)
    assert frame != jfanout.encode_frame(CH, "filtered", jblk, batch=True)


def test_fanout_chain_shape():
    """Three one-action endorser txs with events and one two-action tx a
    block (the scanner's fallback row), the CONFIG block in the middle."""
    blocks = fixtures.make_fanout_chain(CH)
    for blk in blocks:
        fb = filtered_block(CH, blk, batch=False)
        if blk.header.number == fixtures.FANOUT_CONFIG_AT:
            assert [t.type for t in fb.filtered_transactions] == \
                [m.HeaderType.CONFIG]
            continue
        envs = protoutil.get_envelopes(blk)
        datas = [protoutil.unmarshal_envelope_payload(e).data for e in envs]
        rows = batchdecode.decode_filtered_actions(datas)
        assert [r is None for r in rows] == [False, False, False, True]
        assert [len(t.transaction_actions.chaincode_actions)
                for t in fb.filtered_transactions] == [1, 1, 1, 2]
        for t in fb.filtered_transactions:
            for a in t.transaction_actions.chaincode_actions:
                assert a.chaincode_event.event_name == "moved"
                assert a.chaincode_event.payload == b""


def test_decode_filtered_actions_equals_reference_under_mutation():
    """Seeded mutations, truncations and bad UTF-8: the port's scanner
    returns what the reference's does row for row; where it returns a
    value it equals the per-tx projection, and where the per-tx decode
    raises it returned None."""
    rng = random.Random(SEED)
    base = _tx_bytes("fuzz", event_name="evt", event_payload=b"p" * 40)
    cases = [base]
    for i in range(0, len(base), 3):
        mutated = bytearray(base)
        mutated[i] ^= 0xFF
        cases.append(bytes(mutated))
    for _ in range(60):
        mutated = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        cases.append(bytes(mutated))
    for i in range(1, 24):
        cases.append(base[:i])                     # truncations
    ev = m.ChaincodeEvent(chaincode_id="cc", tx_id="x",
                          event_name="n").encode().replace(b"cc", b"\xff\xfe")
    cca = m.ChaincodeAction(events=ev)
    prp = m.ProposalResponsePayload(extension=cca.encode())
    cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
        proposal_response_payload=prp.encode()))
    cases.append(m.Transaction(actions=[m.TransactionAction(
        payload=cap.encode())]).encode())
    # one batch (the scanner skips batches under 4 rows), with None rows
    rows = cases + [None, _tx_bytes("a", nactions=2), b""]
    got = batchdecode.decode_filtered_actions(rows)
    want = jbatchdecode.decode_filtered_actions(rows)
    accepted = unsound = 0
    for txb, row, jrow in zip(rows, got, want):
        if txb is None:
            assert row is None and jrow is None
            continue
        try:
            per_tx = _filtered_actions(txb).encode()
        except Exception:
            per_tx = None
            assert row is None, "scanner claimed a row the decoder rejects"
        if row is not None:
            accepted += 1
            assert row.encode() == per_tx == jrow.encode()
        elif jrow is not None and per_tx is None:
            # the reference's scanner skips what the per-tx decode
            # parses (an endorsement's body here) and claims the row
            unsound += 1
        else:
            assert jrow is None or jrow.encode() == per_tx
    assert accepted > 1
    # the seeded mutations reach the endorsement the reference skips
    assert unsound > 0


# ---------------------------------------------------------------------------
# The ring: materialize once, mixed subscribers, the tail fallback
# ---------------------------------------------------------------------------

def test_ring_materializes_once_for_mixed_subscribers():
    blocks = _chain(8, config_at=(5,))
    led = _Ledger(blocks, revealed=0)
    eng = FanoutEngine(CH, led, _SeqAcl(), ring_size=64)
    try:
        for form in ("full", "filtered"):
            eng.attach(form)
            eng.attach(form)      # two subscribers per form
        led._revealed = len(blocks)
        eng._on_commit(led.height)    # the notifier thread's call
        for form in ("full", "filtered"):
            for start in (0, 5):       # 5 = joining mid-chain
                for num in range(start, led.height):
                    fr = eng.get_frame(form, num)
                    assert fr.payload == encode_frame(CH, form, blocks[num],
                                                      batch=False)
                    assert fr.is_config == (num == 5)
        for form in ("full", "filtered"):
            st = eng.stats[form]
            assert st["materialized"] == len(blocks)
            assert st["encoded"] == len(blocks)
            assert st["fallbacks"] == 0
            assert st["ring_hits"] == len(blocks) + 3
    finally:
        eng.close()


def test_idle_form_skips_eager_materialization():
    led = _Ledger(_chain(3))
    eng = FanoutEngine(CH, led, _SeqAcl(), ring_size=8)
    try:
        eng.attach("filtered")
        eng._on_commit(led.height)
        assert eng.stats["filtered"]["materialized"] == 3
        assert eng.stats["full"]["materialized"] == 0
    finally:
        eng.close()


def test_slow_subscriber_past_ring_tail_falls_back_counted():
    blocks = _chain(12)
    led = _Ledger(blocks)
    eng = FanoutEngine(CH, led, _SeqAcl(), ring_size=4)
    try:
        eng.attach("filtered")
        eng._on_commit(led.height)
        st = eng.stats["filtered"]
        assert st["materialized"] == 4          # only the ring window
        for _ in range(2):
            fr = eng.get_frame("filtered", 0)
            assert fr.payload == encode_frame(CH, "filtered", blocks[0],
                                              batch=False)
        assert st["fallbacks"] == 2             # counted, never inserted
        assert st["materialized"] == 4
        assert eng.get_frame("filtered", 11) is not None
        assert st["ring_hits"] >= 1
    finally:
        eng.close()


def test_failed_read_kills_one_stream_not_the_ring():
    """A stream whose past-the-tail re-read fails gets the error (no
    fallback answer); the ring and every other stream keep serving."""
    blocks = _chain(6)
    led = _Ledger(blocks)
    eng = FanoutEngine(CH, led, _SeqAcl(), ring_size=4)
    try:
        eng.attach("full")
        eng._on_commit(led.height)
        led.fail_reads = 1
        with pytest.raises(OSError):
            eng.get_frame("full", 0)           # stream B dies
        for num in range(len(blocks)):         # A (and any C) go on
            fr = eng.get_frame("full", num)
            assert fr.payload == encode_frame(CH, "full", blocks[num],
                                              batch=False)
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# CommitNotifier: wake exactness, cancellation and close
# ---------------------------------------------------------------------------

def _until(pred, t=5.0):
    deadline = time.time() + t
    while not pred() and time.time() < deadline:
        time.sleep(0.01)
    return pred()


def test_notifier_wakes_exactly_per_commit_and_never_idle():
    led = _Ledger(_chain(5), revealed=0)
    nt = CommitNotifier(led.height_changed, lambda: led.height,
                        name="t-exact")
    try:
        w1, w2 = nt.waiter(), nt.waiter()
        led.reveal()
        assert nt.wait_above(-1, w1, timeout_s=5.0) == "commit"
        assert nt.wait_above(-1, w2, timeout_s=5.0) == "commit"
        assert _until(lambda: w1.wakes >= 1 and w2.wakes >= 1)
        base1, base2 = w1.wakes, w2.wakes
        time.sleep(0.25)                       # idle: no wakes
        assert (w1.wakes, w2.wakes) == (base1, base2)
        for i in range(1, 4):                  # one wake per commit
            led.reveal()
            assert _until(lambda: w1.wakes - base1 >= i
                          and w2.wakes - base2 >= i)
            assert w1.wakes - base1 == i
            assert w2.wakes - base2 == i
        assert nt.wait_above(3, w1, timeout_s=5.0) == "commit"
        assert nt.errors == []
    finally:
        nt.close()


def test_notifier_cancellation_and_close_unpark_promptly():
    led = _Ledger(_chain(2), revealed=2)
    nt = CommitNotifier(led.height_changed, lambda: led.height,
                        name="t-cancel")
    try:
        w = nt.waiter()
        res = {}

        def park(key, waiter):
            res[key] = nt.wait_above(10, waiter)    # untimed park

        t = threading.Thread(target=park, args=("a", w), daemon=True)
        t.start()
        time.sleep(0.05)
        w.cancel()                             # the stream's cancel hook
        t.join(timeout=5.0)
        assert not t.is_alive() and res["a"] == "cancelled"
        nt.release(w)
        w2 = nt.waiter()
        t2 = threading.Thread(target=park, args=("b", w2), daemon=True)
        t2.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        nt.close()
        t2.join(timeout=5.0)
        assert not t2.is_alive() and res["b"] == "closed"
        assert time.monotonic() - t0 < 2.0     # no tick to wait out
    finally:
        nt.close()


def test_notifier_runs_callbacks_before_waking_and_keeps_their_errors():
    led = _Ledger(_chain(3), revealed=0)
    nt = CommitNotifier(led.height_changed, lambda: led.height)
    seen = []
    try:
        w = nt.waiter()
        nt.on_commit(lambda h: seen.append((h, w.wakes)))

        def boom(h):
            raise RuntimeError(f"materialize failed at {h}")
        nt.on_commit(boom)
        led.reveal()
        assert _until(lambda: w.wakes == 1)
        assert seen == [(1, 0)]                # ran before the wake
        assert [str(e) for e in nt.errors] == ["materialize failed at 1"]
    finally:
        nt.close()


def test_engine_over_a_committing_ledger_materializes_before_waking():
    """KvLedger.height_changed drives the engine: after each commit the
    notifier materializes the block's frame before it wakes the stream,
    and the frame is the committed block's (its txflags set)."""
    world = fixtures.make_commit_world(seed=b"fanout")
    raw, _ = fixtures.make_commit_blocks(world, 3, 16, plant_every=16)
    committer = world.committer(sw.SwVerifier())
    ledger = committer.ledger
    eng = FanoutEngine(world.channel_id, ledger, _SeqAcl(), ring_size=8)
    try:
        eng.attach("filtered")
        w = eng.notifier.waiter()
        for num, blob in enumerate(raw):
            t = threading.Thread(target=committer.store_block,
                                 args=(m.Block.decode(blob),))
            t.start()
            assert eng.notifier.wait_above(num - 1, w, timeout_s=60.0) == \
                "commit"
            t.join(timeout=60.0)
            assert _until(lambda: w.wakes >= num + 1)
            assert eng.stats["filtered"]["materialized"] == num + 1
            fr = eng.get_frame("filtered", num)
            assert fr.payload == encode_frame(
                world.channel_id, "filtered", ledger.get_block_by_number(num),
                batch=False)
        assert eng.stats["filtered"]["fallbacks"] == 0
        assert eng.stats["full"]["materialized"] == 0
        assert eng.notifier.errors == []
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# Batched session ACLs: once per (group, key), fail-closed fan-out
# ---------------------------------------------------------------------------

def _sd(identity=b"alice"):
    return SignedData(data=b"d", identity=identity, signature=b"s")


def test_group_recheck_fires_once_per_config_sequence_advance():
    acl = _SeqAcl()
    groups = AclGroups(acl, CH)
    sessions = [groups.join("event/FilteredBlock", _sd(), acl.seq)
                for _ in range(10)]
    for s in sessions:
        s.recheck()                      # sequence unmoved: no-ops
    assert acl.checks == 0
    acl.seq = 1
    for s in sessions:
        s.recheck()
    assert acl.checks == 1               # one evaluation, 10 verdicts
    assert groups.stats == {"checks": 1, "reuses": 9}
    for s in sessions:
        s.recheck()
    assert acl.checks == 1


def test_forced_config_recheck_once_per_block_and_fails_closed():
    acl = _SeqAcl()
    groups = AclGroups(acl, CH)
    sessions = [groups.join("event/Block", _sd(), acl.seq)
                for _ in range(6)]
    acl.seq = 1
    acl.deny = True
    for s in sessions:
        with pytest.raises(PermissionError):
            s.recheck(force=True, config_mark=7)
    assert acl.checks == 1               # the deny is fanned, not re-run
    acl.deny = False
    acl.seq = 2
    for s in sessions:
        s.recheck(force=True, config_mark=9)
    assert acl.checks == 2


def test_groups_split_by_identity_and_resource():
    acl = _SeqAcl()
    groups = AclGroups(acl, CH)
    sa = groups.join("event/Block", _sd(b"alice"), acl.seq)
    sb = groups.join("event/Block", _sd(b"bob"), acl.seq)
    sc = groups.join("event/FilteredBlock", _sd(b"alice"), acl.seq)
    acl.seq = 1
    for s in (sa, sb, sc):
        s.recheck()
    assert acl.checks == 3 == len(groups)


def test_sequenceless_provider_disables_verdict_caching():
    class _Acl:
        def __init__(self):
            self.checks = 0
            self.deny = False

        def check_acl(self, resource, sds):
            self.checks += 1
            if self.deny:
                raise PermissionError("no")

    acl = _Acl()
    groups = AclGroups(acl, CH)
    s1 = groups.join("event/Block", _sd(), None)
    s2 = groups.join("event/Block", _sd(), None)
    acl.deny = True
    with pytest.raises(PermissionError):
        s1.recheck(force=True, config_mark=3)
    acl.deny = False
    s2.recheck(force=True, config_mark=3)     # not poisoned by s1's deny
    assert acl.checks == 2


def test_config_memo_lru_bounded_and_stable():
    blocks = _chain(20, config_at=(7,))
    memo = _ConfigMemo(cap=8)
    for blk in blocks:
        memo.classify(blk)
    assert len(memo) == 8
    assert memo.classify(blocks[7]) is True
    assert memo.classify(blocks[6]) is False
    assert len(memo) == 8


# ---------------------------------------------------------------------------
# ACLProvider on a real channel bundle, against the reference's provider
# ---------------------------------------------------------------------------

def test_acl_provider_on_a_real_bundle_equals_reference():
    mat = fixtures.make_network_material(SEED, channel_id=CH)
    cid, config = config_from_block(m.Block.decode(mat.genesis))
    jcid, jconfig = j_cfb(jm.Block.decode(mat.genesis))
    csp, jcsp = sw.SwCSP(), JSwCSP()
    bundles = [Bundle(cid, config, csp)]
    jbundle = JBundle(jcid, jconfig, jcsp)
    verifier = sw.SwVerifier()
    calls = []

    def verify_many(items):
        calls.append(len(items))
        return verifier.verify_many(items)
    acl = ACLProvider(lambda: bundles[-1], verify_many)
    jacl = jaclmgmt.ACLProvider(lambda: jbundle)

    signers = [(mat.client, True), (mat.peers["Org2"], True),
               (mat.orderer, False)]
    data = b"seek-info"
    cases = []
    for (mspid, cert, key), ok in signers:
        ident = SigningIdentity(mspid, deserialize_cert(cert), key, csp)
        sig = ident.sign_message(data)
        cases.append(((ident.serialize(), sig), ok))
        bad = bytearray(sig)
        bad[-1] ^= 1
        cases.append(((ident.serialize(), bytes(bad)), False))
    for resource in ("event/Block", "event/FilteredBlock", "peer/Propose"):
        for (ident, sig), ok in cases:
            sd = SignedData(data=data, identity=ident, signature=sig)
            jsd = JSignedData(data=data, identity=ident, signature=sig)
            try:
                jacl.check_acl(resource, [jsd])
                want = True
            except jaclmgmt.ACLError:
                want = False
            try:
                acl.check_acl(resource, [sd])
                got = True
            except ACLError:
                got = False
            assert got == want, (resource, ok)
            if resource != "peer/Propose":
                assert got == ok
    assert calls and all(n >= 1 for n in calls)
    # fail-closed: an unmapped resource, a mapping to a missing policy
    sd = SignedData(data=data, identity=cases[0][0][0],
                    signature=cases[0][0][1])
    with pytest.raises(ACLError, match="no ACL policy"):
        acl.check_acl("nope/Nothing", [sd])
    with pytest.raises(ACLError, match="not in channel config"):
        ACLProvider(lambda: bundles[-1], verify_many,
                    {"event/Block": "/Channel/Application/Nobody"}
                    ).check_acl("event/Block", [sd])
    # the sequence is read through bundle_fn on every call
    assert acl.config_sequence() == jacl.config_sequence() == config.sequence
    moved = m.Config.decode(config.encode())
    moved.sequence = config.sequence + 1
    bundles.append(Bundle(cid, moved, csp))
    assert acl.config_sequence() == config.sequence + 1
    # the fan-out's groups over it: one check for three members
    groups = AclGroups(acl, CH)
    sessions = [groups.join("event/Block", sd, config.sequence)
                for _ in range(3)]
    for s in sessions:
        s.recheck()
    assert groups.stats == {"checks": 1, "reuses": 2}
