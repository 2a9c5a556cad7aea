"""The port's in-process event deliver service (fabric_mod_tpu_torch/
peer/deliverevents.py) against the reference's EventDeliverServer over
gRPC, driven as tests/test_deliverevents.py drives it.

Both servers stand over the same committed chain (the fan-out cell's
chain, `fixtures.make_fanout_chain`, its block 6 a CONFIG block) behind
a real bundle-backed ACLProvider of the seeded network material; each
package signs its seeks with its own SigningIdentity over the same
certificate and key.  The same seeks — full and filtered, bounded,
FAIL_IF_NOT_READY past the tip, the wrong channel, a non-seek
envelope, garbage, a signer outside the channel — must get equal
frames and statuses.  A standing BLOCK_UNTIL_READY subscription of
Org2's peer is cut FORBIDDEN by both at the config block that removes
Org2 from the application group, with the same blocks received before
the cut.  The port's client waits out a deadline with TimeoutError
(the gRPC deadline's stand-in) and learns a tx's validation code with
`wait_for_tx`.
"""
import threading
import time

import pytest
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.comm.grpc_comm import GRPCClient
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.msp.identities import deserialize_cert as j_deser
from fabric_mod_tpu.peer import aclmgmt as jaclmgmt
from fabric_mod_tpu.peer import deliverevents as jde
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import (APPLICATION, Bundle,
                                                config_from_block, groups_of)
from fabric_mod_tpu_torch.channelconfig.bundle import set_group
from fabric_mod_tpu_torch.concurrency import CancellationEvent
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
from fabric_mod_tpu_torch.peer.deliverevents import (
    EventDeliverClient, EventDeliverServer, EventStreamError,
    make_signed_seek_envelope)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

CH = "events-ch"
N_BLOCKS = 12
CONFIG_AT = 6


class _Ledger:
    """Ledger-shaped: height, height_changed, get_block_by_number; the
    commit notified outside any store lock."""

    def __init__(self, blocks, revealed):
        self._blocks = list(blocks)
        self._revealed = revealed
        self.height_changed = threading.Condition()

    @property
    def height(self):
        return self._revealed

    def get_block_by_number(self, num):
        return self._blocks[num] if 0 <= num < self._revealed else None

    def reveal(self, n):
        self._revealed = min(len(self._blocks), self._revealed + n)
        with self.height_changed:
            self.height_changed.notify_all()


@pytest.fixture(scope="module")
def material():
    return fixtures.make_network_material(23, channel_id=CH)


@pytest.fixture()
def world(material):
    genesis = m.Block.decode(material.genesis)
    cid, config = config_from_block(genesis)
    # the revocation: Org2 out of the application group, one sequence on
    desired = m.ConfigGroup.decode(config.channel_group.encode())
    app = groups_of(desired)[APPLICATION]
    app.groups = [e for e in app.groups if e.key != "Org2"]
    set_group(desired, APPLICATION, app)
    revoked = m.Config(sequence=config.sequence + 1, channel_group=desired)
    csp, jcsp = sw.SwCSP(), JSwCSP()
    bundles = [Bundle(cid, config, csp)]
    jbundles = [JBundle(cid, j_cfb(jm.Block.decode(material.genesis))[1],
                        jcsp)]
    chain = fixtures.make_fanout_chain(CH, N_BLOCKS, CONFIG_AT)
    ledger = _Ledger(chain, CONFIG_AT)
    jledger = _Ledger([jm.Block.decode(b.encode()) for b in chain],
                      CONFIG_AT)
    server = EventDeliverServer(CH, ledger, ACLProvider(
        lambda: bundles[-1], sw.SwVerifier().verify_many))
    jserver = jde.EventDeliverServer(CH, jledger, jaclmgmt.ACLProvider(
        lambda: jbundles[-1]))
    jserver.start()
    client = GRPCClient(f"127.0.0.1:{jserver.port}")

    def revoke():
        bundles.append(Bundle(cid, revoked, csp))
        jbundles.append(JBundle(cid, jm.Config.decode(revoked.encode()),
                                jcsp))
        ledger.reveal(N_BLOCKS)
        jledger.reveal(N_BLOCKS)

    def signers(pems):
        mspid, cert, key = pems
        return (SigningIdentity(mspid, deserialize_cert(cert), key, csp),
                JSigner(mspid, j_deser(cert), key, jcsp))
    yield {"server": server, "jserver": jserver, "client": client,
           "revoke": revoke, "signers": signers, "material": material}
    client.close()
    jserver.stop()
    server.stop()


def _both(w, method, env_fn, pems):
    """Send the same seek (each package's envelope for it) to both
    servers; returns the two lists of response bytes."""
    mine, ref = w["signers"](pems)
    got = list(w["server"].call(method, iter([env_fn(mine).encode()])))
    want = list(w["client"].stream_stream(
        jde.SERVICE, method, iter([env_fn(ref).encode()]), timeout=30))
    return got, want


@pytest.mark.parametrize("method", ["Deliver", "DeliverFiltered"])
def test_bounded_seeks_answer_equal_frames(world, method):
    for start, stop in ((0, CONFIG_AT - 1), (2, 4), (5, 5)):
        got, want = _both(world, method, lambda s: make_signed_seek_envelope(
            CH, start, stop, s), world["material"].client)
        assert got == want
        assert len(got) == stop - start + 2
        assert m.DeliverResponse.decode(got[-1]).status == m.Status.SUCCESS


def test_fail_if_not_ready_past_the_tip_is_not_found(world):
    got, want = _both(world, "Deliver", lambda s: make_signed_seek_envelope(
        CH, 3, 9, s, behavior=m.SeekBehavior.FAIL_IF_NOT_READY),
        world["material"].client)
    assert got == want and len(got) == CONFIG_AT - 3 + 1
    assert m.DeliverResponse.decode(got[-1]).status == m.Status.NOT_FOUND


def test_refused_seeks_answer_equal_statuses(world):
    mat = world["material"]
    cases = {
        m.Status.NOT_FOUND: (lambda s: make_signed_seek_envelope(
            "other-ch", 0, 1, s), mat.client),
        m.Status.FORBIDDEN: (lambda s: make_signed_seek_envelope(
            CH, 0, 1, s), mat.orderer),
    }

    def non_seek(s):
        seek = m.SeekInfo(
            start=m.SeekPosition(specified=m.SeekSpecified(number=0)),
            stop=m.SeekPosition(specified=m.SeekSpecified(number=0)))
        ch = protoutil.make_channel_header(
            m.HeaderType.ENDORSER_TRANSACTION, CH)
        sh = protoutil.make_signature_header(s.serialize(),
                                             protoutil.new_nonce())
        return protoutil.sign_envelope(
            protoutil.make_payload(ch, sh, seek.encode()), s)
    cases[m.Status.BAD_REQUEST] = (non_seek, mat.client)
    for status, (fn, pems) in cases.items():
        got, want = _both(world, "DeliverFiltered", fn, pems)
        assert got == want == [m.DeliverResponse(status=status).encode()]
    got = list(world["server"].call("Deliver", iter([b"\xff\x01junk"])))
    want = list(world["client"].stream_stream(
        jde.SERVICE, "Deliver", iter([b"\xff\x01junk"]), timeout=30))
    assert got == want == [m.DeliverResponse(
        status=m.Status.BAD_REQUEST).encode()]
    with pytest.raises(ValueError):
        world["server"].call("Nope", iter([]))


def test_revocation_cuts_both_forbidden_at_the_config_block(world):
    mine, ref = world["signers"](world["material"].peers["Org2"])
    out, seen = {}, {"port": [], "ref": []}

    def run(name, evc, **kw):
        got = seen[name]
        try:
            for blk in evc.blocks(start=0, stop=None, **kw):
                got.append(blk.header.number)
            out[name] = (got, m.Status.SUCCESS)
        except (EventStreamError, jde.EventStreamError) as e:
            out[name] = (got, e.status)
    threads = [
        threading.Thread(target=run, args=("port", EventDeliverClient(
            world["server"].call, CH, mine)), kwargs={"timeout_s": 60}),
        threading.Thread(target=run, args=("ref", jde.EventDeliverClient(
            world["client"], CH, ref)), kwargs={"timeout_s": 60})]
    for t in threads:
        t.start()
    # both streams drain the revealed prefix and park at the tip
    deadline = time.monotonic() + 60
    while min(len(v) for v in seen.values()) < CONFIG_AT:
        assert time.monotonic() < deadline, seen
        time.sleep(0.01)
    world["revoke"]()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert out["port"] == out["ref"] == (list(range(CONFIG_AT)),
                                         m.Status.FORBIDDEN)
    assert world["server"].active_streams == 0


def test_deadline_cancel_and_wait_for_tx(world):
    mine, _ref = world["signers"](world["material"].client)
    evc = EventDeliverClient(world["server"].call, CH, mine)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        evc.wait_for_tx("never-committed", timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    # a tx of a block revealed while the client waits at the tip
    target = f"t{CONFIG_AT + 2}-1"
    threading.Timer(0.3, world["revoke"]).start()
    assert evc.wait_for_tx(target, timeout_s=30) == m.TxValidationCode.VALID
    # a standing stream parked at the tip ends on its cancellation
    cancel = CancellationEvent()
    got = []

    def stream():
        for blk in evc.blocks(start=N_BLOCKS - 1, stop_event=cancel):
            got.append(blk.header.number)
    t = threading.Thread(target=stream)
    t.start()
    deadline = time.monotonic() + 60
    while not got:                          # parked at the tip
        assert time.monotonic() < deadline
        time.sleep(0.01)
    cancel.set()
    t.join(10)
    assert not t.is_alive() and got == [N_BLOCKS - 1]
