"""The port's concurrency canaries: lock hierarchy, the lock-order
registry, guarded queues, thread ownership and each retrofitted
structure of the port.

The port's counterpart of tests/test_racecheck.py: for every guard and
every threaded structure that builds one, an injected race raises
RaceError with the guards armed (`concurrency.armed()`) and stays
silent with them off.  The structures are the port's own (its commit
pipe, BatchingVerifyService, deliver client, election, gossip state and
comm, Raft FSM), under the reference's names and ranks.
"""
import queue as _stdqueue
import tempfile
import threading
import time

import pytest

from fabric_mod_tpu_torch import concurrency
from fabric_mod_tpu_torch.concurrency import (GuardedQueue, OwnedState,
                                              RegisteredLock,
                                              RegisteredThread, armed,
                                              assert_joined, lock_registry)
from fabric_mod_tpu_torch.utils.racecheck import (OrderedLock, RaceError,
                                                  ThreadOwnership)


def _spin(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# -- the primitives -----------------------------------------------------------

def test_shim_and_package_export_one_set_of_guards():
    from fabric_mod_tpu_torch.concurrency import locks, ownership
    assert OrderedLock is locks.OrderedLock
    assert ThreadOwnership is ownership.ThreadOwnership
    assert RaceError is concurrency.RaceError
    assert lock_registry() is locks.lock_registry()


@pytest.mark.parametrize("threaded", [False, True])
def test_canary_lock_inversion_bites(threaded):
    """Ranks must strictly increase down the held stack: 10 -> 20 is
    legal, 20 -> 10 raises on its first attempt, in one thread and
    across two.  The rank check is on with the guards off too."""
    a = OrderedLock(10, "A")
    b = OrderedLock(20, "B")
    with a:
        with b:
            pass
    caught = []

    def invert():
        try:
            with b:
                a.acquire()
        except RaceError as e:
            caught.append(e)

    with armed(False):
        if threaded:
            t = threading.Thread(target=invert)
            t.start()
            t.join()
        else:
            invert()
    assert caught and "lock-order violation" in str(caught[0])


def test_reentry_of_held_lower_rank_lock_is_legal():
    """Re-entry of any held lock is exempt from the rank rule, and does
    not blind the check against the highest rank held."""
    ledger = OrderedLock(10, "ledger")
    pvt = OrderedLock(30, "pvtstore")
    with ledger:
        with pvt:
            with ledger:
                pass
        with pvt:
            pass
    other = OrderedLock(10, "other")
    cache = OrderedLock(20, "cache")
    with ledger:
        with pvt:
            with pytest.raises(RaceError, match="lock-order violation"):
                other.acquire()
            with ledger:
                with pytest.raises(RaceError, match="lock-order violation"):
                    cache.acquire()


def test_reentrant_and_release_order():
    a = OrderedLock(10, "A")
    b = OrderedLock(20, "B")
    with a:
        with a:
            with b:
                pass
        with b:
            pass
    assert concurrency.core.held_locks() == []


@pytest.mark.parametrize("transitive", [False, True])
def test_registry_cycle_detection(transitive):
    """Armed, the first acquisition closing a cycle raises, directly
    (AB/BA) and through a third lock (A->B->C, then C->A); disarmed,
    the registry observes nothing."""
    a, b, c = (RegisteredLock(f"canary-{n}") for n in "abc")
    with armed():
        with a:
            with b:
                if transitive:
                    with c:
                        pass
        last = c if transitive else b
        with last:
            with pytest.raises(RaceError, match="lock-order cycle"):
                a.acquire()
        with a:
            with a:
                with b:
                    pass
    x, y = RegisteredLock("canary-x"), RegisteredLock("canary-y")
    with armed(False):
        with x:
            with y:
                pass
        with y:
            with x:                       # silent when off
                pass


def test_registry_spans_ranked_and_rankless_locks():
    with armed():
        ranked = OrderedLock(40, "ranked-canary")
        free = RegisteredLock("rankless-canary")
        with ranked:
            with free:
                pass
        with free:
            with pytest.raises(RaceError, match="lock-order cycle"):
                ranked.acquire()


def test_registered_lock_under_a_condition_keeps_the_held_stack():
    """A Condition over a RegisteredLock: wait() drops the lock from the
    held stack while parked and restores it after, so no false edge is
    observed from the waiting thread."""
    lock = RegisteredLock("canary-cv")
    cv = threading.Condition(lock)
    seen = []
    with armed():
        with cv:
            assert concurrency.core.held_locks()[-1][1] is lock

            def notify():
                with cv:
                    seen.append(len(concurrency.core.held_locks()))
                    cv.notify_all()
            t = threading.Thread(target=notify)
            t.start()
            assert cv.wait(5)
            assert concurrency.core.held_locks()[-1][1] is lock
            t.join()
        assert concurrency.core.held_locks() == []
    assert seen == [1]


def test_registry_prunes_dead_locks():
    reg = concurrency.LockOrderRegistry()
    held = [(None, RegisteredLock("canary-dead-a"))]
    reg.observe(held, RegisteredLock("canary-dead-b"))
    assert reg.edge_count() == 1
    del held
    reg._prune()
    assert reg.edge_count() == 0


def test_guarded_queue_consumer_pin_and_dead_owner_handoff():
    with armed():
        q = GuardedQueue(name="canary-q")
        bound = threading.Event()
        release = threading.Event()

        def consumer():
            q.get()
            bound.set()
            release.wait(10)

        t = threading.Thread(target=consumer, daemon=True)
        q.put(1)
        t.start()
        assert bound.wait(5)
        with pytest.raises(RaceError, match="consumer-side ownership"):
            q.get_nowait()
        release.set()
        t.join(5)
        q.put(2)
        assert q.get_nowait() == 2        # the owner died: handoff
    with armed(False):
        q2 = GuardedQueue(name="canary-q2", single_producer=True)
        q2.put(1)
        t = threading.Thread(target=q2.put, args=(2,))
        t.start()
        t.join()
        assert q2.qsize() == 2            # silent when off


def test_guarded_queue_single_producer_bites():
    with armed():
        q = GuardedQueue(name="canary-spsc", single_producer=True)
        release = threading.Event()

        def producer():
            q.put(1)
            release.wait(10)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert _spin(lambda: q.qsize() == 1)
        with pytest.raises(RaceError, match="producer-side ownership"):
            q.put(2)
        release.set()
        t.join(5)


def test_owned_state_single_writer_and_claim():
    st = OwnedState("canary-state", n=0)
    release = threading.Event()

    def writer():
        st.n += 1
        release.wait(10)

    with armed():
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert _spin(lambda: st.n == 1)
        with pytest.raises(RaceError, match="field-ownership"):
            st.n = 5
        assert st.n == 1                  # reads stay open
        release.set()
        t.join(5)
        st.n = 7                          # the writer died: adopt
    with armed(False):
        st.n = 8
    assert st.n == 8


def test_canary_cross_thread_fsm_mutation_bites():
    own = ThreadOwnership("canary-fsm")
    own.claim()
    caught = []

    def intrude():
        try:
            own.guard()
        except RaceError as e:
            caught.append(e)

    t = threading.Thread(target=intrude)
    t.start()
    t.join()
    assert caught, "cross-thread mutation was not detected"
    own.guard()


def test_registered_thread_leak_check_bites():
    release = threading.Event()
    t = RegisteredThread(target=release.wait, name="canary-leaker",
                         structure="canary")
    t.start()
    with armed():
        with pytest.raises(RaceError, match="thread leak"):
            assert_joined((t,), owner="canary", timeout=0.05)
    with armed(False):
        assert_joined((t,), owner="canary", timeout=0.05)
    release.set()
    t.join(5)
    assert t not in concurrency.live_registered()


# -- the port's structures ----------------------------------------------------

def test_canary_raft_fsm_guard_is_wired():
    """The port's RaftNode claims its FSM on its own thread: an FSM
    handler called from another thread raises (always on)."""
    from fabric_mod_tpu_torch.orderer.raft import RaftNode, RaftTransport
    with tempfile.TemporaryDirectory() as d:
        node = RaftNode("solo", ["solo"], RaftTransport(), d + "/solo.wal",
                        lambda i, b: None)
        node.start()
        try:
            assert _spin(lambda: node._fsm_owner._owner is not None)
            with pytest.raises(RaceError, match="thread-ownership"):
                node._on_timer()
        finally:
            node.stop()


class _NullLedger:
    height = 0
    height_changed = threading.Condition()

    def get_block_by_number(self, n):
        return None


class _NullStaged:
    def __init__(self, block):
        self.block = block
        self.needs_barrier = False

    def resolve_mask(self):
        return None


class _NullTarget:
    ledger = _NullLedger()

    def stage_block(self, block):
        return _NullStaged(block)

    def commit_staged(self, staged):
        return []


def _block0():
    from fabric_mod_tpu_torch.protos import protoutil
    return protoutil.new_block(0, b"", [])


def test_canary_batching_verify_service_flusher_bites():
    """Taking from the flusher's submit queue or the resolver's in-flight
    queue from outside their threads raises armed, and is silent off."""
    from fabric_mod_tpu_torch.bccsp.api import VerifyItem
    from fabric_mod_tpu_torch.bccsp.gpu import BatchingVerifyService
    from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
    with armed():
        svc = BatchingVerifyService(SwVerifier(), deadline_s=0.001)
        try:
            fut = svc.submit(VerifyItem(b"\x11" * 32, b"junk",
                                        b"\x00" * 64))
            assert fut.result(timeout=60) is False
            with pytest.raises(RaceError, match="consumer-side"):
                svc._q.get_nowait()
            with pytest.raises(RaceError, match="consumer-side"):
                svc._inflight.get_nowait()
            with armed(False):
                with pytest.raises(_stdqueue.Empty):
                    svc._q.get_nowait()
        finally:
            svc.close()
    assert svc._lifecycle.name == "verify-service-lifecycle"


def test_canary_commitpipe_stage_commit_queues_bite():
    from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
    with armed():
        pipe = PipelinedCommitter(_NullTarget(), depth=2, consumer="canary")
        try:
            pipe.submit(_block0())
            assert pipe.flush(timeout_s=10)
            with pytest.raises(RaceError, match="consumer-side"):
                pipe._in_q.get_nowait()
            with pytest.raises(RaceError, match="consumer-side"):
                pipe._staged_q.get_nowait()
            with pytest.raises(RaceError, match="field-ownership"):
                pipe._stage_state.secs = 0.0
            with armed(False):
                with pytest.raises(_stdqueue.Empty):
                    pipe._in_q.get_nowait()
        finally:
            pipe.close()
    assert pipe._in_q.name == "commitpipe-in[canary]"
    assert pipe._staged_q.name == "commitpipe-staged[canary]"


def test_canary_gossip_comm_lock_in_registry():
    """The in-process gossip network's lock feeds the registry: an
    inversion against another registered lock is a cycle.  (The
    reference's gRPC sender queues come with the transport.)"""
    from fabric_mod_tpu_torch.gossip.comm import InProcNetwork
    net = InProcNetwork()
    probe = RegisteredLock("canary-comm-probe")
    with armed():
        with net._lock:
            with probe:
                pass
        with probe:
            with pytest.raises(RaceError, match="lock-order cycle"):
                net._lock.acquire()
    assert net._lock.name == "gossip.comm._lock"


def test_canary_deliverclient_double_run_bites():
    """A second concurrent run() on one client raises armed; silent off;
    sequential runs stay legal."""
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
    stop_src = threading.Event()
    entered = threading.Event()

    class _Source:
        def blocks(self, start, stop_event=None, timeout_s=30.0):
            entered.set()
            stop_src.wait(20)
            return iter(())

    class _Chan(_NullTarget):
        channel_id = "canary"

        class mcs:
            @staticmethod
            def verify_block(cid, block, expected_prev_hash=None):
                return None

    dc = DeliverClient(_Chan(), _Source())
    t = threading.Thread(target=dc.run, daemon=True)
    t.start()
    try:
        assert entered.wait(5)
        with armed():
            with pytest.raises(RaceError, match="concurrent ownership"):
                dc._runner.claim()
        with armed(False):
            dc._runner.claim()
    finally:
        stop_src.set()
        dc.stop()
        t.join(10)
    assert not t.is_alive()
    dc._runner.release()
    stop_src.set()
    entered.clear()
    with armed():
        dc.run(idle_timeout_s=0.1)        # a sequential re-run is legal


def test_canary_election_external_tick_bites():
    from fabric_mod_tpu_torch.gossip.election import LeaderElectionService
    svc = LeaderElectionService(b"\x01", lambda: [])
    svc.start(interval_s=0.02)
    try:
        assert _spin(lambda: svc._ticker._owner is not None)
        with armed():
            with pytest.raises(RaceError, match="thread-ownership"):
                svc.tick()
        with armed(False):
            svc.tick()
    finally:
        svc.stop()
    with armed():
        svc.tick()                        # the loop died: legal again


def test_canary_gossip_state_drain_lock_in_registry():
    from fabric_mod_tpu_torch.gossip.state import GossipStateProvider

    class _Chan:
        ledger = _NullLedger()

        def store_block(self, block):
            return []

    prov = GossipStateProvider(_Chan())
    probe = RegisteredLock("canary-drain-probe")
    with armed():
        with prov._drain_lock:
            with probe:
                pass
        with probe:
            with pytest.raises(RaceError, match="lock-order cycle"):
                prov._drain_lock.acquire()
    assert prov._drain_lock.name == "gossip-state-drain"


def test_ledger_stores_hold_the_reference_ranks(tmp_path):
    """KvLedger 10 < transient store 20 < pvt store 30: the order the
    commit path takes them; the reverse raises with the guards off."""
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ledger.pvtdata import (PvtDataStore,
                                                     TransientStore)
    led = KvLedger("ch", str(tmp_path / "l"))
    transient = TransientStore(dir_path=str(tmp_path / "t"))
    pvt = PvtDataStore(dir_path=str(tmp_path / "p"))
    try:
        ranks = [(lk.rank, lk.name) for lk in
                 (led._lock, transient._lock, pvt._lock)]
        assert ranks == [(10, "kvledger"), (20, "transientstore"),
                         (30, "pvtdatastore")]
        with armed(False):
            with pvt._lock:
                with pytest.raises(RaceError, match="lock-order violation"):
                    led._lock.acquire()
    finally:
        led.close()


def test_reference_names_of_the_retrofitted_locks():
    """A sample of the registered structures under the reference's
    names (the whole list is the reference's grep)."""
    from fabric_mod_tpu_torch.observability import metrics, opsserver
    from fabric_mod_tpu_torch.utils.fakeclock import ManualClock
    assert metrics._default_lock.name == "observability.metrics._default_lock"
    assert opsserver._default_health_lock.name == \
        "observability.opsserver._default_health_lock"
    assert ManualClock()._lock.name == "utils.fakeclock._lock"
