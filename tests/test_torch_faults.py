"""The port's fault injection (fabric_mod_tpu_torch/faults/), its retry
policy (utils/retry.py) and Broadcast's NOT_LEADER retry, against the
reference.

- The framework units of the reference's tests/test_faults.py:38-97 on
  the port: the Nth-call trigger, seeded probability, drop mode with
  its `times` cap and `kind`, the FMT_FAULTS grammar (here
  `FaultPlan.parse`), the fired counter on /metrics; nothing armed at
  import.
- Fire patterns: the soak's `background_fault_plan(8, 0.05)` and
  parsed plans fire on the same passes as the reference's over 2,000
  passes per point, with equal `fires()` and `calls()`.
- The registry: the port declares the reference's points less exactly
  `bccsp.device.probe` (the transport's two points,
  `deliver.failover.stream` and `gossip.comm.send`, came with it); an
  AST scan of the port finds every declared
  point as a `faults.point` literal and no literal that is undeclared.
- The Retrier (reference tests/test_faults.py:111-153): delays, seeded
  jitter, the deadline on a ManualClock, give-up; the same delays as
  the reference's on the same seed.
- Broadcast (reference :609-667): a leaderless window costs retries,
  not the submission; without retries it is typed; a Raft leader crash
  ridden out on a ManualClock, the retry's sleeps advancing it.
"""
import ast
import pathlib
import random

import pytest
from fabric_mod_tpu import faults as jfaults
from fabric_mod_tpu.soak import background_fault_plan as j_background
from fabric_mod_tpu.utils.retry import Retrier as JRetrier

from tests._clocksteps import advance_until, leader_known_by_all, settle

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.observability.metrics import default_provider
from fabric_mod_tpu_torch.orderer.broadcast import Broadcast
from fabric_mod_tpu_torch.orderer.consensus import NotLeaderError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.soak import background_fault_plan
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock
from fabric_mod_tpu_torch.utils.retry import Retrier, RetryBudgetExceeded

REPO = pathlib.Path(__file__).resolve().parents[1]
LEFT_OUT = {"bccsp.device.probe"}


# ---------------------------------------------------------------------------
# framework: triggers, grammar, arming
# ---------------------------------------------------------------------------

def test_point_unarmed_is_noop_and_nothing_arms_at_import():
    assert not faults.armed() and faults.current_plan() is None
    assert faults.point("no.such.point") is False


def test_nth_trigger_fires_exactly_once():
    plan = faults.FaultPlan().add("a.b", nth=3)
    with faults.active(plan):
        for i in range(1, 6):
            if i == 3:
                with pytest.raises(faults.InjectedFault) as ei:
                    faults.point("a.b")
                assert ei.value.point == "a.b"
            else:
                assert faults.point("a.b") is False
    assert plan.fires("a.b") == 1
    assert plan.calls("a.b") == 5
    assert not faults.armed()


def test_seeded_probability_is_reproducible():
    def pattern(seed):
        plan = faults.FaultPlan().add("p.q", mode="drop", p=0.4, seed=seed)
        with faults.active(plan):
            return [faults.point("p.q") for _ in range(64)]
    a, b = pattern(7), pattern(7)
    assert a == b
    assert any(a) and not all(a)
    assert pattern(8) != a


def test_drop_mode_times_cap_and_kind():
    plan = faults.FaultPlan()
    plan.add("d.e", mode="drop", p=1.0, times=2)
    plan.add("k.l", kind="device")
    with faults.active(plan):
        assert faults.point("d.e") and faults.point("d.e")
        assert faults.point("d.e") is False      # times=2 exhausted
        with pytest.raises(faults.InjectedFault) as ei:
            faults.point("k.l")
        assert ei.value.kind == "device"


def test_spec_grammar():
    plan = faults.FaultPlan.parse(
        "x.y:error@n=2;a.b:drop@p=1.0,seed=3,times=1;c.d:error@once,"
        "kind=device")
    with faults.active(plan):
        assert faults.point("x.y") is False
        with pytest.raises(faults.InjectedFault):
            faults.point("x.y")
        assert faults.point("a.b") is True
        with pytest.raises(faults.InjectedFault) as ei:
            faults.point("c.d")
        assert ei.value.kind == "device"
    with pytest.raises(ValueError, match="bad fault rule"):
        faults.FaultPlan.parse("x.y:error@wat=1")


def test_arm_spec_validates_point_names_and_disarm():
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.arm_spec("deliver.straem:error@n=1")
    assert not faults.armed()
    plan = faults.arm_spec("deliver.stream:error@n=1")
    try:
        assert faults.armed() and faults.current_plan() is plan
        with pytest.raises(faults.InjectedFault):
            faults.point("deliver.stream")
    finally:
        faults.disarm()
    assert not faults.armed()
    with faults.declared_point("test.synthetic"):
        faults.FaultPlan().add("test.synthetic").validate()
    assert "test.synthetic" not in faults.DECLARED_POINTS


def test_fired_counter_exported():
    plan = faults.FaultPlan().add("metric.pt", nth=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            faults.point("metric.pt")
    text = default_provider().render_prometheus()
    assert 'fabric_faults_injected_total{point="metric.pt"} 1' in text


# ---------------------------------------------------------------------------
# fire patterns against the reference
# ---------------------------------------------------------------------------

def _drive(mod, plan, points, passes):
    """One pass a point in turn, `passes` rounds: the fire pattern."""
    out = {p: [] for p in points}
    with mod.active(plan):
        for _ in range(passes):
            for p in points:
                try:
                    out[p].append(bool(mod.point(p)))
                except mod.InjectedFault as e:
                    out[p].append(("raise", e.kind))
    return out


BACKGROUND_POINTS = ("gossip.comm.drop", "deliver.stream",
                     "orderer.raft.submit")


@pytest.mark.parametrize("seed,p", [(8, 0.05), (11, 0.05), (8, 0.3)])
def test_background_plan_fires_as_the_reference(seed, p):
    mine = background_fault_plan(seed, p)
    ref = j_background(seed, p)
    got = _drive(faults, mine, BACKGROUND_POINTS, 2000)
    want = _drive(jfaults, ref, BACKGROUND_POINTS, 2000)
    assert got == want
    for pt in BACKGROUND_POINTS:
        assert mine.fires(pt) == ref.fires(pt) > 0
        assert mine.calls(pt) == ref.calls(pt) == 2000


SPECS = [
    "deliver.stream:error@n=3",
    "gossip.comm.drop:drop@p=0.2,seed=7",
    "orderer.raft.submit:error@p=0.01,seed=10,kind=io;"
    "commitpipe.commit:error@n=5,times=3",
    "peer.ledger.crash:error@once;dissemination.push:drop@p=0.5,times=40",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_plans_fire_as_the_reference(spec):
    mine = faults.FaultPlan.parse(spec).validate()
    ref = jfaults.FaultPlan.from_spec(spec).validate()
    points = sorted({r.split(":")[0] for r in spec.split(";")})
    assert _drive(faults, mine, points, 2000) == \
        _drive(jfaults, ref, points, 2000)
    for pt in points:
        assert mine.fires(pt) == ref.fires(pt)
        assert mine.calls(pt) == ref.calls(pt) == 2000


# ---------------------------------------------------------------------------
# the registry and the seams
# ---------------------------------------------------------------------------

def test_declared_points_are_the_references_less_three():
    assert faults.DECLARED_POINTS == jfaults.DECLARED_POINTS - LEFT_OUT
    assert LEFT_OUT <= jfaults.DECLARED_POINTS


def _port_point_literals():
    found = {}
    for path in (REPO / "fabric_mod_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "point"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "faults"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (path, node.lineno)
                found.setdefault(arg.value, []).append(
                    f"{path.relative_to(REPO)}:{node.lineno}")
    return found


def test_every_declared_point_has_a_seam_and_every_seam_is_declared():
    found = _port_point_literals()
    assert set(found) == faults.DECLARED_POINTS, (
        sorted(set(found) ^ faults.DECLARED_POINTS))
    # the seams sit in the reference's modules
    where = {p: {s.split(":")[0] for s in sites}
             for p, sites in found.items()}
    assert where["peer.ledger.crash"] == {
        "fabric_mod_tpu_torch/ledger/kvledger.py"}
    assert where["bccsp.device.dispatch"] == {
        "fabric_mod_tpu_torch/bccsp/gpu.py"}
    assert where["orderer.raft.submit"] == {
        "fabric_mod_tpu_torch/orderer/raftchain.py"}
    assert where["gossip.comm.drop"] == {
        "fabric_mod_tpu_torch/gossip/comm.py"}


# ---------------------------------------------------------------------------
# Retrier
# ---------------------------------------------------------------------------

def test_retrier_schedule_and_success():
    sleeps = []
    r = Retrier(base_s=0.1, max_s=0.35, multiplier=2.0, jitter=0.0,
                max_attempts=5, sleep=sleeps.append, name="t-sched")
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] < 4:
            raise OSError("transient")
        return "ok"
    assert r.call(flaky) == "ok"
    assert state["n"] == 4
    assert sleeps == [0.1, 0.2, 0.35]
    assert r.worst_case_delay(3) == pytest.approx(0.65)


def test_retrier_jitter_seeded_bounded_and_equal_to_the_reference():
    r = Retrier(base_s=1.0, max_s=1.0, jitter=0.5, rng=random.Random(42),
                name="t-jit")
    seq = [r.delay_for(0) for _ in range(32)]
    r2 = Retrier(base_s=1.0, max_s=1.0, jitter=0.5, rng=random.Random(42),
                 name="t-jit")
    assert seq == [r2.delay_for(0) for _ in range(32)]
    assert all(0.5 <= d <= 1.5 for d in seq)
    assert len(set(seq)) > 1
    jr = JRetrier(base_s=1.0, max_s=1.0, jitter=0.5, rng=random.Random(42),
                  name="t-jit")
    assert seq == [jr.delay_for(0) for _ in range(32)]
    mine = Retrier(base_s=0.05, max_s=0.5, rng=random.Random(3))
    ref = JRetrier(base_s=0.05, max_s=0.5, rng=random.Random(3))
    assert [mine.delay_for(a) for a in range(12)] == \
        [ref.delay_for(a) for a in range(12)]
    assert mine.worst_case_delay(7) == ref.worst_case_delay(7)


def test_retrier_deadline_on_manual_clock_as_the_reference():
    def run(cls, clock):
        r = cls(base_s=1.0, max_s=1.0, jitter=0.0, deadline_s=2.5,
                clock=clock, sleep=clock.advance, name="t-dead")
        calls = []

        def always_fails():
            calls.append(clock.monotonic())
            raise ValueError("still down")
        with pytest.raises(ValueError, match="still down"):
            r.call(always_fails)
        return calls
    from fabric_mod_tpu.utils.fakeclock import ManualClock as JClock
    assert run(Retrier, ManualClock()) == [0.0, 1.0, 2.0]
    assert run(JRetrier, JClock()) == [0.0, 1.0, 2.0]


def test_retrier_unretryable_raises_immediately_and_giveup():
    r = Retrier(base_s=0.0, retry_on=(OSError,), max_attempts=5,
                sleep=lambda s: None, name="t-filter")
    calls = []

    def boom():
        calls.append(1)
        raise KeyError("not transient")
    with pytest.raises(KeyError):
        r.call(boom)
    assert calls == [1]
    seen = []
    r = Retrier(base_s=0.0, jitter=0.0, sleep=lambda s: None,
                giveup=lambda: len(seen) >= 2,
                on_retry=lambda e, a: seen.append(a), name="t-giveup")

    def down():
        raise OSError("down")
    with pytest.raises(OSError):
        r.call(down)
    assert seen == [0, 1]
    text = default_provider().render_prometheus()
    assert 'fabric_retry_giveups_total{name="t-giveup"} 1' in text
    assert 'fabric_retry_attempts_total{name="t-giveup"} 2' in text
    err = RetryBudgetExceeded("spent", last=OSError("x"))
    assert isinstance(err.last, OSError)


# ---------------------------------------------------------------------------
# Broadcast: NOT_LEADER is typed, retried, and survives a leader crash
# ---------------------------------------------------------------------------

class _FlakyChain:
    def __init__(self, fail_n):
        self.fail_n = fail_n
        self.orders = []

    def order(self, env, seq):
        if self.fail_n > 0:
            self.fail_n -= 1
            raise NotLeaderError("election in progress", leader_hint="o2")
        self.orders.append(env)


class _FakeSupport:
    channel_id = "ch"

    def __init__(self, chain):
        self.chain = chain
        self.processor = self

    def process_normal_msg(self, env):
        return 0


class _FakeRegistrar:
    def __init__(self, support):
        self._support = support

    def broadcast_channel_support(self, env):
        return self._support, False


def test_broadcast_retries_not_leader_then_succeeds():
    env = m.Envelope(payload=b"p", signature=b"s")
    chain = _FlakyChain(fail_n=2)
    bcast = Broadcast(_FakeRegistrar(_FakeSupport(chain)),
                      retrier=Retrier(base_s=0.0, jitter=0.0,
                                      max_attempts=5,
                                      retry_on=(NotLeaderError,),
                                      sleep=lambda s: None,
                                      name="test-bcast"))
    bcast.submit(env)
    assert len(chain.orders) == 1
    chain2 = _FlakyChain(fail_n=2)
    no_retry = Broadcast(_FakeRegistrar(_FakeSupport(chain2)),
                         retrier=Retrier(base_s=0.0, jitter=0.0,
                                         max_attempts=1,
                                         retry_on=(NotLeaderError,),
                                         sleep=lambda s: None,
                                         name="test-bcast0"))
    with pytest.raises(NotLeaderError) as ei:
        no_retry.submit(env)
    assert ei.value.leader_hint == "o2"
    assert chain2.orders == []


def test_broadcast_default_policy_is_the_references():
    b = Broadcast(_FakeRegistrar(_FakeSupport(_FlakyChain(0))))
    r = b._retrier
    assert (r.base_s, r.max_s, r.deadline_s, r.retry_on, r.jitter) == \
        (0.05, 0.5, 5.0, (NotLeaderError,), 0.1)
    # the default rides out a leaderless window on a ManualClock: its
    # sleeps are real, so inject a clock that they advance instead
    clock = ManualClock()
    r._clock, r._sleep = clock, clock.advance
    chain = _FlakyChain(fail_n=6)
    b = Broadcast(_FakeRegistrar(_FakeSupport(chain)), retrier=r)
    b.submit(m.Envelope(payload=b"p", signature=b"s"))
    assert len(chain.orders) == 1 and 0.05 * 0.9 < clock.monotonic() < 5.0
    # past the 5 s deadline the typed error surfaces
    b = Broadcast(_FakeRegistrar(_FakeSupport(_FlakyChain(fail_n=10 ** 6))),
                  retrier=r)
    t0 = clock.monotonic()
    with pytest.raises(NotLeaderError):
        b.submit(m.Envelope(payload=b"p", signature=b"s"))
    assert 4.0 < clock.monotonic() - t0 <= 5.0


def test_raft_leader_crash_broadcast_retry_manualclock(tmp_path):
    """A Raft leader crashes; a broadcast during the leaderless window
    is rejected typed without retries, and with a Retrier whose sleeps
    advance the manual clock it lands once the re-election completes
    (reference tests/test_faults.py:667)."""
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.channelconfig import genesis
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.msp import ca as calib
    from fabric_mod_tpu_torch.msp.identities import SigningIdentity
    from fabric_mod_tpu_torch.orderer.raft import RaftTransport
    from fabric_mod_tpu_torch.orderer.raftchain import RaftChain
    from fabric_mod_tpu_torch.orderer.registrar import Registrar
    from fabric_mod_tpu_torch.protos import protoutil

    csp = SwCSP()
    org_ca = calib.CA("ca.org1", "Org1", seed=b"faults")
    ord_ca = calib.CA("ca.orderer", "OrdererOrg", seed=b"faults")
    blk = genesis.standard_network(
        "faultchan", {"Org1": [org_ca.cert_pem()]},
        {"OrdererOrg": [ord_ca.cert_pem()]},
        consensus_type="etcdraft", consenters=["f0", "f1", "f2"],
        batch_timeout="100ms", max_message_count=1)
    clock = ManualClock()
    transport = RaftTransport()
    ids = ["f0", "f1", "f2"]
    registrars = {}
    for idx, i in enumerate(ids):
        oc, ok = ord_ca.issue(f"{i}.orderer", "OrdererOrg", ous=["orderer"])
        signer = SigningIdentity("OrdererOrg", oc, calib.key_pem(ok), csp)

        def factory(support, i=i, idx=idx):
            return RaftChain(i, ids, transport, str(tmp_path / f"{i}.wal"),
                             support, clock=clock, rng=random.Random(idx + 1))
        reg = Registrar(str(tmp_path / i), signer, csp,
                        chain_factory=factory)
        reg.create_channel(blk)
        registrars[i] = reg
    try:
        supports = {i: registrars[i].get_chain("faultchan") for i in ids}
        chains = {i: s.chain for i, s in supports.items()}
        assert advance_until(clock, lambda: leader_known_by_all(chains))
        leader_id = next(i for i, c in chains.items() if c.is_leader)
        followers = [i for i in ids if i != leader_id]
        survivor, healed_later = followers
        transport.partitioned.update(
            {leader_id, f"{leader_id}:chain",
             healed_later, f"{healed_later}:chain"})
        assert advance_until(clock,
                             lambda: chains[survivor].leader_id is None)
        ccert, ckey = org_ca.issue("client@org1", "Org1", ous=["client"])
        client = SigningIdentity("Org1", ccert, calib.key_pem(ckey), csp)
        b = RWSetBuilder()
        b.add_write("cc", "crashkey", b"survives")
        env = protoutil.create_signed_tx("faultchan", "cc",
                                         b.build().encode(), client,
                                         [client])
        with pytest.raises(NotLeaderError):
            Broadcast(registrars[survivor],
                      retrier=Retrier(max_attempts=1,
                                      retry_on=(NotLeaderError,),
                                      sleep=lambda s: None,
                                      name="t-noretry")).submit(env)
        transport.partitioned.difference_update(
            {healed_later, f"{healed_later}:chain"})

        def sleep_and_settle(s):
            for _ in range(max(1, int(s / 0.02))):
                clock.advance(0.02)
                settle(lambda: False, timeout=0.01, poll=0.005)
        bcast = Broadcast(
            registrars[survivor],
            retrier=Retrier(base_s=0.1, max_s=0.2, jitter=0.0,
                            max_attempts=200, clock=clock,
                            retry_on=(NotLeaderError,),
                            sleep=sleep_and_settle, name="t-bretry"))
        bcast.submit(env)
        live = [i for i in ids if i != leader_id]
        assert settle(lambda: all(supports[i].store.height >= 2
                                  for i in live), timeout=20.0), \
            {i: supports[i].store.height for i in live}
        got = supports[survivor].store.get_block_by_number(1)
        assert [protoutil.envelope_channel_header(e).tx_id
                for e in protoutil.get_envelopes(got)] == \
            [protoutil.envelope_channel_header(env).tx_id]
    finally:
        for reg in registrars.values():
            reg.close()
