"""SoakHarness: sustained mixed traffic while churn moves underneath.

The port's copy of fabric_mod_tpu/soak/harness.py.  Every FMT_SOAK_*
knob of the reference is a `SoakConfig` argument with the reference's
default, and the world's device arguments (`verifier`, `device`,
`sharded`, `relay`) ride along: by default every soak peer verifies on
the card through one shared GpuVerifier.

One run = build the world, start the mixed x509+idemix workload, arm
the permanently-on background fault plan (seeded probability rules on
the injection points), then walk the seeded ChurnPlan: traffic
phase -> fire event -> converge-or-fail -> next.  At the tail the
exactly-once ledger audit (with resubmission of kill-lost envelopes),
the subscriber-cutoff assertion, teardown, and the thread-leak sweep.

Every failure raises SoakError whose message carries the seed and the
full schedule — `SoakHarness(SoakConfig(seed=N, n_events=K)).run()`
replays it, and ChurnPlan(N) regenerates the schedule bit for bit.

SoakConfig arguments (the reference's knob, its default):

  seed               FMT_SOAK_SEED           schedule + rng seed (8)
  n_events           FMT_SOAK_EVENTS         churn events per run (6)
  n_channels         FMT_SOAK_CHANNELS       soak channels (2)
  n_peers            FMT_SOAK_PEERS          peers at start (2)
  gap_txs            FMT_SOAK_GAP_TXS        (lo, hi) txs between
                                             events ((4, 9))
  recovery_window_s  FMT_SOAK_WINDOW_S       recovery window (45.0)
  min_recovery_frac  FMT_SOAK_RECOVERY_FRAC  post/pre rate floor (0.05)
  x509_gap_s         FMT_SOAK_X509_GAP_S     x509 inter-tx gap (0.12)
  idemix_gap_s       FMT_SOAK_IDEMIX_GAP_S   idemix inter-tx gap (1.0)
  fault_p            FMT_SOAK_FAULT_P        background fault p (0.05)
  kinds              (bench --soak-kinds)    the plan's kind pool
  no_crash           FMT_SOAK_NO_CRASH       drop the crash-shaped
                                             kinds from the default
                                             plan (False)
  partition_s        FMT_SOAK_PARTITION_S    partition hold (2.0)
  crash_hold_s       FMT_SOAK_CRASH_HOLD_S   crash/restart down
                                             window (1.0)
  sharded            FMT_SOAK_SHARDED        per-peer shard routers
                                             (False)
  relay              FMT_SOAK_RELAY          dissemination-relay mode:
                                             leader_kill also partitions
                                             the relay root (recovery
                                             kind=relay_reparent), and
                                             the run fails if the relay
                                             never carried a block
                                             (False)
  verifier, device   —                       the world's shared
                                             verifier (None: a
                                             GpuVerifier on `device`)
"""
from __future__ import annotations

import random
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import live_registered
from fabric_mod_tpu_torch.observability import get_logger, tracing
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.soak.invariants import InvariantChecker, SoakError
from fabric_mod_tpu_torch.soak.plan import CORE_KINDS, ChurnPlan
from fabric_mod_tpu_torch.soak.workload import MixedWorkload
from fabric_mod_tpu_torch.soak.world import SoakWorld

log = get_logger("soak.harness")

# the crash-shaped kinds `no_crash` drops from the default plan
CRASH_KINDS = ("peer_crash_rejoin", "orderer_restart",
               "network_partition")


class SoakConfig:
    """One soak's settings; each argument's default is the reference's
    knob default (see the module docstring)."""

    def __init__(self, seed: int = 8, n_events: int = 6,
                 n_channels: int = 2, n_peers: int = 2,
                 gap_txs: Tuple[int, int] = (4, 9),
                 recovery_window_s: float = 45.0,
                 min_recovery_frac: float = 0.05,
                 x509_gap_s: float = 0.12,
                 idemix_gap_s: float = 1.0,
                 fault_p: float = 0.05,
                 kinds: Optional[Tuple[str, ...]] = None,
                 no_crash: bool = False,
                 partition_s: float = 2.0,
                 crash_hold_s: float = 1.0,
                 sharded: bool = False, relay: bool = False,
                 verifier=None, device=None):
        self.seed = int(seed)
        self.n_events = int(n_events)
        self.n_channels = int(n_channels)
        self.n_peers = int(n_peers)
        self.gap_txs = tuple(gap_txs)
        self.recovery_window_s = float(recovery_window_s)
        self.min_recovery_frac = float(min_recovery_frac)
        self.x509_gap_s = float(x509_gap_s)
        self.idemix_gap_s = float(idemix_gap_s)
        self.fault_p = float(fault_p)
        # event-kind selection: an explicit list wins; else the full
        # 9-kind core, minus the crash-shaped kinds with `no_crash`
        if kinds is not None:
            self.kinds: Optional[Tuple[str, ...]] = tuple(kinds)
        elif no_crash:
            self.kinds = tuple(k for k in CORE_KINDS
                               if k not in CRASH_KINDS)
        else:
            self.kinds = None              # plan default (CORE_KINDS)
        self.partition_s = float(partition_s)
        self.crash_hold_s = float(crash_hold_s)
        self.sharded = bool(sharded)
        self.relay = bool(relay)
        self.verifier = verifier
        self.device = device


def background_fault_plan(seed: int, p: float) -> faults.FaultPlan:
    """The permanently-armed chaos rider: seeded probability rules on
    the injection points, active for the WHOLE run.  gossip
    drops are repaired by redelivery/anti-entropy, deliver stream
    deaths by the failover source, raft submit faults by client
    retry — each fired fault exercises the mechanism built for it."""
    return (faults.FaultPlan()
            .add("gossip.comm.drop", mode="drop", p=p, seed=seed)
            .add("deliver.stream", p=p / 2, seed=seed + 1, kind="io")
            .add("orderer.raft.submit", p=p / 4, seed=seed + 2,
                 kind="io"))


def _first_config_block_at_or_after(ledger, start: int) -> Optional[int]:
    for num in range(max(1, start), ledger.height):
        block = ledger.get_block_by_number(num)
        if block is None:
            continue
        try:
            env = protoutil.get_envelopes(block)[0]
            payload = protoutil.unmarshal_envelope_payload(env)
            ch = m.ChannelHeader.decode(payload.header.channel_header)
            if ch.type == m.HeaderType.CONFIG:
                return num
        except Exception:
            continue
    return None


class SoakHarness:
    def __init__(self, config: Optional[SoakConfig] = None,
                 root: Optional[str] = None):
        self.cfg = config or SoakConfig()
        self._root = root
        self.plan = ChurnPlan(self.cfg.seed, self.cfg.n_events,
                              gap_txs=self.cfg.gap_txs,
                              kinds=self.cfg.kinds)
        self._rng = random.Random(self.cfg.seed ^ 0xC0FFEE)
        # satellite contract: exactly one join per run takes the
        # snapshot fast lane; the rest replay from genesis, and the
        # convergence gate proves both lanes land on one fingerprint
        self._snap_join_done = False

    # -- event execution ---------------------------------------------------

    def _wait_leaders(self, world: SoakWorld, timeout_s: float = 30.0):
        deadline = time.monotonic() + timeout_s
        for cid in world.channel_ids:
            while world.leader_of(cid) is None:
                if time.monotonic() > deadline:
                    raise SoakError(
                        f"no raft leader elected on {cid}", self.plan)
                time.sleep(0.05)

    def _fire(self, world: SoakWorld, kind: str) -> Dict:
        """Execute one churn event; returns event-specific context the
        post-convergence assertions use."""
        ctx: Dict = {"kind": kind}
        if kind == "peer_join":
            snap = not self._snap_join_done
            self._snap_join_done = True
            ctx["peer"] = world.add_peer(snapshot=snap).name
            ctx["snapshot_join"] = snap
        elif kind == "peer_crash_rejoin":
            victim = world.crash_peer()
            ctx["peer"] = victim.name
            # the down window: traffic keeps flowing (the lanes run in
            # their own threads) so the rejoin has a real tail for
            # _recover + gossip to catch up
            time.sleep(self.cfg.crash_hold_s)
            world.rejoin_peer(victim)
        elif kind == "orderer_restart":
            ctx["orderer"] = world.restart_orderer(
                hold_s=self.cfg.crash_hold_s)
        elif kind == "network_partition":
            peer_names, ord_ids = world.install_partition()
            ctx["peers"] = peer_names
            ctx["orderers"] = ord_ids
            # scheduled heal: hold the cut under live traffic, then
            # let the fingerprint-convergence window gate the merge
            time.sleep(self.cfg.partition_s)
            world.heal_partition(peer_names, ord_ids)
        elif kind == "acl_revoke":
            ctx["pre_h"] = world.revoke_audit_org()
        elif kind == "batch_config":
            cid = world.channel_ids[
                self._rng.randrange(len(world.channel_ids))]
            ctx["channel"] = cid
            ctx["max_message_count"] = world.set_batch_size(cid)
        elif kind == "consenter_add":
            ctx["orderer"] = world.add_consenter()
        elif kind == "consenter_remove":
            ctx["orderer"] = world.remove_consenter()
        elif kind == "leader_kill":
            # leadership can flip between the wait and the read (the
            # clock pump keeps election timers moving): retry until a
            # victim is actually caught, with a bounded budget
            deadline = time.monotonic() + 30.0
            victim = None
            while victim is None:
                self._wait_leaders(world)
                victim = world.leader_of(world.channel_ids[0])
                if victim is None and time.monotonic() > deadline:
                    raise SoakError(
                        "leader_kill: no stable leader to kill on "
                        f"{world.channel_ids[0]}", self.plan)
            ctx["orderer"] = victim
            world.kill_orderer(victim)
            if world.relay:
                # relay-mode amplifier: cut the gossip relay ROOT off
                # the channel too — survivors must expire it, elect a
                # new root, and reparent the tree while the raft layer
                # is itself electing; the victim (still leader in its
                # own view) converges through its own deliver client
                ctx["relay_root"] = world.partition_relay_leader(
                    world.channel_ids[0])
        else:                              # pragma: no cover
            raise SoakError(f"unknown event kind {kind!r}", self.plan)
        log.info("soak: fired %s %s", kind, ctx)
        return ctx

    def _post_event(self, world: SoakWorld, checker: InvariantChecker,
                    ctx: Dict) -> None:
        """Event-specific steady-state assertions (after convergence)."""
        if ctx["kind"] == "acl_revoke":
            sub = world.subscriber
            cid0 = world.channel_ids[0]
            ledger = world.peers[0].channels[cid0].ledger
            cfg_num = _first_config_block_at_or_after(
                ledger, ctx["pre_h"])
            if cfg_num is None:
                raise SoakError(
                    "acl_revoke: no config block found on the event "
                    "channel after the update", self.plan)
            if not sub.done(timeout_s=checker.window_s):
                raise SoakError(
                    "acl_revoke: revoked subscriber still streaming "
                    "after the revocation block committed", self.plan)
            if sub.status != m.Status.FORBIDDEN:
                raise SoakError(
                    f"acl_revoke: subscriber ended with "
                    f"{sub.status!r}, not FORBIDDEN "
                    f"(error={sub.error!r})", self.plan)
            late = [n for n in sub.received if n >= cfg_num]
            if late:
                raise SoakError(
                    f"acl_revoke: subscriber received post-revocation "
                    f"block(s) {late} (revocation at {cfg_num})",
                    self.plan)
            ctx["cut_at_block"] = cfg_num
            ctx["received_before_cut"] = len(sub.received)
        elif ctx["kind"] == "leader_kill":
            # post-event traffic already committed, so the survivors
            # MUST have elected a new, different leader by now — a
            # None here means leadership wedged (leader_of can never
            # return the dead orderer, so only the None and != checks
            # are meaningful)
            cid0 = world.channel_ids[0]
            new_leader = world.leader_of(cid0)
            if new_leader is None or new_leader == ctx["orderer"]:
                raise SoakError(
                    f"leader_kill: no replacement leader on {cid0} "
                    f"after killing {ctx['orderer']} "
                    f"(leader_of={new_leader!r})", self.plan)
            ctx["new_leader"] = new_leader
        elif ctx["kind"] == "peer_crash_rejoin":
            # convergence already proved one fingerprint across every
            # peer INCLUDING the rejoin; make the replay explicit: the
            # rejoined ledger must match p0 on every channel.  The
            # post-event traffic phase ran between that gate and this
            # check, so quiesce and compare at identical heights —
            # an instantaneous read races in-flight commits and fakes
            # a divergence out of ordinary catch-up lag.
            peer = next(p for p in world.peers
                        if p.name == ctx["peer"])
            checker.workload.pause()
            try:
                deadline = time.monotonic() + checker.window_s
                while True:
                    lag = None
                    for cid in world.channel_ids:
                        if peer.height(cid) != \
                                world.peers[0].height(cid) or \
                                peer.fingerprint(cid) != \
                                world.peers[0].fingerprint(cid):
                            lag = cid
                            break
                    if lag is None:
                        break
                    if time.monotonic() >= deadline:
                        raise SoakError(
                            f"peer_crash_rejoin: {peer.name} diverged "
                            f"on {lag} after recovery replay "
                            f"(height {peer.height(lag)} vs p0 "
                            f"{world.peers[0].height(lag)})",
                            self.plan)
                    time.sleep(0.05)
            finally:
                checker.workload.resume()
            ctx["heights"] = {cid: peer.height(cid)
                              for cid in world.channel_ids}
        elif ctx["kind"] == "orderer_restart":
            oid = ctx["orderer"]
            o = next((x for x in world.live_orderers()
                      if x.oid == oid), None)
            if o is None:
                raise SoakError(
                    f"orderer_restart: {oid} not live after its "
                    "restart", self.plan)
            for cid in world.channel_ids:
                sup = o.registrar.get_chain(cid)
                if sup is None:
                    raise SoakError(
                        f"orderer_restart: {oid} lost channel {cid} "
                        "across the restart", self.plan)
            ctx["store_heights"] = {
                cid: o.registrar.get_chain(cid).store.height
                for cid in world.channel_ids}
        elif ctx["kind"] == "network_partition":
            for cid in world.channel_ids:
                if world.networks[cid].partitioned or \
                        world.transports[cid].partitioned:
                    raise SoakError(
                        f"network_partition: seam on {cid} still "
                        "holds a cut after the scheduled heal",
                        self.plan)

    def _run_traffic(self, workload: MixedWorkload, gap_txs: int,
                     label: str) -> float:
        """One mixed-traffic phase: wait until `gap_txs` more x509
        submissions succeeded; returns the phase's submit rate."""
        c0 = workload.counts()["x509"]
        t0 = time.monotonic()
        budget = max(30.0, gap_txs * (self.cfg.x509_gap_s + 2.0) * 4)
        while workload.counts()["x509"] < c0 + gap_txs:
            if workload.errors:
                raise SoakError(f"workload failed during {label}: "
                                f"{workload.errors}", self.plan)
            if time.monotonic() - t0 > budget:
                raise SoakError(
                    f"traffic stalled during {label}: "
                    f"{workload.counts()['x509'] - c0}/{gap_txs} txs "
                    f"in {budget:.0f}s", self.plan)
            time.sleep(0.05)
        return gap_txs / max(1e-9, time.monotonic() - t0)

    # -- the run -----------------------------------------------------------

    def run(self) -> Dict:
        if self._root is not None:
            return self._run_in(self._root)
        with tempfile.TemporaryDirectory(prefix="fmt_soak_") as root:
            return self._run_in(root)

    def _run_in(self, root: str) -> Dict:
        cfg = self.cfg
        t_start = time.monotonic()
        trace_t0 = ({k: v["secs"]
                     for k, v in tracing.substage_totals().items()}
                    if tracing.armed() else None)
        # the leak sweep's baseline precedes the world, whose
        # constructor already starts the orderers' workers
        thread_baseline = live_registered()
        world = SoakWorld(root, cfg.seed, n_channels=cfg.n_channels,
                          n_peers=cfg.n_peers, verifier=cfg.verifier,
                          device=cfg.device, sharded=cfg.sharded,
                          relay=cfg.relay)
        workload = MixedWorkload(world, x509_gap_s=cfg.x509_gap_s,
                                 idemix_gap_s=cfg.idemix_gap_s)
        checker = InvariantChecker(
            world, workload, self.plan,
            recovery_window_s=cfg.recovery_window_s,
            min_recovery_frac=cfg.min_recovery_frac,
            thread_baseline=thread_baseline)
        chaos = background_fault_plan(cfg.seed, cfg.fault_p)
        events_report: List[Dict] = []
        rates: List[float] = []
        try:
            with faults.active(chaos):
                world.start()
                self._wait_leaders(world)
                workload.start()
                checker.beat()
                # warmup phase: prove the steady state BEFORE churn
                rates.append(self._run_traffic(
                    workload, max(3, cfg.gap_txs[0]), "warmup"))
                checker.check_converged("warmup", record=False)
                for ev in self.plan.events:
                    rates.append(self._run_traffic(
                        workload, ev.gap_txs, f"pre-{ev.kind}"))
                    ctx = self._fire(world, ev.kind)
                    ctx["recovery_s"] = round(
                        checker.check_converged(ev.kind), 3)
                    post_rate = self._run_traffic(
                        workload, max(3, cfg.gap_txs[0]),
                        f"post-{ev.kind}")
                    checker.check_recovery_rate(ev.kind, rates[-1],
                                                post_rate)
                    ctx["pre_rate"] = round(rates[-1], 2)
                    ctx["post_rate"] = round(post_rate, 2)
                    rates.append(post_rate)
                    self._post_event(world, checker, ctx)
                    if ctx.get("relay_root") is not None:
                        # heal the partitioned root: the returning
                        # minimum reclaims leadership and the tree
                        # reparents AGAIN — that second transition is
                        # the recorded relay_reparent recovery
                        world.heal_relay_leader(world.channel_ids[0],
                                                ctx["relay_root"])
                        ctx["relay_reparent_s"] = round(
                            checker.check_converged("relay_reparent"),
                            3)
                    checker.check_lanes()
                    events_report.append(ctx)
                # tail: stop lanes, settle, audit the whole run
                workload.stop()
                checker.check_converged("final", record=False)
                audited = checker.audit_exactly_once()
                fault_fires = chaos.fires()
                if fault_fires == 0:
                    raise SoakError(
                        "background fault plan never fired — the "
                        "chaos rider is disconnected from its "
                        "injection points", self.plan)
                relay_report = None
                if world.relay:
                    relay_report = world.relay_stats()
                    if relay_report.get("received", 0) == 0:
                        raise SoakError(
                            "relay mode: the dissemination relay "
                            "never carried a block — every peer "
                            "converged via fallback paths only, so "
                            "the tree under test did nothing",
                            self.plan)
        except SoakError:
            raise
        except Exception as e:
            raise SoakError(f"soak run failed: {e!r}", self.plan) from e
        finally:
            try:
                workload.stop()
            except Exception:
                pass
            world.close()
            checker.close_health()
        checker.check_thread_leaks()
        wall = time.monotonic() - t_start
        counts = workload.counts()
        report = {
            "seed": cfg.seed,
            "schedule": [e.to_dict() for e in self.plan.events],
            "events": events_report,
            "wall_secs": round(wall, 2),
            "x509_txs": counts["x509"],
            "idemix_txs": counts["idemix"],
            "idemix_tamper_rejects": counts["idemix_tamper_rejects"],
            "submit_errors": counts["submit_errors"],
            "mixed_tx_per_sec": round(
                (counts["x509"] + counts["idemix"]) / wall, 2),
            "x509_tx_per_sec": round(counts["x509"] / wall, 2),
            "idemix_tx_per_sec": round(counts["idemix"] / wall, 2),
            "audited_txs": audited,
            "fault_fires": fault_fires,
            "recovery_s_by_kind": {
                k: [round(x, 3) for x in v]
                for k, v in checker.recovery_by_kind.items()},
            "peers_final": len(world.peers),
            "channels": world.channel_ids,
            # churn rode the per-peer shard routers
            "sharded": world.sharded,
            # blocks rode dissemination trees
            "relay_mode": world.relay,
        }
        if relay_report is not None:
            report["relay"] = relay_report
        if trace_t0 is not None:
            # commit-path stage attribution across the whole run (the
            # tracer's sub-span totals accumulated since t_start)
            report["stage_attribution"] = {
                k: round(v["secs"] - trace_t0.get(k, 0.0), 3)
                for k, v in tracing.substage_totals().items()}
        log.info("soak: PASS %s", report)
        return report


def run_soak(config: Optional[SoakConfig] = None) -> Dict:
    return SoakHarness(config).run()
