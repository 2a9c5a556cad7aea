"""Deterministic, seedable fault injection.

The port's copy of fabric_mod_tpu/faults/core.py (reference evaluation
model: Raft's leader-crash validation — Ongaro & Ousterhout, ATC '14
§9.2 — crashes are injected at chosen points and recovery is asserted,
rather than waited for).

Code declares named injection points at its fault seams::

    from fabric_mod_tpu_torch import faults
    ...
    faults.point("deliver.stream")         # raises InjectedFault when
                                           # an armed rule triggers

    if faults.point("gossip.comm.drop"):   # drop-mode rules return
        return False                       # True instead of raising

Unarmed (the default), `point()` is one module-attribute read and a
None check, so the seams stay in the code for good.

Plans are armed programmatically::

    plan = faults.FaultPlan().add("deliver.stream", nth=3)
    with faults.active(plan):
        ...                                # the 3rd pass raises

or from the reference's FMT_FAULTS grammar, parsed by
`FaultPlan.parse`::

    faults.arm_spec("deliver.stream:error@n=3;"
                    "gossip.comm.drop:drop@p=0.2,seed=7")

Nothing is read from the environment: nothing arms at import.

Triggers are deterministic: fire-on-Nth-call (`n=K`, 1-based — fires
from the Kth pass on, so `times` caps apply), one-shot (`once` ≡ `n=1`),
or seeded probability (`p=F,seed=S` — a per-rule `random.Random(S)`, so
a given seed yields the same fire pattern on every run).  `times=T`
caps total fires (default 1 for `n`/`once`, unlimited for `p`).
`kind=K` labels the raised fault; in the port no kind degrades
anything: a device fault raises to the caller like any other.
"""
from __future__ import annotations

import contextlib
import functools
import random
import threading
from typing import Dict, List, Optional

from fabric_mod_tpu_torch.faults import points as _points
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

_FIRED_OPTS = MetricOpts(
    "fabric", "faults", "injected_total",
    help="Faults fired by the injection framework, per point (nonzero "
         "outside chaos runs means a fault plan leaked into production).",
    label_names=("point",))


@functools.lru_cache(maxsize=None)
def _fired_counter():
    return default_provider().counter(_FIRED_OPTS)


class InjectedFault(Exception):
    """Raised at an armed injection point; `kind` labels the simulated
    failure class ("fault" by default)."""

    def __init__(self, point: str, kind: str = "fault"):
        super().__init__(f"injected fault at {point!r} (kind={kind})")
        self.point = point
        self.kind = kind


class FaultRule:
    """One armed rule: trigger (nth/probability) + action (error/drop)."""

    __slots__ = ("point", "mode", "kind", "nth", "p", "times", "_rng",
                 "calls", "fires")

    def __init__(self, point: str, mode: str = "error",
                 kind: str = "fault", nth: Optional[int] = None,
                 p: Optional[float] = None, seed: int = 0,
                 times: Optional[int] = None):
        if mode not in ("error", "drop"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if (nth is None) == (p is None):
            raise ValueError("exactly one trigger: nth=K or p=F")
        if nth is not None and nth < 1:
            raise ValueError("nth is 1-based")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError("p must be in [0, 1]")
        self.point = point
        self.mode = mode
        self.kind = kind
        self.nth = nth
        self.p = p
        # nth-triggers default to one-shot; probability rules keep
        # firing (their determinism lives in the seeded rng stream)
        self.times = times if times is not None else \
            (1 if nth is not None else None)
        self._rng = random.Random(seed)
        self.calls = 0                     # passes through the point
        self.fires = 0                     # times this rule triggered

    def evaluate(self) -> bool:
        """One pass through the point: did this rule trigger?  Caller
        holds the plan lock (counters + rng stream are shared state)."""
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.nth is not None:
            # from the Nth pass on, capped by `times`
            hit = self.calls >= self.nth
        else:
            hit = self._rng.random() < self.p
        if hit:
            self.fires += 1
        return hit

    def make_exception(self) -> Exception:
        return InjectedFault(self.point, self.kind)


class FaultPlan:
    """A set of rules keyed by injection point; armable as a unit."""

    def __init__(self):
        self._rules: Dict[str, List[FaultRule]] = {}
        self._lock = threading.Lock()

    def add(self, point: str, mode: str = "error", kind: str = "fault",
            nth: Optional[int] = None, p: Optional[float] = None,
            seed: int = 0,
            times: Optional[int] = None) -> "FaultPlan":
        """Add one rule; returns self for chaining.  With neither `nth`
        nor `p` the trigger is `nth=1`."""
        if nth is None and p is None:
            nth = 1
        rule = FaultRule(point, mode=mode, kind=kind, nth=nth, p=p,
                         seed=seed, times=times)
        with self._lock:
            self._rules.setdefault(point, []).append(rule)
        return self

    def evaluate(self, point: str) -> Optional[FaultRule]:
        """The armed-path hit test: first triggering rule, or None."""
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return None
            for rule in rules:
                if rule.evaluate():
                    return rule
        return None

    def fires(self, point: Optional[str] = None) -> int:
        """Total fires, per point or across the plan."""
        with self._lock:
            rules = (self._rules.get(point, []) if point is not None
                     else [r for rs in self._rules.values() for r in rs])
            return sum(r.fires for r in rules)

    def calls(self, point: str) -> int:
        with self._lock:
            return sum(r.calls for r in self._rules.get(point, []))

    def validate(self) -> "FaultPlan":
        """Check every rule's point against faults/points.py; an unknown
        name raises instead of arming a rule that never fires."""
        with self._lock:
            unknown = sorted(p for p in self._rules
                             if not _points.is_declared(p))
        if unknown:
            raise ValueError(
                f"fault plan names unknown injection point(s) "
                f"{unknown} (known: {sorted(_points.DECLARED_POINTS)})")
        return self

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the reference's FMT_FAULTS grammar:
        ``point:mode@trigger[,opt...][;rule...]`` where trigger is
        ``n=K`` | ``once`` | ``p=F`` and opts are ``seed=S``,
        ``times=T``, ``kind=K``.  A malformed rule raises."""
        plan = cls()
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                head, _, trig = raw.partition("@")
                point, _, mode = head.partition(":")
                kw: dict = {"mode": mode or "error"}
                for part in (trig or "once").split(","):
                    part = part.strip()
                    if part == "once":
                        kw["nth"] = 1
                    elif part.startswith("n="):
                        kw["nth"] = int(part[2:])
                    elif part.startswith("p="):
                        kw["p"] = float(part[2:])
                    elif part.startswith("seed="):
                        kw["seed"] = int(part[5:])
                    elif part.startswith("times="):
                        kw["times"] = int(part[6:])
                    elif part.startswith("kind="):
                        kw["kind"] = part[5:]
                    else:
                        raise ValueError(f"unknown option {part!r}")
                plan.add(point.strip(), **kw)
            except Exception as e:
                raise ValueError(f"bad fault rule {raw!r}: {e}") from e
        return plan


# -- the module-level arming gate --------------------------------------------

_plan: Optional[FaultPlan] = None


def armed() -> bool:
    return _plan is not None


def current_plan() -> Optional[FaultPlan]:
    return _plan


def arm(plan: FaultPlan) -> None:
    """Arm a plan process-wide."""
    global _plan
    _plan = plan


def disarm() -> None:
    global _plan
    _plan = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped arming."""
    global _plan
    prev = _plan
    _plan = plan
    try:
        yield plan
    finally:
        _plan = prev


def point(name: str) -> bool:
    """The injection seam.  Unarmed: one None check, returns False.
    Armed: if a rule for `name` triggers, raise its exception
    (mode="error") or return True (mode="drop": the caller drops the
    unit of work it was about to process)."""
    plan = _plan
    if plan is None:
        return False
    rule = plan.evaluate(name)
    if rule is None:
        return False
    _fired_counter().with_labels(name).add(1)
    # a flight-recorder breadcrumb (tracer armed only)
    tracing.note_event("fault", f"{name} (kind={rule.kind})")
    tracing.auto_dump(f"fault[{name}]")
    if rule.mode == "error":
        raise rule.make_exception()
    return True


def arm_spec(spec: str) -> FaultPlan:
    """Parse, validate and arm a plan in the FMT_FAULTS grammar."""
    plan = FaultPlan.parse(spec).validate()
    arm(plan)
    return plan
