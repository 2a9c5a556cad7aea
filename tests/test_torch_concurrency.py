"""The port's worker-thread registry (fabric_mod_tpu_torch/concurrency/),
against the reference's concurrency/threads.py.

- `RegisteredThread` registers while alive and deregisters when it
  returns; `assert_joined` raises RaceError naming a leaked worker only
  with the guards armed (`enable`/`armed`, never the environment);
  `CancellationEvent` runs its wake hooks on set.
- Every worker the port starts is a RegisteredThread: an AST scan finds
  no `threading.Thread(` call in the port, and each `RegisteredThread(`
  call names the `structure` its reference counterpart (same module)
  uses.  A BatchingVerifyService's two workers show in
  `live_registered()` under that structure until close().
"""
import ast
import pathlib
import threading
import time

import pytest

from fabric_mod_tpu_torch import concurrency
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.concurrency import (CancellationEvent, RaceError,
                                              RegisteredThread, assert_joined,
                                              live_registered)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_registered_thread_lifecycle_and_leak_check():
    gate = threading.Event()
    t = RegisteredThread(target=gate.wait, name="t-worker", args=(10,))
    assert t.structure == "t-worker" and t.daemon
    assert t not in live_registered()
    t.start()
    assert t in live_registered()
    assert not concurrency.enabled()
    assert_joined([t], owner="t-owner", timeout=0.05)     # unarmed: silent
    with concurrency.armed():
        assert concurrency.enabled()
        with pytest.raises(RaceError, match="'t-worker'"):
            assert_joined([t], owner="t-owner", timeout=0.05)
        gate.set()
        assert_joined([t], owner="t-owner", timeout=5)
    assert not concurrency.enabled()
    assert t not in live_registered()
    concurrency.enable(True)
    try:
        assert_joined([threading.current_thread()], owner="self")
    finally:
        concurrency.enable(False)


def test_cancellation_event_runs_hooks():
    ev = CancellationEvent()
    fired = []
    unhook = ev.on_set(lambda: fired.append(1))
    ev.on_set(lambda: 1 / 0)              # a broken hook never masks it
    ev.set()
    assert ev.is_set() and fired == [1]
    unhook()
    ev.on_set(lambda: fired.append(2))    # already set: fires at once
    assert fired == [1, 2]


def _calls(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == name) or \
                    (isinstance(f, ast.Attribute) and f.attr == name):
                yield node


def _structures(path):
    out = []
    for node in _calls(ast.parse(path.read_text()), "RegisteredThread"):
        kw = {k.arg: k.value for k in node.keywords}
        val = kw.get("structure")
        out.append(val.value if isinstance(val, ast.Constant) else None)
    return out


def test_every_port_worker_is_registered_under_the_references_structure():
    port = REPO / "fabric_mod_tpu_torch"
    ref = REPO / "fabric_mod_tpu"
    plain, registered = [], 0
    for path in sorted(port.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in _calls(tree, "Thread"):
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "threading":
                plain.append(f"{path.relative_to(REPO)}:{node.lineno}")
        mine = _structures(path)
        registered += len(mine)
        twin = ref / path.relative_to(port)
        if mine and twin.exists():
            theirs = set(_structures(twin))
            if theirs - {None}:
                assert set(mine) <= theirs, (path, mine, theirs)
    assert plain == []
    # the 19 worker sites of the port's modules and the soak's three
    assert registered == 22


def test_verify_service_workers_are_swept():
    svc = gpu.BatchingVerifyService(sw.SwVerifier())
    mine = [svc._worker, svc._resolver]
    live = live_registered()
    assert all(t in live for t in mine)
    assert sorted(t.name for t in mine) == ["verify-flusher",
                                           "verify-resolver"]
    assert {t.structure for t in mine} == {"BatchingVerifyService"}
    svc.close()
    deadline = time.monotonic() + 5
    while any(t in live_registered() for t in mine):
        assert time.monotonic() < deadline
        time.sleep(0.01)
