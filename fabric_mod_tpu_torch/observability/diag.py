"""Diagnostics: on-demand thread dumps and a sampling profile.

The port's copy of fabric_mod_tpu/observability/diag.py (reference:
common/diag/goroutine.go and internal/peer/node/signals.go — SIGUSR1
logs every goroutine's stack on a running node — and the pprof
endpoints of the operations server).
"""
from __future__ import annotations

import collections
import faulthandler
import io
import signal
import sys
import threading
import time
import traceback


def dump_threads(file=None) -> str:
    """All thread stacks as text (and written to `file` if given)."""
    out = io.StringIO()
    frames = sys._current_frames()
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        out.write(f"--- thread {thread.name} "
                  f"(daemon={thread.daemon})\n")
        if frame is not None:
            traceback.print_stack(frame, file=out)
    text = out.getvalue()
    if file is not None:
        file.write(text)
        file.flush()
    return text


def install_signal_dump(sig=signal.SIGUSR1) -> None:
    """`sig` -> every thread's stack on stderr (reference: signals.go).
    `faulthandler.unregister(sig)` removes it."""
    faulthandler.register(sig, file=sys.stderr, all_threads=True)


def sample_profile(seconds: float = 5.0, hz: float = 100.0) -> str:
    """Sampling CPU profile: collapsed-stack text, one line per unique
    (thread, stack) with its sample count — the flamegraph/pprof
    interchange format.

    A wall-clock sampler over sys._current_frames(): it observes every
    thread but its own, costs one stack walk a thread a tick, and needs
    no native agent.  Blocking: callers run it from a request thread."""
    interval = 1.0 / hz
    counts: collections.Counter = collections.Counter()
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    n_samples = 0
    while time.monotonic() < deadline:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            if ident == me:
                continue                   # not the profiler itself
            stack = []
            while frame is not None:
                code = frame.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}"
                             f":{frame.f_lineno})")
                frame = frame.f_back
            counts[(names.get(ident, str(ident)),
                    ";".join(reversed(stack)))] += 1
        n_samples += 1
        time.sleep(interval)
    out = io.StringIO()
    out.write(f"# wall-clock samples: {n_samples} at {hz:g} Hz over "
              f"{seconds:g}s; lines are collapsed stacks "
              f"(flamegraph.pl compatible)\n")
    for (tname, stack), n in counts.most_common():
        out.write(f"{tname};{stack} {n}\n")
    return out.getvalue()
