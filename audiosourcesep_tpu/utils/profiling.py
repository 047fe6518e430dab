"""Profiling / tracing hooks (SURVEY.md §5: the reference has only
wall-clock prints; this build adds jax.profiler traces, phase timing and
device-memory readings)."""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict, Optional

import jax


def steady_state(run, *args, reps: int = 2):
    """Shared benchmark harness: time ``run(*args)`` once for the
    first-call cost (compile + first execution), then return the best of
    ``reps`` further calls as the steady-state time.

    ``run`` must wait for its own outputs (``jax.block_until_ready``) —
    dispatch is asynchronous, so otherwise the timings measure the enqueue.
    Returns ``(first_s, steady_s, last_output)``.
    """
    t0 = time.time()
    out = run(*args)
    first = time.time() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = run(*args)
        best = min(best, time.time() - t0)
    return first, best, out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace (viewable in TensorBoard/XProf) when
    ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Named phase wall-clock accumulator; prints a per-phase summary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.time()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.time() - t0)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{name}: {secs:.3f}s ({100 * secs / total:.1f}%)"
                 for name, secs in sorted(self.totals.items(),
                                          key=lambda kv: -kv[1])]
        return "\n".join(lines)


def peak_bytes_in_use(device=None) -> Optional[int]:
    """Peak device memory the process's arrays have taken so far on
    ``device`` (default: this process's first device), or ``None`` where
    the backend keeps no such statistic (the CPU)."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def device_report() -> dict:
    """The devices this process runs on, as JAX reports them."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def nvidia_smi() -> str:
    """The GPUs' names and power limits as ``nvidia-smi`` reports them (a
    card set below its maximum power runs slower under load, so every
    timing is kept beside this line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return (out.stdout or out.stderr).strip()


def annotate(name: str):
    """Decorator adding a named TraceAnnotation around a function (shows up
    in profiler timelines)."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            with jax.profiler.TraceAnnotation(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
