"""Decode-loop sampling profiler: always-on, low-rate, bounded memory.

Port of ``seldon_core_tpu/telemetry/profile.py``, unchanged.

The flight recorder's phase timers (telemetry/flight.py) answer "WHICH
host segment ate the round's gap"; they cannot answer "which Python
frames INSIDE that segment" without instrumenting every function — the
Google-Wide-Profiling observation that a continuous low-rate sampler is
the cheapest way to keep that answer on hand in production. This module
is that sampler for the decode loop:

- a daemon thread wakes at ``hz`` (default 19 — an off-beat rate so the
  sampler never phase-locks with the scheduler's own timers), grabs the
  TARGET thread's current stack via ``sys._current_frames()`` (no
  signals, no interpreter switches — safe from any thread), folds it
  into a ``frame;frame;frame`` key, and bumps a counter;
- the folded-stack table is BOUNDED (``ENGINE_DECODE_PROFILE_TABLE``,
  default 512 entries): novel stacks past the cap count into
  ``truncated`` instead of growing memory, so a long-lived process holds
  a fixed footprint regardless of workload shape;
- the decode scheduler registers its loop's thread at startup
  (``watch_decode_thread()``), and ``GET /decode/profile`` serves top
  self-time frames + the folded table (the exact input ``flamegraph.pl``
  / speedscope take).

Cost: one ``sys._current_frames()`` + one dict bump per tick — at 19 Hz
that is microseconds per second, invisible next to a single decode
dispatch. Kill switch ``ENGINE_DECODE_PROFILE=off``; rate knob
``ENGINE_DECODE_PROFILE_HZ``.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time

from seldon_core_tpu_torch.utils.env import (
    ENGINE_DECODE_PROFILE,
    ENGINE_DECODE_PROFILE_HZ,
    ENGINE_DECODE_PROFILE_TABLE,
)

_DEFAULT_HZ = 19.0
_MAX_HZ = 1000.0
_DEFAULT_TABLE = 512
_MAX_DEPTH = 64  # folded frames per stack (outermost dropped past this)


def profile_enabled(env: dict | None = None) -> bool:
    env = env if env is not None else os.environ
    return str(env.get(ENGINE_DECODE_PROFILE, "on")).strip().lower() not in (
        "off",
        "0",
        "false",
    )


def _env_hz(env: dict | None = None) -> float:
    env = env if env is not None else os.environ
    try:
        hz = float(env.get(ENGINE_DECODE_PROFILE_HZ, _DEFAULT_HZ))
    except (TypeError, ValueError):
        hz = _DEFAULT_HZ
    return min(max(hz, 0.1), _MAX_HZ) if hz > 0 else _DEFAULT_HZ


def _env_table(env: dict | None = None) -> int:
    env = env if env is not None else os.environ
    try:
        n = int(env.get(ENGINE_DECODE_PROFILE_TABLE, _DEFAULT_TABLE))
    except (TypeError, ValueError):
        n = _DEFAULT_TABLE
    return max(n, 16)


def _frame_label(frame) -> str:
    """``package/module:function`` for one stack frame — the parent
    directory disambiguates same-named modules (every package's
    ``__init__``, ``core.py`` twins) while a 64-deep folded key stays a
    few hundred bytes."""
    fn = frame.f_code.co_filename
    base = os.path.splitext(os.path.basename(fn))[0]
    parent = os.path.basename(os.path.dirname(fn))
    label = f"{parent}/{base}" if parent else base
    return f"{label}:{frame.f_code.co_name}"


def fold_stack(frame, max_depth: int = _MAX_DEPTH) -> str:
    """Fold a frame chain into the flamegraph convention: outermost
    first, ``;``-separated, leaf (the currently-executing frame) last."""
    labels: list[str] = []
    while frame is not None and len(labels) < max_depth:
        labels.append(_frame_label(frame))
        frame = frame.f_back
    labels.reverse()
    return ";".join(labels)


class StackProfiler:
    """Continuous folded-stack sampler over ONE target thread.

    Single daemon writer; readers take the lock only for snapshot copies,
    so the read-out route never blocks the sampler for more than a
    table copy. ``watch()`` can retarget a live profiler (the scheduler
    re-registers its loop thread whenever the loop task starts)."""

    def __init__(
        self,
        hz: float = 0.0,
        max_entries: int = 0,
        enabled: bool | None = None,
    ):
        self.hz = float(hz) if hz > 0 else _env_hz()
        self.max_entries = int(max_entries) if max_entries > 0 else _env_table()
        self.enabled = profile_enabled() if enabled is None else bool(enabled)
        self.samples = 0  # ticks that found the target thread's stack
        self.missed = 0  # ticks where the target thread had no frame
        self.truncated = 0  # samples dropped by the table entry cap
        self.started_ns = 0
        self._target_ident: int | None = None
        self._table: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ control
    def watch(self, ident: int) -> None:
        """Set the thread the sampler walks (a ``threading.get_ident()``
        value — the decode loop's event-loop thread in serving)."""
        self._target_ident = int(ident)

    def set_hz(self, hz: float) -> float:
        """Retune the sampling rate (clamped to (0, 1000]); returns the
        effective rate. The sampler picks it up on its next tick."""
        self.hz = min(max(float(hz), 0.1), _MAX_HZ)
        return self.hz

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Spawn the daemon sampler (idempotent). Returns False when the
        kill switch disabled profiling — the caller's behavior must not
        depend on the profiler existing."""
        if not self.enabled:
            return False
        if self.running:
            return True
        self._stop.clear()
        self.started_ns = time.perf_counter_ns()
        self._thread = threading.Thread(
            target=self._run, name="decode-profile", daemon=True
        )
        self._thread.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def clear(self) -> None:
        with self._lock:
            self._table.clear()
            self.samples = 0
            self.missed = 0
            self.truncated = 0

    # ------------------------------------------------------------ sampler
    def _run(self) -> None:
        while not self._stop.wait(1.0 / self.hz):
            ident = self._target_ident
            if ident is None:
                continue
            frame = sys._current_frames().get(ident)
            if frame is None:
                self.missed += 1
                continue
            self._ingest(fold_stack(frame))

    def _ingest(self, key: str) -> None:
        """One folded sample into the bounded table (split out so the
        bound/overflow contract is unit-testable without threads)."""
        with self._lock:
            self.samples += 1
            if key in self._table:
                self._table[key] += 1
            elif len(self._table) < self.max_entries:
                self._table[key] = 1
            else:
                self.truncated += 1

    # ------------------------------------------------------------ readout
    def folded(self) -> list[str]:
        """The bounded table as ``stack count`` lines — the flamegraph
        input format, hottest stacks first."""
        with self._lock:
            items = sorted(self._table.items(), key=lambda kv: -kv[1])
        return [f"{stack} {count}" for stack, count in items]

    def report(self, n: int = 30) -> dict:
        """The GET /decode/profile body: sampler state, top-``n`` frames
        by SELF time (leaf-frame attribution), and the folded table."""
        with self._lock:
            table = dict(self._table)
            samples = self.samples
        self_counts: dict[str, int] = {}
        for stack, count in table.items():
            leaf = stack.rsplit(";", 1)[-1]
            self_counts[leaf] = self_counts.get(leaf, 0) + count
        top = sorted(self_counts.items(), key=lambda kv: -kv[1])[: max(n, 0)]
        return {
            "enabled": self.enabled,
            "running": self.running,
            "hz": self.hz,
            "samples": samples,
            "missed": self.missed,
            "truncated_samples": self.truncated,
            "table_entries": len(table),
            "table_cap": self.max_entries,
            "duration_s": (
                round((time.perf_counter_ns() - self.started_ns) / 1e9, 1)
                if self.started_ns
                else 0.0
            ),
            "top": [
                {
                    "frame": frame,
                    "self_samples": count,
                    "fraction": round(count / samples, 4) if samples else 0.0,
                }
                for frame, count in top
            ],
            "folded": [
                f"{stack} {count}"
                for stack, count in sorted(table.items(), key=lambda kv: -kv[1])
            ],
        }


# ------------------------------------------------------------------ global

_PROFILER: StackProfiler | None = None
_PROFILER_LOCK = threading.Lock()
_WATCHERS = 0  # decode loops between watch_decode_thread() and unwatch_decode_thread()


def get_profiler() -> StackProfiler:
    """The process-global profiler GET /decode/profile reads (one sampler
    per process — every scheduler's loop shares the event-loop thread)."""
    global _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            _PROFILER = StackProfiler()
        return _PROFILER


def watch_decode_thread() -> StackProfiler:
    """Register the CALLING thread as the sampling target and start the
    process profiler — the decode scheduler calls this as its loop task
    begins, so sampling is always-on without any operator action (a
    no-op under ENGINE_DECODE_PROFILE=off)."""
    global _WATCHERS
    prof = get_profiler()
    with _PROFILER_LOCK:
        _WATCHERS += 1
    prof.watch(threading.get_ident())
    prof.start()
    return prof


def unwatch_decode_thread() -> None:
    """A decode loop's close: the last loop to go stops the sampler thread
    and joins it (the table stays readable). A daemon thread left running
    is killed mid-call when the interpreter finalises, which can abort the
    process at exit."""
    global _WATCHERS
    with _PROFILER_LOCK:
        _WATCHERS = max(0, _WATCHERS - 1)
        prof = _PROFILER if _WATCHERS == 0 else None
    if prof is not None:
        prof.stop()


@atexit.register
def _stop_at_exit() -> None:
    """Join the sampler of a decode loop that was never closed, before the
    interpreter finalises."""
    if _PROFILER is not None:
        _PROFILER.stop()
