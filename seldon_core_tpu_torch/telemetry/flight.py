"""Decode-loop flight recorder: always-on, fixed-memory round attribution.

Port of ``seldon_core_tpu/telemetry/flight.py``, unchanged. On the card a
dispatch is a CUDA-graph replay (or an eager launch sequence) queued on the
stream: its enqueue returns before the device finishes, and the blocked
readback (``.cpu()``) is where the host waits, which is the enqueue/readback
split below. ``overlap_ns`` is the pipelined loop's window, timed by the
``PhaseTimer``'s overlap mode (0 on the serial loop).

Request-scoped tracing covers the graph tier, but the decode loop's unit
of work is the ROUND, not the request: one fused dispatch serves every slot,
so "where did the last 500 rounds go" (device busy vs host bubble, admission
stalls, adaptive-depth degrades) is invisible to per-request spans and too
fine-grained for the coarse ``stat_*`` counters. This module is the
substrate between the two: every scheduler round appends ONE compact frame
to a bounded ring —

- round mode (``plain`` / ``chain`` / ``tree`` / ``chunk``), generating +
  prefilling slot counts, queue depth;
- admissions / retirements this round and the blocked-admission cause
  (``pages``: the page pool could not guarantee the reservation;
  ``slots``: every slot occupied);
- tokens emitted, speculation accepted/proposed and the effective depth the
  adaptive controller chose;
- per-dispatch wall time split **device-busy vs host-gap** ("bubble"), the
  busy side attributed per fused program family
  (``chunk``/``step``/``draft``/``verify``/``copy``) and split again into
  **enqueue vs blocked readback** per family (``rdb_ns``), so on
  async-dispatch backends the draft no longer masquerades as free and the
  verify column no longer absorbs the whole round pair's wait;
  ``ENGINE_FLIGHT_SYNC_TIMING=on`` forces per-dispatch completion for
  ground-truth calibration runs;
- the host gap attributed per **phase** (``PHASES`` / ``P_*``: admission
  incl. prefix match and allocator reservation, chunk-result scatter, the
  emission/SLO walk, the spec accept walk, the sampled-token walk, the
  round commit itself) via the scheduler's ``with self._phase(P_X):``
  blocks over a :class:`PhaseTimer` — the decomposition the pipelined
  decode loop was designed against;
- ``overlap_ns``: host work the PIPELINED round loop ran INSIDE a
  dispatch's busy window (round N+1's admission decisions under round N's
  in-flight step — serving/decode_scheduler.py). Overlapped work sits in
  busy, not gap, so pipelining genuinely shrinks ``bubble_fraction``; the
  aggregate's ``overlap_of_gap`` / ``bubble_residual`` split the would-be
  serial gap into hidden vs still-exposed;
- the page pool's free/live/prefix page counts and the round's CoW copies.

Append is O(1) (one ``__slots__`` object + a ring store + a handful of
integer adds) with a measured budget of a few µs/round
(``measure_overhead``; the tier-1 guard test pins it). Memory is fixed:
``capacity`` frames regardless of uptime. ``ENGINE_FLIGHT=off`` is the kill
switch (``record`` becomes a no-op; the scheduler's behavior is unchanged).

Layered on top:

- **goodput / SLO attainment**: running counters of tokens delivered to
  requests that met their ``deadline_ms`` vs breached it, and TTFT/ITL
  attainment fractions against ``tpu.decode_slo_{ttft,itl}_ms`` — the
  signals an SLO-tiered scheduler or a reward-driven router consumes
  (ROADMAP), exported as metrics by the scheduler.
- **auto-dump**: on a round error or an SLO breach the recent ring is
  dumped into the telemetry span store as a force-retained trace (one
  ``decode.flight`` root span, one event per frame), so the frames AROUND
  a breach survive the ring's wraparound and a metric exemplar can link
  the breach to them.
- **read-out**: ``GET /decode/flight`` (recent frames + windowed
  aggregates) and ``GET /decode/health`` on the predictor's ingress read
  the process-global registry (one recorder per scheduler, keyed by
  deployment name).
"""

from __future__ import annotations

import os
import time


from seldon_core_tpu_torch.utils.env import (
    ENGINE_DECODE_PIPELINE,
    ENGINE_FLIGHT,
    ENGINE_FLIGHT_FRAMES,
    ENGINE_FLIGHT_SYNC_TIMING,
)

# fused program families a round's device-busy time is attributed to; the
# indices are the positions in FlightFrame.busy_ns
FAMILIES = ("chunk", "step", "draft", "verify", "copy")
F_CHUNK, F_STEP, F_DRAFT, F_VERIFY, F_COPY = range(5)

# host phases a round's GAP is attributed to; the indices are the
# positions in FlightFrame.phase_ns. Every timer site names one of these
# constants, and every constant is instrumented by the scheduler.
PHASES = (
    "admit",  # admission walk: slot assignment, queue-timeout expiry
    "prefix_match",  # PrefixIndex longest-common-prefix lookup
    "alloc",  # PageAllocator reservation/prepare_write + block tables
    "scatter",  # chunk-result scatter: prefill cursors, transitions
    "emit_slo",  # _emit: streaming callback, TTFT/ITL + SLO judging
    "accept_walk",  # spec accept/rollback walk over the verify readback
    "sampling",  # plain-step sampled-token walk (readback consumption)
    "commit",  # _commit_round itself: stats, metrics, frame build
)
(
    P_ADMIT,
    P_PREFIX_MATCH,
    P_ALLOC,
    P_SCATTER,
    P_EMIT_SLO,
    P_ACCEPT_WALK,
    P_SAMPLING,
    P_COMMIT,
) = range(8)
N_PHASES = len(PHASES)
_ZERO_PHASES = (0,) * N_PHASES
_ZERO_FAMILIES = (0,) * len(FAMILIES)

_DEFAULT_CAPACITY = 2048
# frames carried per auto-dump (span events are capped at
# MAX_EVENTS_PER_SPAN=128 per span; stay under it with headroom)
DUMP_FRAMES = 64


def flight_enabled(env: dict | None = None) -> bool:
    env = env if env is not None else os.environ
    return str(env.get(ENGINE_FLIGHT, "on")).strip().lower() not in (
        "off",
        "0",
        "false",
    )


def sync_timing_enabled(env: dict | None = None) -> bool:
    """ENGINE_FLIGHT_SYNC_TIMING=on: force per-dispatch completion so each
    family's flight column is ground-truth device wall (calibration runs;
    default off — async dispatch stays pipelined)."""
    env = env if env is not None else os.environ
    return str(env.get(ENGINE_FLIGHT_SYNC_TIMING, "off")).strip().lower() in (
        "on",
        "1",
        "true",
    )


def decode_pipeline_enabled(env: dict | None = None) -> bool:
    """ENGINE_DECODE_PIPELINE=off: force the scheduler's SERIAL round loop
    (round N+1's host phases wait for round N's readback). Default on.
    Independent of — but composed with — sync timing: the scheduler also
    forces serial under ENGINE_FLIGHT_SYNC_TIMING, since ground-truth
    per-dispatch timing needs the unpipelined loop."""
    env = env if env is not None else os.environ
    return str(env.get(ENGINE_DECODE_PIPELINE, "on")).strip().lower() not in (
        "off",
        "0",
        "false",
    )


def _env_capacity(env: dict | None = None) -> int:
    env = env if env is not None else os.environ
    try:
        n = int(env.get(ENGINE_FLIGHT_FRAMES, _DEFAULT_CAPACITY))
    except (TypeError, ValueError):
        n = _DEFAULT_CAPACITY
    return max(n, 16)


class _PhaseCtx:
    """Reusable ``with`` handle for one phase index (preallocated by the
    timer — no per-entry allocation on the hot path)."""

    __slots__ = ("timer", "p")

    def __init__(self, timer: "PhaseTimer", p: int):
        self.timer = timer
        self.p = p

    def __enter__(self):
        t = self.timer
        now = time.perf_counter_ns()
        stack = t._stack
        if stack:
            t._acct(stack[-1], now - t._mark)
        stack.append(self.p)
        t._mark = now
        return self

    def __exit__(self, *exc):
        t = self.timer
        now = time.perf_counter_ns()
        if t._stack:
            # a reset() issued while a phase is open (defensive: the
            # scheduler never does) drops the span instead of raising
            # into the decode loop
            t._acct(t._stack.pop(), now - t._mark)
        t._mark = now
        return False


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


class PhaseTimer:
    """Per-round host-phase accumulator behind the scheduler's
    ``with self._phase(P_X):`` blocks: a fixed ``ns`` array aligned with
    PHASES, reset at ``_round_reset`` and frozen into each FlightFrame at
    ``_commit_round``. Nested phases attribute to the INNERMOST phase
    (self-time semantics — an ``_emit`` inside the accept walk counts as
    ``emit_slo``, not twice), so phase sums stay <= the round's gap.
    Disabled (the ENGINE_FLIGHT kill switch) every handle is a shared
    no-op and the arrays stay zero."""

    __slots__ = ("ns", "enabled", "overlap_ns", "_overlap", "_stack", "_mark", "_ctxs")

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.ns = [0] * N_PHASES
        # overlap mode (begin_overlap/end_overlap): phase segments timed
        # while the pipelined loop runs host work UNDER an in-flight
        # dispatch accrue here instead of the per-phase array — that wall
        # sits inside the round's device-busy window, so booking it into
        # ``ns`` would break sum(phase) <= gap
        self.overlap_ns = 0
        self._overlap = False
        self._stack: list[int] = []
        self._mark = 0
        self._ctxs = tuple(_PhaseCtx(self, p) for p in range(N_PHASES))

    def _acct(self, p: int, dt: int) -> None:
        if self._overlap:
            self.overlap_ns += dt
        else:
            self.ns[p] += dt

    def begin_overlap(self) -> None:
        self._overlap = True

    def end_overlap(self) -> None:
        self._overlap = False

    def phase(self, p: int):
        """The ``with``-handle for phase ``p`` (a P_* constant)."""
        if not self.enabled:
            return _NOOP_CTX
        return self._ctxs[p]

    def reset(self) -> None:
        self.ns = [0] * N_PHASES
        self.overlap_ns = 0
        self._overlap = False
        self._stack.clear()

    def commit(self, p: int, t0_ns: int) -> tuple:
        """Attribute ``now - t0_ns`` to phase ``p`` (the commit point's own
        cost) and return the frozen per-phase tuple for the frame (the
        ~µs frame build/record after this call lands in the NEXT round's
        gap unattributed — measured, documented, and far under the
        recorder's own budget)."""
        self.ns[p] += time.perf_counter_ns() - t0_ns
        return tuple(self.ns)

    @staticmethod
    def measure_overhead(n: int = 2000, phases_per_round: int = 8) -> float:
        """Measured per-round phase-timer cost in µs (``phases_per_round``
        enter/exit pairs incl. one nested pair) — what the guard test budgets
        beside the frame-append cost."""
        t = PhaseTimer(enabled=True)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            for p in range(max(phases_per_round - 2, 1)):
                with t.phase(p % N_PHASES):
                    pass
            with t.phase(P_ACCEPT_WALK):
                with t.phase(P_EMIT_SLO):
                    pass
            t.reset()
        return round((time.perf_counter_ns() - t0) / n / 1e3, 3)


class FlightFrame:
    """One scheduler round, compact. ``busy_ns`` is a 5-tuple aligned with
    FAMILIES (enqueue + blocked readback per family); ``rdb_ns`` the
    blocked-readback share of each family (enqueue = busy - rdb);
    ``phase_ns`` the host gap attributed per PHASES entry; ``gap_ns`` the
    round's host bubble (wall - device busy); ``overlap_ns`` the host work
    the PIPELINED loop ran inside a dispatch's busy window (hidden under
    the in-flight dispatch — inside busy, NOT part of the gap, which is
    exactly why pipelining shrinks bubble_fraction); ``probe`` marks a
    DELIBERATE exploration round of the speculation controller (the
    depth-1 recovery probe while degraded, the full-shape width probe
    while narrowed) — aggregates report these apart so exploration is
    never read as genuine accept degradation; ``spec_widths`` the tuned
    per-depth width ceiling the round ran under (tree rounds only);
    ``promotions`` the prefix entries promoted device-ward from the slow
    KV tiers (host/store/sibling) during the round's admissions."""

    __slots__ = (
        "seq", "t_ns", "mode", "active", "prefilling", "queued",
        "admitted", "retired", "blocked", "tokens", "accepted", "proposed",
        "spec_depth", "busy_ns", "gap_ns", "kv_free", "kv_live",
        "kv_prefix", "cow", "phase_ns", "rdb_ns", "overlap_ns",
        "probe", "spec_widths", "promotions",
    )

    def __init__(
        self, seq, t_ns, mode, active, prefilling, queued, admitted,
        retired, blocked, tokens, accepted, proposed, spec_depth,
        busy_ns, gap_ns, kv_free, kv_live, kv_prefix, cow,
        phase_ns=_ZERO_PHASES, rdb_ns=_ZERO_FAMILIES, overlap_ns=0,
        probe=False, spec_widths=(), promotions=0,
    ):
        self.seq = seq
        self.t_ns = t_ns
        self.mode = mode
        self.active = active
        self.prefilling = prefilling
        self.queued = queued
        self.admitted = admitted
        self.retired = retired
        self.blocked = blocked
        self.tokens = tokens
        self.accepted = accepted
        self.proposed = proposed
        self.spec_depth = spec_depth
        self.busy_ns = busy_ns
        self.gap_ns = gap_ns
        self.kv_free = kv_free
        self.kv_live = kv_live
        self.kv_prefix = kv_prefix
        self.cow = cow
        self.phase_ns = phase_ns
        self.rdb_ns = rdb_ns
        self.overlap_ns = overlap_ns
        self.probe = probe
        self.spec_widths = spec_widths
        self.promotions = promotions

    def to_dict(self) -> dict:
        d: dict = {
            "seq": self.seq,
            "t_ns": self.t_ns,
            "mode": self.mode,
            "active": self.active,
            "prefilling": self.prefilling,
            "queued": self.queued,
            "tokens": self.tokens,
            "busy_us": {
                FAMILIES[i]: round(ns / 1e3, 1)
                for i, ns in enumerate(self.busy_ns)
                if ns
            },
            "gap_us": round(self.gap_ns / 1e3, 1),
            "kv": [self.kv_free, self.kv_live, self.kv_prefix],
        }
        if any(self.rdb_ns):
            # enqueue/readback split per family: enq = busy - rdb; both
            # emitted so a dump reads without arithmetic
            d["enq_us"] = {
                FAMILIES[i]: round((self.busy_ns[i] - ns) / 1e3, 1)
                for i, ns in enumerate(self.rdb_ns)
                if self.busy_ns[i]
            }
            d["rdb_us"] = {
                FAMILIES[i]: round(ns / 1e3, 1)
                for i, ns in enumerate(self.rdb_ns)
                if ns
            }
        if any(self.phase_ns):
            d["phase_us"] = {
                PHASES[i]: round(ns / 1e3, 1)
                for i, ns in enumerate(self.phase_ns)
                if ns
            }
        if self.overlap_ns:
            d["overlap_us"] = round(self.overlap_ns / 1e3, 1)
        if self.admitted:
            d["admitted"] = self.admitted
        if self.retired:
            d["retired"] = self.retired
        if self.blocked:
            d["blocked"] = self.blocked
        if self.proposed:
            d["accepted"] = self.accepted
            d["proposed"] = self.proposed
            d["spec_depth"] = self.spec_depth
        if self.spec_widths:
            d["widths"] = list(self.spec_widths)
        if self.probe:
            d["probe"] = True
        if self.cow:
            d["cow"] = self.cow
        if self.promotions:
            d["promotions"] = self.promotions
        return d


class FlightRecorder:
    """Bounded ring of FlightFrames + O(1) running aggregates.

    Single-writer (the decode loop's task); readers (the ingress read-out
    routes, load summaries) take best-effort snapshots — frames are immutable
    once recorded and ring-slot assignment is atomic under the GIL, so a
    concurrent read sees a consistent frame set without a lock on the hot
    append path."""

    def __init__(
        self,
        *,
        n_slots: int = 1,
        name: str = "decode",
        capacity: int = 0,
        enabled: bool | None = None,
        slo_ttft_ms: float = 0.0,
        slo_itl_ms: float = 0.0,
        dump_interval_s: float = 5.0,
        replica_id: int = 0,
    ):
        self.name = name or "decode"
        self.n_slots = max(int(n_slots), 1)
        # multi-replica decode scale-out (serving/affinity_router.py): which
        # replica of its deployment this recorder observes, and a live O(1)
        # queue-depth read the affinity router's bounded-load shed polls
        # through /decode/health (None falls back to the last frame's
        # queued count)
        self.replica_id = int(replica_id)
        self.queue_depth_source = None
        # fleet health (serving/affinity_router.py): lifecycle state and
        # consecutive health-probe misses, written by the router's
        # _set_replica_state funnel / poll sweep and surfaced through
        # /decode/health so an operator sees WHY an arm stopped serving
        self.replica_state = "up"
        self.consecutive_misses = 0
        self.capacity = int(capacity) or _env_capacity()
        self.enabled = flight_enabled() if enabled is None else bool(enabled)
        self.slo_ttft_ms = float(slo_ttft_ms)
        self.slo_itl_ms = float(slo_itl_ms)
        self.dump_interval_s = float(dump_interval_s)
        self._frames: list[FlightFrame | None] = [None] * self.capacity
        self._n = 0  # total frames ever recorded
        # O(1) running totals (the health read-out must not walk the ring)
        self.busy_ns_total = [0] * len(FAMILIES)
        self.rdb_ns_total = [0] * len(FAMILIES)
        self.phase_ns_total = [0] * N_PHASES
        self.gap_ns_total = 0
        self.overlap_ns_total = 0
        self.tokens_total = 0
        self.occupancy_sum = 0.0
        self.admitted_total = 0
        self.retired_total = 0
        self.promotions_total = 0
        self.blocked_rounds: dict[str, int] = {}
        self.accepted_total = 0
        self.proposed_total = 0
        # deliberate controller exploration (depth-1 recovery probes,
        # full-shape width probes): counted apart so accept-rate summaries
        # can exclude them — a probe's low accept is by design, not
        # degradation
        self.probe_rounds = 0
        self.probe_accepted = 0
        self.probe_proposed = 0
        # latest adaptive-speculation state (the scheduler's commit point
        # sets it on spec deployments): tuned widths, EWMA accept,
        # effective depth — surfaced by health()/aggregate readers
        self.spec_state: dict | None = None
        self.mode_rounds: dict[str, int] = {}
        # goodput / SLO attainment counters
        self.goodput_met_tokens = 0
        self.goodput_breached_tokens = 0
        self.ttft_ok = 0
        self.ttft_total = 0
        self.itl_ok = 0
        self.itl_total = 0
        self.deadline_met = 0
        self.deadline_total = 0
        self.dumps = 0
        self._last_dump_ns = 0
        # recency marker (round number of the last SLO breach) so health()
        # reflects the CURRENT state instead of latching on lifetime
        # counters after one incident (blocking recency is read off the
        # retained frames directly)
        self._last_breach_round = -(10**12)

    # ---------------------------------------------------------------- append
    def record(self, frame: FlightFrame) -> None:
        """O(1): ring store + integer adds. The kill switch makes this a
        no-op (the scheduler still commits its stat_* counters)."""
        if not self.enabled:
            return
        self._frames[self._n % self.capacity] = frame
        self._n += 1
        busy = self.busy_ns_total
        for i, ns in enumerate(frame.busy_ns):
            busy[i] += ns
        rdb = self.rdb_ns_total
        for i, ns in enumerate(frame.rdb_ns):
            rdb[i] += ns
        ph = self.phase_ns_total
        for i, ns in enumerate(frame.phase_ns):
            ph[i] += ns
        self.gap_ns_total += frame.gap_ns
        self.overlap_ns_total += frame.overlap_ns
        self.tokens_total += frame.tokens
        self.occupancy_sum += frame.active / self.n_slots
        self.admitted_total += frame.admitted
        self.retired_total += frame.retired
        self.promotions_total += frame.promotions
        if frame.blocked:
            self.blocked_rounds[frame.blocked] = (
                self.blocked_rounds.get(frame.blocked, 0) + 1
            )
        self.accepted_total += frame.accepted
        self.proposed_total += frame.proposed
        if frame.probe:
            self.probe_rounds += 1
            self.probe_accepted += frame.accepted
            self.probe_proposed += frame.proposed
        self.mode_rounds[frame.mode] = self.mode_rounds.get(frame.mode, 0) + 1

    @property
    def rounds(self) -> int:
        return self._n

    # --------------------------------------------------- goodput / SLO notes
    def note_goodput(self, tokens: int, met: bool) -> None:
        if met:
            self.goodput_met_tokens += tokens
        else:
            self.goodput_breached_tokens += tokens

    def note_ttft(self, ok: bool) -> str:
        """Record one TTFT attainment sample; on a breach, auto-dump the
        ring (rate-limited) and return the dump's trace id for the metric
        exemplar ('' otherwise)."""
        self.ttft_total += 1
        if ok:
            self.ttft_ok += 1
            return ""
        self._last_breach_round = self._n
        return self.dump("slo_ttft_breach")

    def note_itl(self, ok: bool) -> str:
        self.itl_total += 1
        if ok:
            self.itl_ok += 1
            return ""
        self._last_breach_round = self._n
        return self.dump("slo_itl_breach")

    def note_deadline(self, met: bool) -> str:
        self.deadline_total += 1
        if met:
            self.deadline_met += 1
            return ""
        self._last_breach_round = self._n
        return self.dump("slo_deadline_breach")

    # --------------------------------------------------------------- readout
    def snapshot(self, n: int = 0) -> list[FlightFrame]:
        """The most recent ``n`` frames (all retained when n<=0), oldest
        first."""
        total = self._n
        avail = min(total, self.capacity)
        n = avail if n <= 0 else min(int(n), avail)
        out = []
        for i in range(total - n, total):
            f = self._frames[i % self.capacity]
            if f is not None:
                out.append(f)
        return out

    def aggregate(self, window: int = 0) -> dict:
        """Windowed aggregates over the last ``window`` frames (the whole
        ring when 0). This walks frames — read-out path, not the hot one."""
        frames = self.snapshot(window)
        rounds = len(frames)
        busy = [0] * len(FAMILIES)
        rdb = [0] * len(FAMILIES)
        phase = [0] * N_PHASES
        gap = 0
        overlap = 0
        tokens = admitted = retired = accepted = proposed = 0
        promotions = 0
        occ = 0.0
        modes: dict[str, int] = {}
        blocked: dict[str, int] = {}
        depth_sum = spec_rounds = 0
        probes = probe_acc = probe_prop = 0
        for f in frames:
            for i, ns in enumerate(f.busy_ns):
                busy[i] += ns
            for i, ns in enumerate(f.rdb_ns):
                rdb[i] += ns
            for i, ns in enumerate(f.phase_ns):
                phase[i] += ns
            gap += f.gap_ns
            overlap += f.overlap_ns
            tokens += f.tokens
            admitted += f.admitted
            retired += f.retired
            promotions += f.promotions
            accepted += f.accepted
            proposed += f.proposed
            occ += f.active / self.n_slots
            modes[f.mode] = modes.get(f.mode, 0) + 1
            if f.blocked:
                blocked[f.blocked] = blocked.get(f.blocked, 0) + 1
            if f.proposed:
                depth_sum += f.spec_depth
                spec_rounds += 1
            if f.probe:
                probes += 1
                probe_acc += f.accepted
                probe_prop += f.proposed
        busy_total = sum(busy)
        wall = busy_total + gap
        out = {
            "name": self.name,
            "rounds": rounds,
            "rounds_total": self._n,
            "modes": modes,
            "occupancy_mean": round(occ / rounds, 4) if rounds else 0.0,
            "busy_ms": {
                FAMILIES[i]: round(ns / 1e6, 3) for i, ns in enumerate(busy) if ns
            },
            # the enqueue/readback split of busy_ms: where each family's
            # wall actually went on async-dispatch backends
            "enqueue_ms": {
                FAMILIES[i]: round((busy[i] - ns) / 1e6, 3)
                for i, ns in enumerate(rdb)
                if busy[i]
            },
            "readback_ms": {
                FAMILIES[i]: round(ns / 1e6, 3) for i, ns in enumerate(rdb) if ns
            },
            # the host gap decomposed per phase — what a pipelined decode
            # loop would overlap with the in-flight dispatch
            "phase_ms": {
                PHASES[i]: round(ns / 1e6, 3) for i, ns in enumerate(phase) if ns
            },
            "phase_of_gap": round(sum(phase) / gap, 4) if gap else 0.0,
            "gap_ms": round(gap / 1e6, 3),
            "bubble_fraction": round(gap / wall, 4) if wall else 0.0,
            # host work hidden under in-flight dispatches (the pipelined
            # loop's win): overlap_of_gap is the share of the would-be
            # serial gap (gap + overlap) that pipelining hid, and
            # bubble_residual the share still exposed as bubble — the two
            # sum to 1 whenever any host work was timed at all
            "overlap_ms": round(overlap / 1e6, 3),
            "overlap_of_gap": (
                round(overlap / (gap + overlap), 4) if (gap + overlap) else 0.0
            ),
            "bubble_residual": (
                round(gap / (gap + overlap), 4) if (gap + overlap) else 0.0
            ),
            "tokens": tokens,
            "tokens_per_s": round(tokens / (wall / 1e9), 1) if wall else 0.0,
            "admitted": admitted,
            "retired": retired,
            "blocked_rounds": blocked,
        }
        if promotions:
            out["promotions"] = promotions
        if proposed:
            # accept_rate excludes PROBE rounds: a depth-1 recovery probe
            # or a full-shape width probe accepts badly BY DESIGN (that is
            # what it measures) — folding it in would read deliberate
            # exploration as degradation. The probes' own accept rides
            # probe_accept_rate beside the count.
            np_acc = accepted - probe_acc
            np_prop = proposed - probe_prop
            out["accept_rate"] = (
                round(np_acc / np_prop, 4)
                if np_prop
                else round(accepted / proposed, 4)
            )
            out["spec_depth_mean"] = round(depth_sum / max(spec_rounds, 1), 2)
        if probes:
            out["probe_rounds"] = probes
            if probe_prop:
                out["probe_accept_rate"] = round(probe_acc / probe_prop, 4)
        if frames:
            last = frames[-1]
            out["kv_pages"] = [last.kv_free, last.kv_live, last.kv_prefix]
            out["queued"] = last.queued
        out["goodput"] = self.goodput()
        return out

    def bubble_fraction(self) -> float:
        """Lifetime host-bubble fraction from the O(1) running totals."""
        wall = sum(self.busy_ns_total) + self.gap_ns_total
        return self.gap_ns_total / wall if wall else 0.0

    def top_gap_phase(self) -> str:
        """The phase carrying the most lifetime gap time (O(1) running
        totals) — what /decode/health names as the bubble's top
        contributor; '' before any phase was timed."""
        total = sum(self.phase_ns_total)
        if total == 0:
            return ""
        i = max(range(N_PHASES), key=lambda j: self.phase_ns_total[j])
        return PHASES[i]

    def goodput(self) -> dict:
        """Goodput + SLO-attainment summary from the running counters."""
        total_tokens = self.goodput_met_tokens + self.goodput_breached_tokens
        out: dict = {
            "tokens_met": self.goodput_met_tokens,
            "tokens_breached": self.goodput_breached_tokens,
            "goodput_fraction": (
                round(self.goodput_met_tokens / total_tokens, 4)
                if total_tokens
                else 1.0
            ),
        }
        if self.ttft_total:
            out["ttft_attainment"] = round(self.ttft_ok / self.ttft_total, 4)
            out["slo_ttft_ms"] = self.slo_ttft_ms
        if self.itl_total:
            out["itl_attainment"] = round(self.itl_ok / self.itl_total, 4)
            out["slo_itl_ms"] = self.slo_itl_ms
        if self.deadline_total:
            out["deadline_attainment"] = round(
                self.deadline_met / self.deadline_total, 4
            )
        return out

    # how far back (in rounds) health() looks when classifying the CURRENT
    # state — lifetime counters would latch "saturated"/"breaching" forever
    # after one early incident
    HEALTH_WINDOW = 128

    def health(self) -> dict:
        """Health summary (the /decode/health read-out): O(1) running
        totals + the latest frame, with status classified from RECENT
        rounds (a bounded HEALTH_WINDOW-frame walk for blocking, recency
        markers for breaches) so a transient incident ages out."""
        rounds = self._n
        last = self._frames[(rounds - 1) % self.capacity] if rounds else None
        status = "idle" if rounds == 0 else "ok"
        recent = self.snapshot(self.HEALTH_WINDOW)
        recent_blocked = sum(1 for f in recent if f.blocked)
        if recent and recent_blocked >= max(len(recent) // 4, 8):
            status = "saturated"
        recently_breached = (
            rounds - self._last_breach_round
        ) <= self.HEALTH_WINDOW
        if recently_breached and status == "ok":
            status = "breaching"
        queue_depth = last.queued if last is not None else 0
        if self.queue_depth_source is not None:
            try:
                queue_depth = int(self.queue_depth_source())
            except Exception:  # noqa: BLE001 - a health read must never raise
                pass
        out = {
            "name": self.name,
            "status": status,
            "enabled": self.enabled,
            # O(1) reads the replica router polls: which replica this is
            # and how deep its un-admitted queue runs RIGHT NOW (live
            # source when the scheduler registered one, else the last
            # committed frame)
            "replica_id": self.replica_id,
            "state": self.replica_state,
            "consecutive_misses": self.consecutive_misses,
            "queue_depth": queue_depth,
            "rounds": rounds,
            "occupancy_mean": round(self.occupancy_sum / rounds, 4) if rounds else 0.0,
            "bubble_fraction": round(self.bubble_fraction(), 4),
            # lifetime share of the would-be serial gap that the pipelined
            # loop hid under in-flight dispatches (0.0 on the serial loop)
            "overlap_of_gap": (
                round(
                    self.overlap_ns_total
                    / (self.gap_ns_total + self.overlap_ns_total),
                    4,
                )
                if (self.gap_ns_total + self.overlap_ns_total)
                else 0.0
            ),
            # the bubble's top contributor by lifetime phase totals, and
            # how much of the gap the phase timers account for at all
            "top_gap_phase": self.top_gap_phase(),
            "phase_of_gap": (
                round(sum(self.phase_ns_total) / self.gap_ns_total, 4)
                if self.gap_ns_total
                else 0.0
            ),
            "tokens": self.tokens_total,
            "admitted": self.admitted_total,
            "retired": self.retired_total,
            "blocked_rounds": dict(self.blocked_rounds),
            "modes": dict(self.mode_rounds),
            "goodput": self.goodput(),
            "dumps": self.dumps,
        }
        if self.proposed_total:
            # probe rounds excluded — same rationale as aggregate()
            np_acc = self.accepted_total - self.probe_accepted
            np_prop = self.proposed_total - self.probe_proposed
            out["accept_rate"] = (
                round(np_acc / np_prop, 4)
                if np_prop
                else round(self.accepted_total / self.proposed_total, 4)
            )
        if self.probe_rounds:
            out["probe_rounds"] = self.probe_rounds
        if self.spec_state is not None:
            # the adaptive-speculation state the scheduler last committed:
            # chosen tree shape (tuned widths), EWMA accept rate,
            # effective depth
            out["spec"] = self.spec_state
        if last is not None:
            out["queued"] = last.queued
            out["kv_pages"] = [last.kv_free, last.kv_live, last.kv_prefix]
        return out

    # ------------------------------------------------------------- auto-dump
    def dump(self, reason: str, force: bool = False) -> str:
        """Dump the recent ring into the process-global span store as a
        force-retained trace (one ``decode.flight`` root span carrying the
        aggregate attrs, one ``frame`` event per recent frame) so the
        frames around a breach/error survive wraparound. Rate-limited to
        one dump per ``dump_interval_s`` unless ``force`` (round errors
        always dump). Returns the dump's trace id ('' when skipped)."""
        if not self.enabled:
            return ""
        now = time.perf_counter_ns()
        if not force and self._last_dump_ns:
            if (now - self._last_dump_ns) < self.dump_interval_s * 1e9:
                return ""
        self._last_dump_ns = now
        try:
            from seldon_core_tpu_torch.telemetry import get_tracer
            from seldon_core_tpu_torch.telemetry.spans import TraceBuf, new_trace_id

            buf = TraceBuf(new_trace_id(), puid=f"flight:{self.name}")
            buf.flags.add("forced")
            agg = self.aggregate(DUMP_FRAMES)
            root = buf.begin(
                "decode.flight",
                attrs={
                    "deployment": self.name,
                    "reason": reason,
                    "rounds": agg["rounds"],
                    "bubble_fraction": agg["bubble_fraction"],
                    "occupancy_mean": agg["occupancy_mean"],
                },
            )
            for f in self.snapshot(DUMP_FRAMES):
                root.add_event("frame", f.to_dict())
            root.end()
            get_tracer().store.offer(buf)
            self.dumps += 1
            return buf.trace_id
        except Exception:  # noqa: BLE001 - diagnostics must never kill the loop
            return ""

    # -------------------------------------------------------------- overhead
    @staticmethod
    def measure_overhead(n: int = 2000) -> float:
        """Measured per-round recorder cost in µs (frame construction +
        record) on a throwaway recorder — what the guard test budgets."""
        rec = FlightRecorder(n_slots=8, name="overhead", capacity=256, enabled=True)
        t0 = time.perf_counter_ns()
        for i in range(n):
            rec.record(
                FlightFrame(
                    i, t0 + i, "plain", 7, 1, 3, 1, 1, "", 8, 4, 6, 3,
                    (0, 120_000, 40_000, 180_000, 0), 90_000, 5, 12, 4, 1,
                    (12_000, 2_000, 8_000, 0, 30_000, 20_000, 0, 4_000),
                    (0, 60_000, 0, 150_000, 0), 25_000,
                )
            )
        return round((time.perf_counter_ns() - t0) / n / 1e3, 3)


# ----------------------------------------------------------------- registry

_RECORDERS: dict[str, FlightRecorder] = {}


def register(recorder: FlightRecorder) -> FlightRecorder:
    """Register a scheduler's recorder under its deployment name (latest
    wins — a redeploy replaces the entry) so the read-out routes find it."""
    _RECORDERS[recorder.name] = recorder
    return recorder


def recorders() -> dict[str, FlightRecorder]:
    return dict(_RECORDERS)


def flight_report(n: int = 64, name: str | None = None, window: int = 0) -> dict:
    """The GET /decode/flight body: per-recorder recent frames + windowed
    aggregates."""
    out: dict = {"recorders": {}}
    for rname, rec in _RECORDERS.items():
        if name and rname != name:
            continue
        out["recorders"][rname] = {
            "aggregate": rec.aggregate(window),
            "frames": [f.to_dict() for f in rec.snapshot(n)],
        }
    return out


def health_report() -> dict:
    """The GET /decode/health body: per-recorder O(1) health summaries."""
    return {name: rec.health() for name, rec in _RECORDERS.items()}
