"""Bounded in-process trace store with tail-based sampling.

Port of ``seldon_core_tpu/telemetry/store.py``, unchanged.

Head sampling (decide at ingress) cannot keep "every failed request" —
whether a request fails is only known at the tail. So every request is
traced in-flight (span cost is a handful of small objects) and the KEEP
decision happens when the trace completes:

- error / deadline-exceeded / degraded / explicitly-traced requests are
  ALWAYS kept (their own bounded pool, oldest evicted);
- the slowest-N ok traces are kept (a min-heap by duration);
- everything else is kept with probability ``sample_rate`` into a bounded
  recent pool.

Total retention is therefore hard-bounded by
``max_errors + slow_keep + max_sampled`` regardless of traffic.

Multi-process stitching: a remote hop's server-side fragment arrives under
the SAME trace id but before the client's root fragment completes (the
parent span ends last). Non-root fragments wait in a bounded pending map;
the root fragment's keep decision absorbs or discards them.
"""

from __future__ import annotations

import heapq
import random
import threading
from collections import OrderedDict

from seldon_core_tpu_torch.telemetry.spans import TraceBuf

KEEP_FLAGS = frozenset({"error", "deadline", "degraded", "forced"})


class TraceRecord:
    __slots__ = ("trace_id", "puid", "spans", "flags")

    def __init__(self, buf: TraceBuf):
        self.trace_id = buf.trace_id
        self.puid = buf.puid
        self.spans = list(buf.spans)
        self.flags = set(buf.flags)

    def absorb(self, buf: TraceBuf) -> None:
        self.spans.extend(buf.spans)
        self.flags |= buf.flags
        if not self.puid:
            self.puid = buf.puid

    @property
    def start_ns(self) -> int:
        return min(s.start_ns for s in self.spans) if self.spans else 0

    @property
    def duration_ms(self) -> float:
        if not self.spans:
            return 0.0
        t0 = self.start_ns
        t1 = max(s.end_ns or s.start_ns for s in self.spans)
        return (t1 - t0) / 1e6

    def root(self):
        ids = {s.span_id for s in self.spans}
        for s in self.spans:
            if not s.parent_id or s.parent_id not in ids:
                return s
        return self.spans[0] if self.spans else None

    def self_times_ms(self) -> dict[str, float]:
        """span_id -> duration minus direct children's durations (where a
        trace's latency actually went, not just which spans contain it)."""
        child_sum: dict[str, int] = {}
        for s in self.spans:
            if s.parent_id:
                dur = (s.end_ns or s.start_ns) - s.start_ns
                child_sum[s.parent_id] = child_sum.get(s.parent_id, 0) + dur
        out = {}
        for s in self.spans:
            dur = (s.end_ns or s.start_ns) - s.start_ns
            out[s.span_id] = max(0, dur - child_sum.get(s.span_id, 0)) / 1e6
        return out

    def summary(self) -> dict:
        root = self.root()
        return {
            "trace_id": self.trace_id,
            "puid": self.puid,
            "root": root.name if root is not None else "",
            "spans": len(self.spans),
            "duration_ms": round(self.duration_ms, 3),
            "flags": sorted(self.flags),
        }

    def to_dict(self) -> dict:
        spans = sorted(self.spans, key=lambda s: s.start_ns)
        return {**self.summary(), "trace": [s.to_dict() for s in spans]}


class SpanStore:
    """See module docstring. Thread-safe: the serving loop offers, the
    read-out routes and other threads read."""

    def __init__(
        self,
        max_errors: int = 128,
        slow_keep: int = 32,
        max_sampled: int = 64,
        sample_rate: float = 0.05,
        max_pending: int = 256,
        seed: int | None = 0,
    ):
        self.max_errors = max(int(max_errors), 1)
        self.slow_keep = max(int(slow_keep), 0)
        self.max_sampled = max(int(max_sampled), 0)
        self.sample_rate = float(sample_rate)
        self.max_pending = max(int(max_pending), 0)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._errors: OrderedDict[str, TraceRecord] = OrderedDict()
        self._slow: OrderedDict[str, TraceRecord] = OrderedDict()
        self._slow_heap: list[tuple[float, str]] = []  # (duration_ms, id)
        self._sampled: OrderedDict[str, TraceRecord] = OrderedDict()
        self._pending: OrderedDict[str, TraceRecord] = OrderedDict()
        # counters for the debug API: what the sampler actually did
        self.offered = 0
        self.dropped = 0

    @property
    def capacity(self) -> int:
        """Hard bound on retained traces (pending fragments excluded; they
        have their own max_pending bound)."""
        return self.max_errors + self.slow_keep + self.max_sampled

    def __len__(self) -> int:
        with self._lock:
            return len(self._errors) + len(self._slow) + len(self._sampled)

    # ---------------------------------------------------------------- offer
    def _retained(self, trace_id: str) -> TraceRecord | None:
        return (
            self._errors.get(trace_id)
            or self._slow.get(trace_id)
            or self._sampled.get(trace_id)
        )

    def _is_fragment(self, buf: TraceBuf) -> bool:
        """A buf whose root span continues a REMOTE parent (every span's
        parent chain leaves the buf) is a non-root fragment: its keep
        decision belongs to the trace's root process."""
        ids = {s.span_id for s in buf.spans}
        for s in buf.spans:
            if not s.parent_id:
                return False
            if s.parent_id not in ids:
                return True
        return False

    def offer(self, buf: TraceBuf) -> bool:
        """Offer a completed per-request buf. Returns True when the trace is
        (now) retained. Fragments of an already-retained trace merge in;
        orphan fragments wait in the bounded pending map."""
        if not buf.spans:
            return False
        with self._lock:
            self.offered += 1
            rec = self._retained(buf.trace_id)
            if rec is not None:
                rec.absorb(buf)
                return True
            pending = self._pending
            if self._is_fragment(buf) and not (buf.flags & KEEP_FLAGS):
                # unflagged fragment: its keep decision belongs to the
                # trace's ROOT process — wait (bounded) for the root
                frag = pending.get(buf.trace_id)
                if frag is not None:
                    frag.absorb(buf)
                else:
                    pending[buf.trace_id] = TraceRecord(buf)
                    while len(pending) > self.max_pending:
                        pending.popitem(last=False)
                return False
            # root fragment, or a flagged (error/deadline/degraded/forced)
            # non-root fragment — the latter retains IMMEDIATELY: on a real
            # multi-pod graph this store never sees the remote root, and an
            # error fragment that only ever pends would be undebuggable
            frag = pending.pop(buf.trace_id, None)
            return self._decide(buf, frag)

    @staticmethod
    def _buf_duration_ms(buf: TraceBuf) -> float:
        t0 = min(s.start_ns for s in buf.spans)
        t1 = max(s.end_ns or s.start_ns for s in buf.spans)
        return (t1 - t0) / 1e6

    def _keep(self, buf: TraceBuf, frag: TraceRecord | None) -> TraceRecord:
        # the TraceRecord (span-list copy) is built ONLY for kept traces —
        # the common dropped case on the hot path pays no copy
        rec = TraceRecord(buf)
        if frag is not None:
            rec.spans.extend(frag.spans)
            rec.flags |= frag.flags
        return rec

    def _decide(self, buf: TraceBuf, frag: TraceRecord | None) -> bool:
        flags = buf.flags | (frag.flags if frag is not None else set())
        tid = buf.trace_id
        if flags & KEEP_FLAGS:
            self._errors[tid] = self._keep(buf, frag)
            while len(self._errors) > self.max_errors:
                self._errors.popitem(last=False)
            return True
        dur = self._buf_duration_ms(buf)
        if self.slow_keep > 0:
            if len(self._slow) < self.slow_keep:
                heapq.heappush(self._slow_heap, (dur, tid))
                self._slow[tid] = self._keep(buf, frag)
                return True
            if self._slow_heap and dur > self._slow_heap[0][0]:
                _, evicted = heapq.heapreplace(self._slow_heap, (dur, tid))
                self._slow.pop(evicted, None)
                self._slow[tid] = self._keep(buf, frag)
                return True
        if self.max_sampled > 0 and self._rng.random() < self.sample_rate:
            self._sampled[tid] = self._keep(buf, frag)
            while len(self._sampled) > self.max_sampled:
                self._sampled.popitem(last=False)
            return True
        self.dropped += 1
        return False

    # ----------------------------------------------------------------- read
    def get(self, key: str) -> TraceRecord | None:
        """Lookup by trace id, or by puid (the puid IS the user-visible
        request id — the natural thing to paste into the debug API)."""
        with self._lock:
            rec = self._retained(key)
            if rec is not None:
                return rec
            for pool in (self._errors, self._slow, self._sampled):
                for r in pool.values():
                    if r.puid and r.puid == key:
                        return r
        return None

    def list(self, sort: str = "recent", n: int = 50) -> list[TraceRecord]:
        with self._lock:
            records = (
                list(self._errors.values())
                + list(self._slow.values())
                + list(self._sampled.values())
            )
        if sort == "slow":
            records.sort(key=lambda r: r.duration_ms, reverse=True)
        else:
            records.sort(key=lambda r: r.start_ns, reverse=True)
        return records[: max(int(n), 0)]

    def slowest_summaries(self, n: int = 5, top_spans: int = 3) -> list[dict]:
        """Per-trace attribution for load runs: the slowest retained
        traces, each with its top spans by SELF time."""
        out = []
        for rec in self.list(sort="slow", n=n):
            self_ms = rec.self_times_ms()
            by_id = {s.span_id: s for s in rec.spans}
            top = sorted(self_ms.items(), key=lambda kv: kv[1], reverse=True)
            out.append(
                {
                    "trace_id": rec.trace_id,
                    "puid": rec.puid,
                    "total_ms": round(rec.duration_ms, 2),
                    "flags": sorted(rec.flags),
                    "top_spans": [
                        {"name": by_id[sid].name, "self_ms": round(ms, 2)}
                        for sid, ms in top[: max(int(top_spans), 0)]
                    ],
                }
            )
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "retained": len(self._errors) + len(self._slow) + len(self._sampled),
                "errors": len(self._errors),
                "slow": len(self._slow),
                "sampled": len(self._sampled),
                "capacity": self.capacity,
                "offered": self.offered,
                "dropped": self.dropped,
            }
