"""Prometheus metrics under the reference's metric names and labels, so its
Grafana dashboards carry over (port of ``seldon_core_tpu/metrics/registry.py``):

- seldon_api_ingress_server_requests_duration_seconds — server-side request
  histogram (reference api-frontend AuthorizedWebMvcTagsProvider)
- seldon_api_engine_client_requests_duration_seconds — per-unit-call
  histogram (reference SeldonRestTemplateExchangeTagsProvider)
- seldon_api_model_feedback / seldon_api_model_feedback_reward (reference
  PredictiveUnitBean.java:239-242)
- the JAX package's ``seldon_tpu_*`` additions for the features the port
  serves: batching, the decode tier (steps, TTFT, ITL, speculation, prefix
  reuse, the paged KV pool and its host and store tiers, rounds, bubble,
  goodput, SLO attainment), the resilience layer, SHADOW agreement and the
  event-loop lag.
  ``seldon_tpu_xla_compile_seconds`` keeps its name; here it times the
  capture of CUDA graphs at warmup.

The replicated decode fleet's families (``seldon_tpu_router_*``,
``seldon_tpu_replica_*`` and the sibling pulls) are registered too. The
hook of the one feature the port does not have yet (per-device pages,
tensor-parallel decode) stays a no-op inherited from ``NullMetrics``, and
its family is not registered.

The card's host has no ``prometheus_client``, so the registry carries its
own Counter, Gauge and Histogram and writes both text expositions itself:
the Prometheus 0.0.4 format (``export``) and OpenMetrics 1.0 with trace-id
exemplars (``export_openmetrics``), sample for sample what
``prometheus_client`` 0.2x writes for the same calls, ``_created`` series
included. It never imports ``prometheus_client``.
"""

from __future__ import annotations

import math
import threading
import time

_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0
)


# ----------------------------------------------------------------- primitives


def _go_float(d: float) -> str:
    """A sample value as Prometheus' Go client prints it (what
    ``prometheus_client.utils.floatToGoString`` does)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to an exponent sooner than Python (only positive le
    # values reach this)
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labelstr(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(pairs)) + "}"


class Exemplar:
    __slots__ = ("labels", "value", "timestamp")

    def __init__(self, labels: dict, value: float, timestamp: float):
        self.labels = dict(labels)
        self.value = value
        self.timestamp = timestamp

    def render(self) -> str:
        return f" # {_labelstr(self.labels.items())} {_go_float(self.value)} {self.timestamp}"


def _check_exemplar(exemplar: dict) -> None:
    """The OpenMetrics limit: at most 128 characters of exemplar labels."""
    if sum(len(k) + len(str(v)) for k, v in exemplar.items()) > 128:
        raise ValueError("exemplar labels exceed 128 characters")


class _CounterChild:
    __slots__ = ("value", "created", "exemplar")

    def __init__(self):
        self.value = 0.0
        self.created = time.time()
        self.exemplar: Exemplar | None = None

    def inc(self, amount: float = 1.0, exemplar: dict | None = None) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        self.value += amount
        if exemplar:
            _check_exemplar(exemplar)
            self.exemplar = Exemplar(exemplar, amount, time.time())

    def samples(self, name, labels):
        return [(name + "_total", labels, self.value, self.exemplar),
                (name + "_created", labels, self.created, None)]


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def samples(self, name, labels):
        return [(name, labels, self.value, None)]


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "created", "exemplars")

    def __init__(self, bounds):
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0
        self.created = time.time()
        self.exemplars: list[Exemplar | None] = [None] * len(bounds)

    def observe(self, amount: float, exemplar: dict | None = None) -> None:
        self.sum += amount
        for i, bound in enumerate(self.bounds):
            if amount <= bound:
                self.counts[i] += 1
                if exemplar:
                    _check_exemplar(exemplar)
                    self.exemplars[i] = Exemplar(exemplar, amount, time.time())
                break

    def samples(self, name, labels):
        out, acc = [], 0.0
        for bound, count, ex in zip(self.bounds, self.counts, self.exemplars):
            acc += count
            out.append((name + "_bucket", labels + (("le", _go_float(bound)),), acc, ex))
        out.append((name + "_count", labels, acc, None))
        out.append((name + "_sum", labels, self.sum, None))
        out.append((name + "_created", labels, self.created, None))
        return out


class _Family:
    """One metric family: name, help, type, label names and a child per
    label-value tuple (a family without labels has its one child from the
    start, as prometheus_client's do)."""

    def __init__(self, registry: "Registry", kind: str, name: str, doc: str, labelnames=(), buckets=None):
        if kind == "counter" and name.endswith("_total"):
            name = name[:-6]
        self.kind = kind
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            bounds = [float(b) for b in buckets]
            if bounds[-1] != math.inf:
                bounds.append(math.inf)
            self._bounds = tuple(bounds)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        registry.register(self)

    def _new_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        return _HistogramChild(self._bounds)

    def labels(self, *values):
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: want labels {self.labelnames}, got {values}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    # families without labels act as their one child
    def set(self, value: float) -> None:
        self._children[()].set(value)

    def samples(self) -> list:
        out = []
        for key, child in list(self._children.items()):
            out.extend(child.samples(self.name, tuple(zip(self.labelnames, key))))
        return out


def Counter(name, doc, labelnames=(), registry=None):
    return _Family(registry, "counter", name, doc, labelnames)


def Gauge(name, doc, labelnames=(), registry=None):
    return _Family(registry, "gauge", name, doc, labelnames)


def Histogram(name, doc, labelnames=(), registry=None, buckets=_LATENCY_BUCKETS):
    return _Family(registry, "histogram", name, doc, labelnames, buckets)


class Registry:
    """The families of one Metrics, in registration order."""

    def __init__(self):
        self.families: list[_Family] = []

    def register(self, family: _Family) -> None:
        if any(f.name == family.name for f in self.families):
            raise ValueError(f"duplicate metric family {family.name}")
        self.families.append(family)

    def text(self) -> bytes:
        """Prometheus text format 0.0.4: a counter's samples under
        ``name_total``, each family's ``_created`` series after it as a
        gauge family of its own."""
        out = []
        for fam in self.families:
            mname = fam.name + "_total" if fam.kind == "counter" else fam.name
            doc = fam.doc.replace("\\", r"\\").replace("\n", r"\n")
            out.append(f"# HELP {mname} {doc}\n# TYPE {mname} {fam.kind}\n")
            created = []
            for name, labels, value, _ in fam.samples():
                line = f"{name}{_labelstr(labels)} {_go_float(value)}\n"
                (created if name == fam.name + "_created" else out).append(line)
            if created:
                out.append(f"# HELP {fam.name}_created {doc}\n# TYPE {fam.name}_created gauge\n")
                out.extend(created)
        return "".join(out).encode()

    def openmetrics(self) -> bytes:
        """OpenMetrics 1.0 text: the format that carries exemplars."""
        out = []
        for fam in self.families:
            doc = _escape_label(fam.doc)
            out.append(f"# HELP {fam.name} {doc}\n# TYPE {fam.name} {fam.kind}\n")
            for name, labels, value, ex in fam.samples():
                out.append(f"{name}{_labelstr(labels)} {_go_float(value)}{ex.render() if ex else ''}\n")
        out.append("# EOF\n")
        return "".join(out).encode()


# -------------------------------------------------------------------- hooks


class NullMetrics:
    """No-op recorder (metrics disabled). Every hook of the JAX package's
    registry is here, so callers never test for a feature."""

    def ingress_request(self, deployment: str, method: str, duration_s: float, trace_id: str | None = None) -> None:
        """``trace_id``: the request's trace id; the registry attaches it as
        an exemplar so a slow histogram sample links to GET /traces/{id}."""

    def ingress_error(self, deployment: str, method: str, code: int) -> None:
        pass

    def unit_call(self, deployment: str, predictor: str, unit: str, method: str, duration_s: float) -> None:
        pass

    def feedback(self, deployment: str, predictor: str, unit: str, reward: float) -> None:
        pass

    def batch(self, deployment: str, size: int, queue_waits_s) -> None:
        """``queue_waits_s``: the wait of every batch-mate (a float is taken
        for a single request)."""

    def decode_step(self, deployment: str, active: int, slots: int) -> None:
        pass

    def decode_ttft(self, deployment: str, duration_s: float) -> None:
        pass

    def decode_inter_token(self, deployment: str, duration_s: float) -> None:
        pass

    def decode_spec(self, deployment: str, proposed: int, accepted: int, emitted: int, mode: str = "chain") -> None:
        """One speculative verify dispatch: ``proposed`` depth positions
        entered acceptance, ``accepted`` survived, ``emitted`` tokens
        (accepted plus a bonus per slot); ``mode`` "chain" | "tree"."""

    def decode_spec_tree(self, deployment: str, nodes: int, path_len: int) -> None:
        """One slot's ride on a tree verify: allowed nodes and the accepted
        path depth."""

    def decode_prefix(self, deployment: str, hit: bool, tokens_saved: int) -> None:
        pass

    def decode_prefix_evicted(self, deployment: str) -> None:
        pass

    def decode_ttft_split(self, deployment: str, duration_s: float, path: str) -> None:
        """TTFT by admission ``path``: "warm" (prefix hit) or "cold"."""

    def decode_kv_pool(self, deployment: str, free: int, live: int, prefix: int) -> None:
        pass

    def decode_kv_shared(self, deployment: str, pages: int) -> None:
        pass

    def decode_kv_cow(self, deployment: str, copies: int) -> None:
        pass

    def decode_kv_reclaimed(self, deployment: str, pins: int) -> None:
        pass

    def decode_kv_per_device(self, deployment: str, pages: int, tp: int) -> None:
        pass

    def decode_kv_tier_bytes(self, deployment: str, tier: str, nbytes: int) -> None:
        """Bytes resident in one slow KV tier (``tier`` = host | store)."""

    def decode_kv_demotion(self, deployment: str, tier: str, n: int) -> None:
        """``n`` prefix entries demoted into ``tier`` (host: a device eviction
        caught by the host pool; store: a host-LRU spill)."""

    def decode_kv_promotion(self, deployment: str, tier: str, n: int) -> None:
        """``n`` prefix entries promoted to the device pool from ``tier``."""

    def decode_kv_sibling_pull(self, deployment: str, outcome: str) -> None:
        pass

    def decode_round(self, deployment: str, busy_s: float, gap_s: float) -> None:
        """One scheduler round: device-dispatch wall and the host gap."""

    def decode_bubble(self, deployment: str, fraction: float) -> None:
        pass

    def decode_goodput(self, deployment: str, tokens: int, met: bool) -> None:
        pass

    def decode_slo(self, deployment: str, kind: str, ok: bool, trace_id: str | None = None) -> None:
        """One SLO sample (``kind`` ttft | itl | deadline); a breach carries
        the flight dump's trace id as an exemplar."""

    def router_route(self, deployment: str, policy: str, reason: str) -> None:
        pass

    def router_queue_depth(self, deployment: str, replica: int, depth: int) -> None:
        pass

    def router_arm(self, deployment: str, replica: int, estimate: float) -> None:
        pass

    def router_replicas(self, deployment: str, n: int) -> None:
        pass

    def router_preseed(self, deployment: str, pages: int) -> None:
        pass

    def replica_state(self, deployment: str, replica: int, state: str) -> None:
        pass

    def replica_eviction(self, deployment: str) -> None:
        pass

    def replica_recovery(self, deployment: str) -> None:
        pass

    def replica_drain(self, deployment: str) -> None:
        pass

    def replica_migration(self, deployment: str, n: int) -> None:
        pass

    def replica_boot_failure(self, deployment: str) -> None:
        pass

    def replica_spill_failure(self, deployment: str) -> None:
        pass

    def compile(self, deployment: str, bucket: int, duration_s: float) -> None:
        pass

    def shadow_compare(self, deployment: str, predictor: str, shadow_unit: str, agree: bool) -> None:
        pass

    def loop_lag(self, lag_ms: float) -> None:
        pass

    def retry(self, deployment: str, unit: str) -> None:
        pass

    def breaker(self, deployment: str, endpoint: str, state: str) -> None:
        pass

    def deadline_exceeded(self, deployment: str, unit: str) -> None:
        pass

    def degraded(self, deployment: str, mode: str) -> None:
        pass

    def fault_injected(self, deployment: str, unit: str, kind: str) -> None:
        pass

    def export(self) -> bytes:
        return b""

    def export_openmetrics(self) -> bytes:
        return b""


class Metrics(NullMetrics):
    def __init__(self, registry: Registry | None = None):
        self.registry = registry = registry if registry is not None else Registry()
        self._ingress = Histogram(
            "seldon_api_ingress_server_requests_duration_seconds", "External API request latency",
            ["deployment_name", "method"], registry=registry)
        self._unit = Histogram(
            "seldon_api_engine_client_requests_duration_seconds", "Graph unit call latency",
            ["deployment_name", "predictor_name", "model_name", "method"], registry=registry)
        self._feedback = Counter(
            "seldon_api_model_feedback", "Feedback events per unit",
            ["deployment_name", "predictor_name", "model_name"], registry=registry)
        # a gauge: rewards may be negative, which a counter refuses
        self._feedback_reward = Gauge(
            "seldon_api_model_feedback_reward", "Accumulated reward per unit",
            ["deployment_name", "predictor_name", "model_name"], registry=registry)
        self._ingress_errors = Counter(
            "seldon_api_ingress_server_errors", "Failed external API requests by error code",
            ["deployment_name", "method", "code"], registry=registry)
        self._batch_size = Histogram(
            "seldon_tpu_batch_size", "Micro-batch sizes submitted to the device", ["deployment_name"],
            registry=registry, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._queue_wait = Histogram(
            "seldon_tpu_batch_queue_wait_seconds", "Time requests wait in the micro-batch queue",
            ["deployment_name"], registry=registry)
        self._compile = Histogram(
            "seldon_tpu_xla_compile_seconds", "XLA compilation time per batch bucket",
            ["deployment_name", "bucket"], registry=registry, buckets=(0.1, 0.5, 1, 5, 10, 30, 60, 120))
        self._loop_lag = Gauge(
            "seldon_tpu_event_loop_lag_ms", "Most recent event-loop scheduling lag sample (ms)", registry=registry)
        self._loop_lag_max = Gauge(
            "seldon_tpu_event_loop_lag_max_ms", "Largest event-loop scheduling lag observed since boot (ms)",
            registry=registry)
        self._loop_lag_max_val = 0.0
        self._decode_occupancy = Gauge(
            "seldon_tpu_decode_slot_occupancy", "Active decode slots / total slots at the last scheduler step",
            ["deployment_name"], registry=registry)
        self._decode_steps = Counter(
            "seldon_tpu_decode_steps_total", "Decode scheduler steps executed", ["deployment_name"],
            registry=registry)
        self._decode_ttft = Histogram(
            "seldon_tpu_decode_ttft_seconds", "Time from request arrival to its first generated token",
            ["deployment_name"], registry=registry)
        self._decode_itl = Histogram(
            "seldon_tpu_decode_inter_token_seconds", "Latency between consecutive generated tokens of one sequence",
            ["deployment_name"], registry=registry)
        self._spec_proposed = Counter(
            "seldon_tpu_decode_spec_proposed_total", "Draft tokens proposed to speculative verification",
            ["deployment_name"], registry=registry)
        self._spec_accepted = Counter(
            "seldon_tpu_decode_spec_accepted_total", "Draft tokens accepted by speculative verification",
            ["deployment_name"], registry=registry)
        self._spec_emitted = Histogram(
            "seldon_tpu_decode_spec_tokens_per_dispatch",
            "Tokens emitted per speculative verify dispatch (accepted + bonus), by round shape (mode=chain|tree)",
            ["deployment_name", "mode"], registry=registry, buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._spec_tree_nodes = Histogram(
            "seldon_tpu_decode_spec_tree_nodes", "Allowed candidate tree nodes per slot per tree-verify dispatch",
            ["deployment_name"], registry=registry, buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._spec_tree_path = Histogram(
            "seldon_tpu_decode_spec_tree_accepted_path_len", "Accepted path depth per slot per tree-verify dispatch",
            ["deployment_name"], registry=registry, buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        self._prefix_lookups = Counter(
            "seldon_tpu_decode_prefix_lookups_total", "Prefix-cache lookups at admission by outcome",
            ["deployment_name", "outcome"], registry=registry)
        self._prefix_saved = Counter(
            "seldon_tpu_decode_prefill_tokens_saved_total",
            "Prompt positions served from the prefix pool instead of prefill", ["deployment_name"],
            registry=registry)
        self._prefix_evictions = Counter(
            "seldon_tpu_decode_prefix_evictions_total", "Prefix pool rows recycled by LRU eviction",
            ["deployment_name"], registry=registry)
        self._kv_pages_free = Gauge(
            "seldon_tpu_decode_kv_pages_free", "Unallocated pages in the decode KV page pool",
            ["deployment_name"], registry=registry)
        self._kv_pages_live = Gauge(
            "seldon_tpu_decode_kv_pages_live", "KV pool pages referenced by at least one live decode slot",
            ["deployment_name"], registry=registry)
        self._kv_pages_prefix = Gauge(
            "seldon_tpu_decode_kv_pages_prefix", "KV pool pages held only by prefix-cache pins (reclaimable)",
            ["deployment_name"], registry=registry)
        self._kv_shared = Counter(
            "seldon_tpu_decode_kv_pages_shared_total",
            "Pool pages mapped copy-free into admitted slots off prefix hits", ["deployment_name"],
            registry=registry)
        self._kv_cow = Counter(
            "seldon_tpu_decode_kv_cow_copies_total",
            "Copy-on-write page copies (first divergent write into a shared page)", ["deployment_name"],
            registry=registry)
        self._kv_reclaimed = Counter(
            "seldon_tpu_decode_kv_pins_reclaimed_total",
            "Prefix pins reclaimed LRU-first under pool allocation pressure", ["deployment_name"],
            registry=registry)
        self._kv_tier_bytes = Gauge(
            "seldon_tpu_decode_kv_tier_bytes", "Bytes of demoted prefix KV resident per slow tier (host|store)",
            ["deployment_name", "tier"], registry=registry)
        self._kv_demotions = Counter(
            "seldon_tpu_decode_kv_demotions_total", "Prefix entries demoted into a slow KV tier (host|store)",
            ["deployment_name", "tier"], registry=registry)
        self._kv_promotions = Counter(
            "seldon_tpu_decode_kv_promotions_total", "Prefix entries promoted to the device pool from a slow tier",
            ["deployment_name", "tier"], registry=registry)
        self._kv_sibling_pulls = Counter(
            "seldon_tpu_decode_kv_sibling_pulls_total",
            "Cross-replica prefix pulls from the rendezvous home (outcome=hit|miss|error)",
            ["deployment_name", "outcome"], registry=registry)
        self._decode_round_busy = Histogram(
            "seldon_tpu_decode_round_device_seconds", "Device-dispatch wall time per decode scheduler round",
            ["deployment_name"], registry=registry)
        self._decode_round_gap = Histogram(
            "seldon_tpu_decode_round_host_gap_seconds",
            "Host bubble per decode scheduler round (wall minus device busy)", ["deployment_name"],
            registry=registry)
        self._decode_bubble = Gauge(
            "seldon_tpu_decode_bubble_fraction", "Cumulative host-bubble fraction of decode round wall time",
            ["deployment_name"], registry=registry)
        self._decode_goodput = Counter(
            "seldon_tpu_decode_goodput_tokens_total",
            "Generated tokens by whether the request met its deadline budget", ["deployment_name", "outcome"],
            registry=registry)
        self._decode_slo = Counter(
            "seldon_tpu_decode_slo_attainment_total",
            "Decode SLO attainment samples (kind=ttft|itl|deadline); breach samples carry the flight-dump "
            "trace id as an exemplar", ["deployment_name", "kind", "outcome"], registry=registry)
        self._decode_ttft_split = Histogram(
            "seldon_tpu_decode_ttft_split_seconds",
            "TTFT split by admission path (warm = prefix hit, cold = full prefill)", ["deployment_name", "path"],
            registry=registry)
        # the replicated decode fleet (serving/affinity_router.py): routing,
        # then the replica lifecycle funnel and its counters
        self._router_routes = Counter(
            "seldon_tpu_router_routes_total",
            "Decode-replica routing decisions (reason=affinity|shed|fallback|round_robin)",
            ["deployment_name", "policy", "reason"], registry=registry)
        self._router_queue_depth = Gauge(
            "seldon_tpu_router_queue_depth",
            "Per-replica load (queue depth + active slots) the router last balanced on",
            ["deployment_name", "replica"], registry=registry)
        self._router_arm = Gauge(
            "seldon_tpu_router_arm_estimate",
            "Per-replica bandit arm mean-reward estimate (moved by Feedback-API rewards / automatic SLO verdicts)",
            ["deployment_name", "replica"], registry=registry)
        self._router_replicas = Gauge(
            "seldon_tpu_router_replicas", "Live decode replicas behind the router (autoscale moves it)",
            ["deployment_name"], registry=registry)
        self._router_preseed = Counter(
            "seldon_tpu_router_preseeded_pages_total", "Prefix-pool pages pre-seeded into warm-booted replicas",
            ["deployment_name"], registry=registry)
        self._replica_state = Gauge(
            "seldon_tpu_replica_state", "Decode replica lifecycle state (0=up 1=draining 2=evicted 3=down)",
            ["deployment_name", "replica"], registry=registry)
        self._replica_evictions = Counter(
            "seldon_tpu_replica_evictions_total", "Decode replicas evicted from routing (health breaker opened)",
            ["deployment_name"], registry=registry)
        self._replica_recoveries = Counter(
            "seldon_tpu_replica_recoveries_total", "Evicted decode replicas readmitted via half-open probe",
            ["deployment_name"], registry=registry)
        self._replica_drains = Counter(
            "seldon_tpu_replica_drains_total", "Decode replicas gracefully drained and released",
            ["deployment_name"], registry=registry)
        self._replica_migrations = Counter(
            "seldon_tpu_replica_migrations_total", "In-flight generations migrated off dead/draining replicas",
            ["deployment_name"], registry=registry)
        self._replica_boot_failures = Counter(
            "seldon_tpu_replica_boot_failures_total", "Scale-up replica boots that failed",
            ["deployment_name"], registry=registry)
        self._replica_spill_failures = Counter(
            "seldon_tpu_replica_spill_failures_total", "Prefix-spill store/preseed round-trips that failed",
            ["deployment_name"], registry=registry)
        # SHADOW candidate validation: per-shadow agreement with the primary
        self._shadow = Counter(
            "seldon_tpu_shadow_comparisons", "Shadow-vs-primary output comparisons",
            ["deployment_name", "predictor_name", "shadow_unit", "agree"], registry=registry)
        self._retries = Counter(
            "seldon_tpu_retries_total", "Unit-call retry attempts dispatched", ["deployment_name", "model_name"],
            registry=registry)
        self._breaker_transitions = Counter(
            "seldon_tpu_breaker_transitions_total", "Circuit breaker state transitions per endpoint",
            ["deployment_name", "endpoint", "state"], registry=registry)
        self._breaker_state = Gauge(
            "seldon_tpu_breaker_state", "Current breaker state per endpoint (0=closed 1=half_open 2=open)",
            ["deployment_name", "endpoint"], registry=registry)
        self._deadline_exceeded = Counter(
            "seldon_tpu_deadline_exceeded_total", "Requests whose deadline budget ran out, by the unit reached",
            ["deployment_name", "model_name"], registry=registry)
        self._degraded = Counter(
            "seldon_tpu_degraded_responses_total", "Responses served degraded (router_fallback | quorum)",
            ["deployment_name", "mode"], registry=registry)
        self._faults = Counter(
            "seldon_tpu_faults_injected_total", "Faults injected by the chaos harness (engine/faults.py)",
            ["deployment_name", "model_name", "kind"], registry=registry)

    def ingress_request(self, deployment, method, duration_s, trace_id=None):
        h = self._ingress.labels(deployment, method)
        if trace_id:
            try:
                h.observe(duration_s, exemplar={"trace_id": trace_id})
                return
            except ValueError:  # an exemplar past the OpenMetrics limit
                pass
        h.observe(duration_s)

    def ingress_error(self, deployment, method, code):
        self._ingress_errors.labels(deployment, method, str(code)).inc()

    def unit_call(self, deployment, predictor, unit, method, duration_s):
        self._unit.labels(deployment, predictor, unit, method).observe(duration_s)

    def feedback(self, deployment, predictor, unit, reward):
        self._feedback.labels(deployment, predictor, unit).inc()
        self._feedback_reward.labels(deployment, predictor, unit).inc(reward)

    def batch(self, deployment, size, queue_waits_s):
        self._batch_size.labels(deployment).observe(size)
        # per request: every batch-mate's wait is observed
        if isinstance(queue_waits_s, (int, float)):
            queue_waits_s = (queue_waits_s,)
        h = self._queue_wait.labels(deployment)
        for w in queue_waits_s:
            h.observe(w)

    def decode_step(self, deployment, active, slots):
        self._decode_occupancy.labels(deployment).set(active / slots if slots else 0.0)
        self._decode_steps.labels(deployment).inc()

    def decode_ttft(self, deployment, duration_s):
        self._decode_ttft.labels(deployment).observe(duration_s)

    def decode_inter_token(self, deployment, duration_s):
        self._decode_itl.labels(deployment).observe(duration_s)

    def decode_spec(self, deployment, proposed, accepted, emitted, mode="chain"):
        self._spec_proposed.labels(deployment).inc(proposed)
        self._spec_accepted.labels(deployment).inc(accepted)
        self._spec_emitted.labels(deployment, mode).observe(emitted)

    def decode_spec_tree(self, deployment, nodes, path_len):
        self._spec_tree_nodes.labels(deployment).observe(nodes)
        self._spec_tree_path.labels(deployment).observe(path_len)

    def decode_prefix(self, deployment, hit, tokens_saved):
        self._prefix_lookups.labels(deployment, "hit" if hit else "miss").inc()
        if tokens_saved > 0:
            self._prefix_saved.labels(deployment).inc(tokens_saved)

    def decode_prefix_evicted(self, deployment):
        self._prefix_evictions.labels(deployment).inc()

    def decode_ttft_split(self, deployment, duration_s, path):
        self._decode_ttft_split.labels(deployment, path).observe(duration_s)

    def decode_kv_pool(self, deployment, free, live, prefix):
        self._kv_pages_free.labels(deployment).set(free)
        self._kv_pages_live.labels(deployment).set(live)
        self._kv_pages_prefix.labels(deployment).set(prefix)

    def decode_kv_shared(self, deployment, pages):
        if pages > 0:
            self._kv_shared.labels(deployment).inc(pages)

    def decode_kv_cow(self, deployment, copies):
        if copies > 0:
            self._kv_cow.labels(deployment).inc(copies)

    def decode_kv_reclaimed(self, deployment, pins):
        if pins > 0:
            self._kv_reclaimed.labels(deployment).inc(pins)

    def decode_kv_tier_bytes(self, deployment, tier, nbytes):
        self._kv_tier_bytes.labels(deployment, tier).set(nbytes)

    def decode_kv_demotion(self, deployment, tier, n):
        if n > 0:
            self._kv_demotions.labels(deployment, tier).inc(n)

    def decode_kv_promotion(self, deployment, tier, n):
        if n > 0:
            self._kv_promotions.labels(deployment, tier).inc(n)

    def decode_kv_sibling_pull(self, deployment, outcome):
        self._kv_sibling_pulls.labels(deployment, outcome).inc()

    def decode_round(self, deployment, busy_s, gap_s):
        self._decode_round_busy.labels(deployment).observe(busy_s)
        self._decode_round_gap.labels(deployment).observe(gap_s)

    def decode_bubble(self, deployment, fraction):
        self._decode_bubble.labels(deployment).set(fraction)

    def decode_goodput(self, deployment, tokens, met):
        if tokens > 0:
            self._decode_goodput.labels(deployment, "met" if met else "breached").inc(tokens)

    def decode_slo(self, deployment, kind, ok, trace_id=None):
        c = self._decode_slo.labels(deployment, kind, "ok" if ok else "breach")
        if trace_id and not ok:
            # the breach-adjacent flight dump's trace id as the exemplar
            try:
                c.inc(exemplar={"trace_id": trace_id})
                return
            except ValueError:
                pass
        c.inc()

    def router_route(self, deployment, policy, reason):
        self._router_routes.labels(deployment, policy, reason).inc()

    def router_queue_depth(self, deployment, replica, depth):
        self._router_queue_depth.labels(deployment, str(replica)).set(depth)

    def router_arm(self, deployment, replica, estimate):
        self._router_arm.labels(deployment, str(replica)).set(estimate)

    def router_replicas(self, deployment, n):
        self._router_replicas.labels(deployment).set(n)

    def router_preseed(self, deployment, pages):
        self._router_preseed.labels(deployment).inc(pages)

    def replica_state(self, deployment, replica, state):
        from seldon_core_tpu_torch.serving.affinity_router import replica_state_value

        self._replica_state.labels(deployment, str(replica)).set(replica_state_value(state))

    def replica_eviction(self, deployment):
        self._replica_evictions.labels(deployment).inc()

    def replica_recovery(self, deployment):
        self._replica_recoveries.labels(deployment).inc()

    def replica_drain(self, deployment):
        self._replica_drains.labels(deployment).inc()

    def replica_migration(self, deployment, n):
        if n > 0:
            self._replica_migrations.labels(deployment).inc(n)

    def replica_boot_failure(self, deployment):
        self._replica_boot_failures.labels(deployment).inc()

    def replica_spill_failure(self, deployment):
        self._replica_spill_failures.labels(deployment).inc()

    def compile(self, deployment, bucket, duration_s):
        self._compile.labels(deployment, str(bucket)).observe(duration_s)

    def shadow_compare(self, deployment, predictor, shadow_unit, agree):
        self._shadow.labels(deployment, predictor, shadow_unit, "true" if agree else "false").inc()

    def loop_lag(self, lag_ms):
        self._loop_lag.set(lag_ms)
        if lag_ms > self._loop_lag_max_val:
            self._loop_lag_max_val = lag_ms
            self._loop_lag_max.set(lag_ms)

    def retry(self, deployment, unit):
        self._retries.labels(deployment, unit).inc()

    def breaker(self, deployment, endpoint, state):
        from seldon_core_tpu_torch.engine.resilience import breaker_state_value

        self._breaker_transitions.labels(deployment, endpoint, state).inc()
        self._breaker_state.labels(deployment, endpoint).set(breaker_state_value(state))

    def deadline_exceeded(self, deployment, unit):
        self._deadline_exceeded.labels(deployment, unit).inc()

    def degraded(self, deployment, mode):
        self._degraded.labels(deployment, mode).inc()

    def fault_injected(self, deployment, unit, kind):
        self._faults.labels(deployment, unit, kind).inc()

    def export(self) -> bytes:
        return self.registry.text()

    def export_openmetrics(self) -> bytes:
        return self.registry.openmetrics()


class MetricsResilienceEvents:
    """Adapter: the executor's ResilienceEvents contract -> the registry.
    The server builds one per deployment and hands it to build_executor."""

    def __init__(self, metrics: NullMetrics, deployment: str):
        self._metrics = metrics
        self._deployment = deployment

    def retry(self, unit: str, attempt: int) -> None:
        self._metrics.retry(self._deployment, unit)

    def breaker_transition(self, endpoint: str, state: str) -> None:
        self._metrics.breaker(self._deployment, endpoint, state)

    def deadline_exceeded(self, unit: str) -> None:
        self._metrics.deadline_exceeded(self._deployment, unit)

    def degraded(self, unit: str, mode: str) -> None:
        self._metrics.degraded(self._deployment, mode)

    def fault_injected(self, unit: str, kind: str) -> None:
        self._metrics.fault_injected(self._deployment, unit, kind)


async def run_loop_lag_probe(metrics: NullMetrics, interval_s: float = 0.5, sample_s: float = 0.05) -> None:
    """Sample event-loop scheduling lag forever: sleep ``sample_s`` and
    report how late the wakeup fired, the delay every other coroutine on
    the loop is seeing. The server runs this as a task and cancels it on
    stop."""
    import asyncio

    while True:
        t0 = time.perf_counter()
        await asyncio.sleep(sample_s)
        metrics.loop_lag(max(0.0, (time.perf_counter() - t0 - sample_s) * 1e3))
        await asyncio.sleep(interval_s)


def get_metrics(enabled: bool = True) -> NullMetrics:
    return Metrics() if enabled else NullMetrics()
