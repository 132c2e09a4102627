"""Inference-graph + deployment schema as frozen dataclasses.

Port of ``seldon_core_tpu/graph/spec.py`` (pydantic there): the same field
names and enums, so one SeldonDeployment JSON serves both packages — the
implementation name ``JAX_MODEL`` included, which here selects the port's
torch model unit. ``SeldonDeployment.from_dict`` parses a CR dict; other keys of
the ``tpu`` block are kept in ``TpuSpec.extra``, where
``graph/validation.py::spec_problems`` refuses by name each one the port
does not serve, so no knob a deployment sets is silently ignored. A unit's
resilience knobs (retries, breaker, fallback, quorum) ride its parameters
and parse into ``ResilienceSpec``. ``DeploymentStatus`` and
``PredictorStatus`` are the status the operator writes back, and
``to_json`` dumps any of these as the JAX package's models dump.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Mapping, Optional


class PredictiveUnitType(str, enum.Enum):
    UNKNOWN_TYPE = "UNKNOWN_TYPE"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    MODEL = "MODEL"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"


class PredictiveUnitImplementation(str, enum.Enum):
    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"
    EPSILON_GREEDY = "EPSILON_GREEDY"
    JAX_MODEL = "JAX_MODEL"  # in-process model from the zoo (torch here)
    MEAN_TRANSFORMER = "MEAN_TRANSFORMER"
    FAULT_INJECTOR = "FAULT_INJECTOR"
    OUTLIER_DETECTOR = "OUTLIER_DETECTOR"
    PYTHON_CLASS = "PYTHON_CLASS"
    SHADOW = "SHADOW"
    PREFIX_AFFINITY = "PREFIX_AFFINITY"


class PredictiveUnitMethod(str, enum.Enum):
    TRANSFORM_INPUT = "TRANSFORM_INPUT"
    TRANSFORM_OUTPUT = "TRANSFORM_OUTPUT"
    ROUTE = "ROUTE"
    AGGREGATE = "AGGREGATE"
    SEND_FEEDBACK = "SEND_FEEDBACK"


class EndpointType(str, enum.Enum):
    REST = "REST"
    GRPC = "GRPC"


class ParameterType(str, enum.Enum):
    INT = "INT"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    STRING = "STRING"
    BOOL = "BOOL"


def _required(obj: Mapping[str, Any], key: str, what: str) -> Any:
    if not isinstance(obj, Mapping):
        raise ValueError(f"{what} must be a JSON object, got {type(obj).__name__}")
    if key not in obj:
        raise ValueError(f"{what} needs '{key}'")
    return obj[key]


def _enum(cls, value, what: str):
    try:
        return cls(value)
    except ValueError:
        raise ValueError(
            f"{what}: {value!r} is not one of {[m.value for m in cls]}"
        ) from None


@dataclass(frozen=True)
class Endpoint:
    service_host: str = ""
    service_port: int = 0
    type: EndpointType = EndpointType.REST

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "Endpoint":
        return Endpoint(
            service_host=str(obj.get("service_host", "")),
            service_port=int(obj.get("service_port", 0)),
            type=_enum(EndpointType, obj.get("type", "REST"), "endpoint.type"),
        )


@dataclass(frozen=True)
class Parameter:
    name: str
    value: str
    type: ParameterType = ParameterType.STRING

    def typed_value(self) -> Any:
        if self.type == ParameterType.INT:
            return int(self.value)
        if self.type in (ParameterType.FLOAT, ParameterType.DOUBLE):
            return float(self.value)
        if self.type == ParameterType.BOOL:
            return self.value.strip().lower() in ("true", "1", "yes")
        return self.value

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "Parameter":
        return Parameter(
            name=str(_required(obj, "name", "parameter")),
            value=str(_required(obj, "value", "parameter")),
            type=_enum(ParameterType, obj.get("type", "STRING"), "parameter.type"),
        )


def parameters_dict(params) -> dict[str, Any]:
    return {p.name: p.typed_value() for p in params}


def bool_param(value: Any) -> bool:
    """Strict boolean coercion: the STRING value "false" is not enabled."""
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("true", "1", "yes")


@dataclass(frozen=True)
class RetrySpec:
    """Per-node retry policy (engine/resilience.RetryState runs it). Retries
    apply only to idempotent methods (never send_feedback) and only to
    transport/5xx-class failures, and never sleep past the deadline."""

    max_attempts: int = 1  # total attempts; 1 = no retry
    backoff_ms: float = 25.0  # first backoff; grows by backoff_mult
    backoff_mult: float = 2.0
    jitter: float = 0.5  # +/- fraction applied to each backoff
    seed: Optional[int] = None  # deterministic jitter for tests and chaos runs


@dataclass(frozen=True)
class BreakerSpec:
    """Per-node circuit breaker (engine/resilience.CircuitBreaker): opens on
    ``failure_threshold`` consecutive failures or a windowed error rate >=
    ``error_rate``; after ``reset_ms`` admits ``half_open_probes`` probes
    (a success closes it, a failure re-opens it)."""

    failure_threshold: int = 5
    error_rate: float = 0.5
    window: int = 20
    reset_ms: float = 1000.0
    half_open_probes: int = 1


@dataclass(frozen=True)
class ResilienceSpec:
    """Resilience knobs of ONE graph node, parsed from its CR parameters:

    - ``retry_max_attempts`` (> 1 enables retry), ``retry_backoff_ms``,
      ``retry_backoff_mult``, ``retry_jitter``, ``retry_seed``
    - ``breaker_failure_threshold`` (> 0 enables the breaker),
      ``breaker_error_rate``, ``breaker_window``, ``breaker_reset_ms``,
      ``breaker_half_open_probes``
    - ``fallback_child`` (ROUTER: the branch served when the chosen child's
      breaker is open or its subtree fails transport-class)
    - ``quorum`` (COMBINER: aggregate this many surviving children instead
      of failing the request when a child errors)
    """

    retry: Optional[RetrySpec] = None
    breaker: Optional[BreakerSpec] = None
    fallback_child: Optional[int] = None
    quorum: Optional[int] = None

    @staticmethod
    def from_parameters(params: Mapping[str, Any]) -> "ResilienceSpec":
        retry = None
        if int(params.get("retry_max_attempts", 1)) > 1:
            retry = RetrySpec(
                max_attempts=int(params["retry_max_attempts"]),
                backoff_ms=float(params.get("retry_backoff_ms", 25.0)),
                backoff_mult=float(params.get("retry_backoff_mult", 2.0)),
                jitter=float(params.get("retry_jitter", 0.5)),
                seed=int(params["retry_seed"]) if "retry_seed" in params else None,
            )
        breaker = None
        if int(params.get("breaker_failure_threshold", 0)) > 0:
            breaker = BreakerSpec(
                failure_threshold=int(params["breaker_failure_threshold"]),
                error_rate=float(params.get("breaker_error_rate", 0.5)),
                window=int(params.get("breaker_window", 20)),
                reset_ms=float(params.get("breaker_reset_ms", 1000.0)),
                half_open_probes=int(params.get("breaker_half_open_probes", 1)),
            )
        return ResilienceSpec(
            retry=retry,
            breaker=breaker,
            fallback_child=int(params["fallback_child"]) if "fallback_child" in params else None,
            quorum=int(params["quorum"]) if "quorum" in params else None,
        )

    @staticmethod
    def for_unit(unit: "PredictiveUnit") -> "ResilienceSpec":
        return ResilienceSpec.from_parameters(parameters_dict(unit.parameters))


@dataclass(frozen=True)
class PredictiveUnit:
    name: str
    children: tuple["PredictiveUnit", ...] = ()
    type: Optional[PredictiveUnitType] = None
    implementation: Optional[PredictiveUnitImplementation] = None
    methods: tuple[PredictiveUnitMethod, ...] = ()
    endpoint: Optional[Endpoint] = None
    parameters: tuple[Parameter, ...] = ()

    def walk(self):
        """Pre-order traversal of the unit tree."""
        yield self
        for c in self.children:
            yield from c.walk()

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "PredictiveUnit":
        name = str(_required(obj, "name", "graph unit"))
        what = f"unit '{name}'"
        typ = obj.get("type")
        impl = obj.get("implementation")
        endpoint = obj.get("endpoint")
        return PredictiveUnit(
            name=name,
            children=tuple(PredictiveUnit.from_dict(c) for c in obj.get("children") or ()),
            type=None if typ is None else _enum(PredictiveUnitType, typ, f"{what} type"),
            implementation=None
            if impl is None
            else _enum(PredictiveUnitImplementation, impl, f"{what} implementation"),
            methods=tuple(
                _enum(PredictiveUnitMethod, m, f"{what} method")
                for m in obj.get("methods") or ()
            ),
            endpoint=None if endpoint is None else Endpoint.from_dict(endpoint),
            parameters=tuple(Parameter.from_dict(p) for p in obj.get("parameters") or ()),
        )


_TPU_FIELDS = (
    "mesh",
    "batch_buckets",
    "max_batch",
    "batch_timeout_ms",
    "queue_timeout_ms",
    "dtype",
    "offload_compute",
    "fuse_graph",
    "deadline_ms",
    "batch_across_requests",
    "weight_quant",
    "donate_input",
    "decode_slots",
    "decode_eos_id",
    "decode_temperature",
    "decode_top_k",
    "decode_seed",
    "decode_prefix_slots",
    "decode_prefix_ctx",
    "decode_prefill_chunk",
    "decode_kv_page_size",
    "decode_kv_pages",
    "decode_kv_dtype",
    "decode_kv_host_bytes",
    "decode_kv_store_tier",
    "decode_draft_model",
    "decode_spec_k",
    "decode_spec_tree",
    "decode_spec_accept_floor",
    "decode_slo_ttft_ms",
    "decode_slo_itl_ms",
    "decode_npy_bindata",
    "decode_replicas",
    "decode_router_policy",
    "decode_autoscale_replicas",
    "decode_autoscale_queue_depth",
    "decode_health_poll_ms",
    "decode_health_miss_threshold",
    "decode_drain_timeout_ms",
)


@dataclass(frozen=True)
class TpuSpec:
    """A predictor's execution config. The port reads these fields; every
    other key of the CR's ``tpu`` block stays in ``extra``, where
    ``graph/validation.py::spec_problems`` refuses the ones the port does
    not serve."""

    mesh: Mapping[str, int] = field(default_factory=dict)
    batch_buckets: tuple[int, ...] = ()  # () -> derived from max_batch
    max_batch: int = 64
    batch_timeout_ms: float = 3.0
    queue_timeout_ms: float = 2000.0
    dtype: str = "float32"  # float32 | bfloat16 | float16
    # "auto": time the forward at warmup and run slow ones (>= 3 ms) on the
    # compute pool so they never stall the serving loop; "always" / "never"
    offload_compute: str = "auto"
    # collapse pure subtrees (models, combiners, pure transformers) into one
    # fused forward at build time (engine/fused.py)
    fuse_graph: bool = True
    # per-request deadline budget stamped at the serving entrypoint (0: none);
    # a request's meta.tags["deadline_ms"] may tighten it, never widen it
    deadline_ms: float = 0.0
    # False: no micro-batcher, every request walks the graph on its own
    batch_across_requests: bool = True
    # "int8": weight-only int8 (models/quant.py, ops/int8_matmul.py)
    weight_quant: str = ""
    # accepted for the JAX package's CR; eager PyTorch frees the input when
    # its last reference drops, and the output never depends on it
    donate_input: bool = False
    # the generative tier (serving/decode_scheduler.py): decode_slots > 0
    # serves a single-node decoder through the continuous-batching loop
    decode_slots: int = 0
    decode_eos_id: int = -1  # -1: no EOS, every request runs its budget
    decode_temperature: float = 0.0  # <= 0: greedy
    decode_top_k: int = 0  # <= 0: the full vocabulary
    decode_seed: int = 0
    decode_prefix_slots: int = 0  # prefix-index entries (0: no prefix reuse)
    decode_prefix_ctx: int = 0  # longest capturable prefix (0: the prompt)
    decode_prefill_chunk: int = 0  # prompt tokens per chunk round (0: all)
    decode_kv_page_size: int = 0  # tokens per page (0: 16)
    decode_kv_pages: int = 0  # page budget (0: flat-equivalent)
    decode_kv_dtype: str = ""  # "" or "int8"
    # the prefix tiers below the pool: host bytes (0: none) and the store
    # the host tier's LRU spills to ("file://<dir>" or "redis://...")
    decode_kv_host_bytes: int = 0
    decode_kv_store_tier: str = ""
    # draft-model speculation: a zoo:// draft with a chain depth or a tree
    decode_draft_model: str = ""
    decode_spec_k: int = 0  # proposed tokens per round (0: no chain)
    decode_spec_tree: str = ""  # per-depth branching, e.g. "2,2,1,1"
    decode_spec_accept_floor: float = 0.0  # accept-rate floor (0: fixed shape)
    # decode SLO targets the attainment telemetry judges (0: none): a
    # breach moves seldon_tpu_decode_slo_attainment_total, dumps the flight
    # ring and marks the row's meta.tags.slo; scheduling is unchanged
    decode_slo_ttft_ms: float = 0.0
    decode_slo_itl_ms: float = 0.0
    # False: binData is never sniffed for the npy magic (an explicit
    # application/x-npy body is still decoded); one value per deployment
    decode_npy_bindata: bool = True
    # the replicated decode fleet (serving/affinity_router.py): replicas
    # behind the router (affinity | round_robin | bandit; "" affinity), the
    # autoscale cap and its queue-depth trigger (0: off), the health poll
    # interval (0: off), the misses that evict, and the drain budget
    decode_replicas: int = 1
    decode_router_policy: str = ""
    decode_autoscale_replicas: int = 0
    decode_autoscale_queue_depth: int = 0
    decode_health_poll_ms: float = 0.0
    decode_health_miss_threshold: int = 3
    decode_drain_timeout_ms: float = 5000.0
    extra: Mapping[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "TpuSpec":
        return TpuSpec(
            mesh={str(k): int(v) for k, v in (obj.get("mesh") or {}).items()},
            batch_buckets=tuple(int(b) for b in obj.get("batch_buckets") or ()),
            max_batch=int(obj.get("max_batch", 64)),
            batch_timeout_ms=float(obj.get("batch_timeout_ms", 3.0)),
            queue_timeout_ms=float(obj.get("queue_timeout_ms", 2000.0)),
            dtype=str(obj.get("dtype", "float32")),
            offload_compute=str(obj.get("offload_compute", "auto")),
            fuse_graph=bool_param(obj.get("fuse_graph", True)),
            deadline_ms=float(obj.get("deadline_ms", 0.0)),
            batch_across_requests=bool_param(obj.get("batch_across_requests", True)),
            weight_quant=str(obj.get("weight_quant", "") or ""),
            donate_input=bool_param(obj.get("donate_input", False)),
            decode_slots=int(obj.get("decode_slots", 0)),
            decode_eos_id=int(obj.get("decode_eos_id", -1)),
            decode_temperature=float(obj.get("decode_temperature", 0.0)),
            decode_top_k=int(obj.get("decode_top_k", 0)),
            decode_seed=int(obj.get("decode_seed", 0)),
            decode_prefix_slots=int(obj.get("decode_prefix_slots", 0)),
            decode_prefix_ctx=int(obj.get("decode_prefix_ctx", 0)),
            decode_prefill_chunk=int(obj.get("decode_prefill_chunk", 0)),
            decode_kv_page_size=int(obj.get("decode_kv_page_size", 0)),
            decode_kv_pages=int(obj.get("decode_kv_pages", 0)),
            decode_kv_dtype=str(obj.get("decode_kv_dtype", "")),
            decode_kv_host_bytes=int(obj.get("decode_kv_host_bytes", 0)),
            decode_kv_store_tier=str(obj.get("decode_kv_store_tier", "") or ""),
            decode_draft_model=str(obj.get("decode_draft_model", "") or ""),
            decode_spec_k=int(obj.get("decode_spec_k", 0)),
            decode_spec_tree=str(obj.get("decode_spec_tree", "") or ""),
            decode_spec_accept_floor=float(obj.get("decode_spec_accept_floor", 0.0)),
            decode_slo_ttft_ms=float(obj.get("decode_slo_ttft_ms", 0.0)),
            decode_slo_itl_ms=float(obj.get("decode_slo_itl_ms", 0.0)),
            decode_npy_bindata=bool_param(obj.get("decode_npy_bindata", True)),
            decode_replicas=int(obj.get("decode_replicas", 1)),
            decode_router_policy=str(obj.get("decode_router_policy", "") or ""),
            decode_autoscale_replicas=int(obj.get("decode_autoscale_replicas", 0)),
            decode_autoscale_queue_depth=int(obj.get("decode_autoscale_queue_depth", 0)),
            decode_health_poll_ms=float(obj.get("decode_health_poll_ms", 0.0)),
            decode_health_miss_threshold=int(obj.get("decode_health_miss_threshold", 3)),
            decode_drain_timeout_ms=float(obj.get("decode_drain_timeout_ms", 5000.0)),
            extra={k: v for k, v in obj.items() if k not in _TPU_FIELDS},
        )


@dataclass(frozen=True)
class ContainerSpec:
    name: str
    image: str = ""
    env: Mapping[str, str] = field(default_factory=dict)
    model_uri: str = ""

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "ContainerSpec":
        return ContainerSpec(
            name=str(_required(obj, "name", "container")),
            image=str(obj.get("image", "")),
            env={str(k): str(v) for k, v in (obj.get("env") or {}).items()},
            model_uri=str(obj.get("model_uri", "")),
        )


@dataclass(frozen=True)
class ComponentSpec:
    containers: tuple[ContainerSpec, ...] = ()

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "ComponentSpec":
        return ComponentSpec(
            containers=tuple(ContainerSpec.from_dict(c) for c in obj.get("containers") or ())
        )


@dataclass(frozen=True)
class PredictorSpec:
    name: str
    graph: PredictiveUnit
    componentSpec: ComponentSpec = field(default_factory=ComponentSpec)
    replicas: int = 1
    annotations: Mapping[str, str] = field(default_factory=dict)
    tpu: TpuSpec = field(default_factory=TpuSpec)

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "PredictorSpec":
        return PredictorSpec(
            name=str(_required(obj, "name", "predictor")),
            graph=PredictiveUnit.from_dict(_required(obj, "graph", "predictor")),
            componentSpec=ComponentSpec.from_dict(obj.get("componentSpec") or {}),
            replicas=int(obj.get("replicas", 1)),
            annotations=dict(obj.get("annotations") or {}),
            tpu=TpuSpec.from_dict(obj.get("tpu") or {}),
        )


@dataclass(frozen=True)
class DeploymentSpec:
    name: str = ""
    predictors: tuple[PredictorSpec, ...] = ()
    oauth_key: str = ""
    oauth_secret: str = ""
    annotations: Mapping[str, str] = field(default_factory=dict)

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "DeploymentSpec":
        return DeploymentSpec(
            name=str(obj.get("name", "")),
            predictors=tuple(PredictorSpec.from_dict(p) for p in obj.get("predictors") or ()),
            oauth_key=str(obj.get("oauth_key", "")),
            oauth_secret=str(obj.get("oauth_secret", "")),
            annotations=dict(obj.get("annotations") or {}),
        )


@dataclass(frozen=True)
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Mapping[str, str] = field(default_factory=dict)
    annotations: Mapping[str, str] = field(default_factory=dict)
    resourceVersion: str = ""

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "ObjectMeta":
        return ObjectMeta(
            name=str(obj.get("name", "")),
            namespace=str(obj.get("namespace", "default")),
            labels=dict(obj.get("labels") or {}),
            annotations=dict(obj.get("annotations") or {}),
            resourceVersion=str(obj.get("resourceVersion", "")),
        )


@dataclass(frozen=True)
class PredictorStatus:
    name: str
    status: str = ""
    description: str = ""
    replicas: int = 0
    replicasAvailable: int = 0


@dataclass(frozen=True)
class DeploymentStatus:
    state: str = ""
    description: str = ""
    predictorStatus: tuple[PredictorStatus, ...] = ()


@dataclass(frozen=True)
class SeldonDeployment:
    apiVersion: str = "machinelearning.seldon.io/v1alpha1"
    kind: str = "SeldonDeployment"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)

    def to_dict(self) -> dict:
        """The CR as JSON, ``None`` fields left out (the JAX package's
        ``to_dict``)."""
        return to_json(self, exclude_none=True)

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "SeldonDeployment":
        if not isinstance(obj, Mapping):
            raise ValueError("a SeldonDeployment must be a JSON object")
        return SeldonDeployment(
            apiVersion=str(obj.get("apiVersion", "machinelearning.seldon.io/v1alpha1")),
            kind=str(obj.get("kind", "SeldonDeployment")),
            metadata=ObjectMeta.from_dict(obj.get("metadata") or {}),
            spec=DeploymentSpec.from_dict(obj.get("spec") or {}),
        )


def to_json(obj: Any, exclude_none: bool = False) -> Any:
    """A spec object as the JSON the JAX package's pydantic models dump
    (``model_dump(mode="json")``): enums by value, tuples as lists, every
    field with its default. ``TpuSpec.extra`` is not a field there: its
    ``decode_mesh_axes`` is (default ``{}``), and its other keys, which the
    JAX package drops, are kept beside the fields, so two CRs that differ
    only in a key the port refuses never dump the same."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, TpuSpec):
        out = {f.name: to_json(getattr(obj, f.name), exclude_none) for f in fields(obj) if f.name != "extra"}
        out["decode_mesh_axes"] = {str(k): int(v) for k, v in (obj.extra.get("decode_mesh_axes") or {}).items()}
        out.update({k: v for k, v in obj.extra.items() if k != "decode_mesh_axes"})
        return out
    if is_dataclass(obj):
        out = {f.name: to_json(getattr(obj, f.name), exclude_none) for f in fields(obj)}
        return {k: v for k, v in out.items() if v is not None} if exclude_none else out
    if isinstance(obj, Mapping):
        return {str(k): to_json(v, exclude_none) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [to_json(v, exclude_none) for v in obj]
    return obj


# Methods implied by each unit type (reference PredictorConfigBean).
TYPE_METHODS: dict[PredictiveUnitType, tuple[PredictiveUnitMethod, ...]] = {
    PredictiveUnitType.MODEL: (PredictiveUnitMethod.TRANSFORM_INPUT,),
    PredictiveUnitType.TRANSFORMER: (PredictiveUnitMethod.TRANSFORM_INPUT,),
    PredictiveUnitType.OUTPUT_TRANSFORMER: (PredictiveUnitMethod.TRANSFORM_OUTPUT,),
    PredictiveUnitType.ROUTER: (
        PredictiveUnitMethod.ROUTE,
        PredictiveUnitMethod.SEND_FEEDBACK,
    ),
    PredictiveUnitType.COMBINER: (PredictiveUnitMethod.AGGREGATE,),
}

# Implementations that run in-process (no endpoint wired by defaulting).
BUILTIN_IMPLEMENTATIONS = frozenset(
    m for m in PredictiveUnitImplementation if m != PredictiveUnitImplementation.UNKNOWN_IMPLEMENTATION
)
