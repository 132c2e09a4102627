"""Inference-graph + deployment schema as frozen dataclasses.

Port of ``seldon_core_tpu/graph/spec.py`` (pydantic there): the same field
names and enums, so one SeldonDeployment JSON serves both packages — the
implementation name ``JAX_MODEL`` included, which here selects the port's
torch model unit. ``SeldonDeployment.from_dict`` parses a CR dict; keys this
port does not read are kept (``TpuSpec.extra``) or ignored, never rejected,
so every example deployment still parses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
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
)


@dataclass(frozen=True)
class TpuSpec:
    """A predictor's execution config. The port reads these fields; every
    other key of the CR's ``tpu`` block stays in ``extra``, unread."""

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
class SeldonDeployment:
    apiVersion: str = "machinelearning.seldon.io/v1alpha1"
    kind: str = "SeldonDeployment"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)

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
