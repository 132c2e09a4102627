"""Built-in graph units (no container needed).

Port of ``seldon_core_tpu/engine/builtin.py``: SIMPLE_MODEL (constant
output test stub), SIMPLE_ROUTER (always child 0), RANDOM_ABTEST (seeded
A/B split), EPSILON_GREEDY (bandit router fed by send_feedback),
MEAN_TRANSFORMER (subtracts stored means) and AVERAGE_COMBINER (element-wise
mean ensemble), plus JAX_MODEL, the deployment JSON's name for an
in-process zoo model. Routing draws from Python's ``random.Random`` exactly
as the JAX package does, so the same requests give the same
``meta.routing`` in both packages.

A payload here is host numpy or a torch tensor on the card: in the
single-request walk a model's output reaches its parent still on the
device. The combiner and the transformer compute on the device for tensors
and on the host for numpy, so nothing is read back mid-graph.
"""

from __future__ import annotations

import random
import threading
from typing import Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.engine.units import Unit, UnitRegistry
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, PredictiveUnitImplementation


def _seeded_rng(seed) -> random.Random:
    """seed=None -> OS entropy; any explicit seed (including 0) is honored."""
    return random.Random(int(seed)) if seed is not None else random.Random()


def _parse_float_vec(unit_label: str, key: str, raw) -> np.ndarray:
    """Comma-separated float vector parameter (a single value broadcasts)."""
    try:
        return np.asarray([float(v) for v in str(raw).strip().split(",")], np.float32)
    except ValueError as e:
        raise ValueError(f"{unit_label} bad '{key}' parameter: {e}") from e


def _shape(array) -> tuple[int, ...]:
    return tuple(array.shape) if hasattr(array, "shape") else np.asarray(array).shape


class SimpleModelUnit(Unit):
    """Constant-output test model: [[0.1, 0.9, 0.5]] per row, classes
    c0, c1, c2; optional ``delay_ms`` parameter."""

    VALUES = np.asarray([[0.1, 0.9, 0.5]], dtype=np.float32)
    CLASS_NAMES = ("c0", "c1", "c2")

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        delay_ms = float(self.params.get("delay_ms", 0.0))
        if delay_ms > 0:
            import asyncio

            await asyncio.sleep(delay_ms / 1000.0)
        batch = 1
        if msg.array is not None:
            shape = _shape(msg.array)
            if shape:
                batch = int(shape[0])
        return msg.with_array(np.repeat(self.VALUES, batch, axis=0), self.CLASS_NAMES)


class SimpleRouterUnit(Unit):
    """Always routes to child 0."""

    async def route(self, msg: SeldonMessage) -> int:
        return 0


class MeanTransformerUnit(Unit):
    """Input-centering transformer: subtracts the stored ``means`` parameter
    (comma-separated floats, a single value broadcasts). Which endpoint runs
    is picked by the node type, so an OUTPUT_TRANSFORMER centers the model
    output instead of the input."""

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        raw = str(self.params.get("means", "")).strip()
        if not raw:
            raise ValueError(f"MEAN_TRANSFORMER '{spec.name}' requires a 'means' parameter")
        self.means = _parse_float_vec(f"MEAN_TRANSFORMER '{spec.name}'", "means", raw)

    def _center(self, msg: SeldonMessage) -> SeldonMessage:
        if msg.array is None:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, f"unit '{self.name}' needs tensor data")
        x = msg.array
        features = _shape(x)[-1]
        if self.means.size not in (1, features):
            raise APIException(
                ErrorCode.ENGINE_MICROSERVICE_ERROR,
                f"unit '{self.name}': means has {self.means.size} values "
                f"but input has {features} features",
            )
        if isinstance(x, torch.Tensor):  # a model's output, still on its device
            out = x.float() - torch.from_numpy(self.means).to(x.device)
        else:
            out = np.asarray(x, dtype=np.float32) - self.means
        return msg.with_array(out, msg.names)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return self._center(msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return self._center(msg)

    def _pure_center(self):
        name = self.name

        def fn(means, x):
            # the unfused walk's structured error, raised on the fused path
            if means.shape[0] not in (1, x.shape[-1]):
                raise APIException(
                    ErrorCode.ENGINE_MICROSERVICE_ERROR,
                    f"unit '{name}': means has {means.shape[0]} values "
                    f"but input has {x.shape[-1]} features",
                )
            return x - means.to(x.dtype)

        return fn, self.means

    def as_pure_input_fn(self):
        return self._pure_center()

    def as_pure_output_fn(self):
        return self._pure_center()


class RandomABTestUnit(Unit):
    """Seeded A/B split: parameter ``ratioA`` is the probability of child 0;
    the generator is seeded 1337, so the routing sequence is fixed."""

    SEED = 1337

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        self.ratio_a = float(self.params.get("ratioA", 0.5))
        self._rng = random.Random(self.SEED)
        self._lock = threading.Lock()

    async def route(self, msg: SeldonMessage) -> int:
        if len(self.spec.children) < 2:
            raise APIException(
                ErrorCode.ENGINE_INVALID_ABTEST,
                f"RANDOM_ABTEST '{self.name}' needs 2 children, has {len(self.spec.children)}",
            )
        with self._lock:
            draw = self._rng.random()
        return 0 if draw < self.ratio_a else 1


class EpsilonGreedyRouter(Unit):
    """Multi-armed bandit router. Parameters: ``epsilon`` (exploration rate,
    default 0.1), ``seed``. Per-arm pull counts and summed rewards live on
    the host and move only through send_feedback."""

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        self.epsilon = float(self.params.get("epsilon", 0.1))
        self._rng = _seeded_rng(self.params.get("seed"))
        n = max(len(spec.children), 1)
        self.counts = [0] * n
        self.rewards = [0.0] * n
        self._lock = threading.Lock()

    async def route(self, msg: SeldonMessage) -> int:
        n = len(self.spec.children)
        if n == 0:
            raise APIException(ErrorCode.ENGINE_INVALID_ROUTING, "router has no children")
        with self._lock:
            if self._rng.random() < self.epsilon:
                return self._rng.randrange(n)
            means = [
                self.rewards[i] / self.counts[i] if self.counts[i] else float("inf")
                for i in range(n)
            ]
            return int(max(range(n), key=means.__getitem__))

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        if routing < 0 or routing >= len(self.counts):
            return
        with self._lock:
            self.counts[routing] += 1
            self.rewards[routing] += feedback.reward


class AverageCombinerUnit(Unit):
    """Element-wise mean ensemble; children of different shapes are an
    error. Tensors are averaged on their device, numpy on the host."""

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        if not msgs:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, "combiner got no inputs")
        arrays = []
        shape = None
        for m in msgs:
            if m.array is None:
                raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, "combiner child returned no tensor")
            a = m.array if isinstance(m.array, torch.Tensor) else np.asarray(m.array)
            if shape is None:
                shape = tuple(a.shape)
            elif tuple(a.shape) != shape:
                raise APIException(
                    ErrorCode.ENGINE_INVALID_RESPONSE,
                    f"combiner shape mismatch: {tuple(a.shape)} vs {shape}",
                )
            arrays.append(a)
        devices = [a.device for a in arrays if isinstance(a, torch.Tensor)]
        if devices:
            stacked = torch.stack([torch.as_tensor(a, device=devices[0]) for a in arrays])
            if not stacked.is_floating_point():
                stacked = stacked.float()
            mean = stacked.mean(dim=0)
        else:
            mean = np.mean(np.stack(arrays, axis=0), axis=0)
        return msgs[0].with_array(mean)

    def as_pure_fn(self):
        def fn(params, xs):  # xs: the child outputs
            return torch.stack(list(xs), dim=0).mean(dim=0)

        return fn, None


def _make_model_unit(spec: PredictiveUnit, context: dict) -> Unit:
    from seldon_core_tpu_torch.models.zoo import make_model_unit

    return make_model_unit(spec, context)


def _not_ported(spec: PredictiveUnit, context: dict) -> Unit:
    raise ValueError(
        f"unit '{spec.name}': implementation {spec.implementation.value} is not "
        "part of the torch port yet"
    )


_NOT_PORTED = (
    PredictiveUnitImplementation.FAULT_INJECTOR,
    PredictiveUnitImplementation.OUTLIER_DETECTOR,
    PredictiveUnitImplementation.PYTHON_CLASS,
    PredictiveUnitImplementation.SHADOW,
    PredictiveUnitImplementation.PREFIX_AFFINITY,
)


def register_builtins(registry: UnitRegistry) -> None:
    simple = {
        PredictiveUnitImplementation.SIMPLE_MODEL: SimpleModelUnit,
        PredictiveUnitImplementation.SIMPLE_ROUTER: SimpleRouterUnit,
        PredictiveUnitImplementation.RANDOM_ABTEST: RandomABTestUnit,
        PredictiveUnitImplementation.AVERAGE_COMBINER: AverageCombinerUnit,
        PredictiveUnitImplementation.EPSILON_GREEDY: EpsilonGreedyRouter,
        PredictiveUnitImplementation.MEAN_TRANSFORMER: MeanTransformerUnit,
    }
    for impl, cls in simple.items():
        registry.register(impl, lambda spec, ctx, _cls=cls: _cls(spec))
    for impl in _NOT_PORTED:
        registry.register(impl, _not_ported)
    registry.register(PredictiveUnitImplementation.JAX_MODEL, _make_model_unit)
