"""Graph-unit interface, the user-class adapters and the implementation
registry.

Port of ``seldon_core_tpu/engine/units.py`` (the ``Unit`` base,
``PythonClassUnit``, ``OutlierDetectorUnit``, ``UnitRegistry`` and
``default_registry``). Default method semantics:
transform_input / transform_output are identity (for MODEL units
transform_input IS predict); route -1 fans out to all children; aggregate
passes a single child output through and rejects many; send_feedback does
nothing. The ``as_pure_*`` hooks let graph fusion (``engine/fused.py``)
express a unit as a pure torch function; a unit without one never fuses.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Sequence

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_host
from seldon_core_tpu_torch.graph.spec import (
    PredictiveUnit,
    PredictiveUnitImplementation,
    parameters_dict,
)

ROUTE_ALL = -1


async def _maybe_await(value):
    if inspect.isawaitable(value):
        return await value
    return value


class Unit:
    """Base graph unit: identity transforms, fan-out routing."""

    def __init__(self, spec: PredictiveUnit):
        self.spec = spec
        self.name = spec.name
        self.params: dict[str, Any] = parameters_dict(spec.parameters)
        # what serves this unit (container image, else the implementation
        # name), reported in meta.requestPath
        self.image: str = spec.implementation.value if spec.implementation else ""

    def ready(self) -> bool:
        return True

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return msg

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return msg

    async def route(self, msg: SeldonMessage) -> int:
        return ROUTE_ALL

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        if len(msgs) == 1:
            return msgs[0]
        raise APIException(
            ErrorCode.ENGINE_INVALID_ROUTING,
            f"unit '{self.name}' received {len(msgs)} child outputs but does not aggregate",
        )

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        return None

    # hooks for graph fusion (engine/fused.py): a unit that can express itself
    # as a pure torch function returns (fn, params); others None.
    # as_pure_fn: combiner aggregate, fn(params, [child outputs]) -> y
    def as_pure_fn(self):
        return None

    # as_pure_input_fn: transform_input equivalent, fn(params, x) -> x'
    def as_pure_input_fn(self):
        return None

    # as_pure_output_fn: transform_output equivalent, fn(params, y) -> y'
    def as_pure_output_fn(self):
        return None


class PythonClassUnit(Unit):
    """Adapter for duck-typed user model classes, the reference's
    wrappers/python contract:

        class MyModel:
            def predict(self, X, feature_names): ...
            def route(self, X, feature_names): ...
            def aggregate(self, Xs, feature_names_list): ...
            def transform_input/transform_output(self, X, feature_names): ...
            def send_feedback(self, X, feature_names, routing, reward, truth): ...
            class_names / feature_names attributes optional

    Methods may be sync or async; a sync method runs inline on the event
    loop's thread, as in the JAX package. Arrays in and out are host numpy:
    a tensor a model left on the card is read back before the user sees it.
    """

    def __init__(self, spec: PredictiveUnit, user_object: Any):
        super().__init__(spec)
        self.user = user_object

    def _names_out(self, fallback: Sequence[str]) -> tuple[str, ...]:
        cn = getattr(self.user, "class_names", None)
        return tuple(cn) if cn is not None else tuple(fallback)

    @staticmethod
    def _payload(msg: SeldonMessage):
        """What the user method receives: the tensor when the data arm is
        set, else the raw bytes or str payload as is (the reference
        microservice hands binData/strData to a user predict())."""
        if msg.data is not None:
            return to_host(msg.array)
        if msg.bin_data is not None:
            return msg.bin_data
        return msg.str_data

    def _wrap_output(self, msg: SeldonMessage, out) -> SeldonMessage:
        """Mirror the user's return type onto the oneof: bytes -> binData,
        str -> strData, everything else the tensor arm."""
        if isinstance(out, (bytes, bytearray)):
            return msg.with_bin_data(out)
        if isinstance(out, str):
            return msg.with_str_data(out)
        return msg.with_array(np.asarray(out), self._names_out(msg.names))

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        fn = getattr(self.user, "predict", None) or getattr(self.user, "transform_input", None)
        if fn is None:
            return msg
        out = await _maybe_await(fn(self._payload(msg), list(msg.names)))
        return self._wrap_output(msg, out)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        fn = getattr(self.user, "transform_output", None)
        if fn is None:
            return msg
        out = await _maybe_await(fn(self._payload(msg), list(msg.names)))
        return self._wrap_output(msg, out)

    async def route(self, msg: SeldonMessage) -> int:
        fn = getattr(self.user, "route", None)
        if fn is None:
            return ROUTE_ALL
        out = await _maybe_await(fn(self._payload(msg), list(msg.names)))
        return int(np.asarray(out).reshape(-1)[0])

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        fn = getattr(self.user, "aggregate", None)
        if fn is None:
            return await super().aggregate(msgs)
        xs = [self._payload(m) for m in msgs]
        names = [list(m.names) for m in msgs]
        out = await _maybe_await(fn(xs, names))
        return self._wrap_output(msgs[0], out)

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        fn = getattr(self.user, "send_feedback", None)
        if fn is None:
            return
        req = feedback.request
        # the same payload rule as predict: tensor, else raw bytes/str
        x = self._payload(req) if req is not None else None
        names = list(req.names) if req is not None else []
        truth = (
            to_host(feedback.truth.array)
            if feedback.truth is not None and feedback.truth.array is not None
            else None
        )
        await _maybe_await(fn(x, names, routing, feedback.reward, truth))


class OutlierDetectorUnit(PythonClassUnit):
    """Adapter for outlier-scoring user classes, the reference's fourth
    microservice flavour: the class exposes ``score(X, feature_names)``;
    transform_input passes the data through unchanged and writes the score
    into ``meta.tags.outlierScore``, a float, or a list for a per-row
    score."""

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        fn = getattr(self.user, "score", None)
        if fn is None:
            return msg
        if msg.array is None:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, f"unit '{self.name}' needs tensor data")
        out = await _maybe_await(fn(to_host(msg.array), list(msg.names)))
        score = np.asarray(out, dtype=np.float64)
        value: Any = (
            float(score.reshape(-1)[0]) if score.size == 1 else [float(v) for v in score.reshape(-1)]
        )
        tags = {**msg.meta.tags, "outlierScore": value}
        return msg.with_meta(dataclasses.replace(msg.meta, tags=tags))


UnitFactory = Callable[[PredictiveUnit, dict], Unit]


class UnitRegistry:
    """implementation -> factory map, extensible with user implementations."""

    def __init__(self) -> None:
        self._factories: dict[str, UnitFactory] = {}

    def register(self, impl: PredictiveUnitImplementation | str, factory: UnitFactory) -> None:
        key = impl.value if isinstance(impl, PredictiveUnitImplementation) else impl
        self._factories[key] = factory

    def create(self, spec: PredictiveUnit, context: dict) -> Unit | None:
        if spec.implementation is None:
            return None
        factory = self._factories.get(spec.implementation.value)
        if factory is None:
            return None
        return factory(spec, context)


def default_registry() -> UnitRegistry:
    """A registry holding the port's built-ins (``engine/builtin.py``),
    ``JAX_MODEL`` (the deployment JSON's name for an in-process zoo model)
    among them."""
    from seldon_core_tpu_torch.engine import builtin  # late import: avoids a cycle

    registry = UnitRegistry()
    builtin.register_builtins(registry)
    return registry
