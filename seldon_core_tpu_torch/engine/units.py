"""Graph-unit interface and the implementation registry.

Port of ``seldon_core_tpu/engine/units.py`` (the ``Unit`` base,
``UnitRegistry`` and ``default_registry``). Default method semantics:
transform_input / transform_output are identity (for MODEL units
transform_input IS predict); route -1 fans out to all children; aggregate
passes a single child output through and rejects many; send_feedback does
nothing. The ``as_pure_*`` hooks let graph fusion (``engine/fused.py``)
express a unit as a pure torch function; a unit without one never fuses.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.graph.spec import (
    PredictiveUnit,
    PredictiveUnitImplementation,
    parameters_dict,
)

ROUTE_ALL = -1


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
