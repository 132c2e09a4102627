"""Deployment defaulting — a pure spec -> spec function.

Port of ``seldon_core_tpu/graph/defaulting.py``:

- every unit with a type but no methods gets the type-implied methods;
- container-backed units without a built-in implementation get an endpoint
  wired to sequential ports from PU_PORT_BASE;
- a default mesh ({"data": n_local_devices}) and batch buckets derived
  from max_batch.

``mesh_from_spec`` is the device-count rule of
``seldon_core_tpu/parallel/mesh.py::mesh_from_spec``, which the server
applies to the mesh it is asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from seldon_core_tpu_torch.core.tensor import default_buckets
from seldon_core_tpu_torch.graph.spec import (
    BUILTIN_IMPLEMENTATIONS,
    TYPE_METHODS,
    Endpoint,
    EndpointType,
    PredictiveUnit,
    PredictiveUnitMethod,
    SeldonDeployment,
    bool_param,
)

PU_PORT_BASE = 9000
DATA_AXIS = "data"


def mesh_from_spec(axes: Mapping[str, int] | None, n_devices: int) -> dict[str, int] | None:
    """The mesh ``{axis: size}`` that ``n_devices`` can hold, or None when
    one device is asked for. A mesh larger than the devices shrinks its
    data axis (fewer replicas: serving still comes up on a smaller host);
    any other axis that needs more devices raises ValueError."""
    if not axes:
        return None
    axes = {str(k): int(v) for k, v in axes.items()}
    total = math.prod(axes.values())
    if total == 1:
        return None
    if total > n_devices:
        shrink = total // n_devices
        if DATA_AXIS in axes and axes[DATA_AXIS] % shrink == 0:
            axes[DATA_AXIS] //= shrink
            total = math.prod(axes.values())
        if total > n_devices:
            raise ValueError(f"mesh {axes} needs {total} devices, have {n_devices}")
    return axes


def _default_unit(
    unit: PredictiveUnit, container_names: set[str], port_alloc: dict[str, int]
) -> PredictiveUnit:
    update: dict = {}
    wants_finetune = any(
        p.name == "finetune" and bool_param(p.typed_value()) for p in unit.parameters
    )
    if unit.type is not None and not unit.methods:
        methods = list(TYPE_METHODS.get(unit.type, ()))
        if wants_finetune and PredictiveUnitMethod.SEND_FEEDBACK not in methods:
            methods.append(PredictiveUnitMethod.SEND_FEEDBACK)
        update["methods"] = tuple(methods)
    elif wants_finetune and PredictiveUnitMethod.SEND_FEEDBACK not in unit.methods:
        update["methods"] = tuple(unit.methods) + (PredictiveUnitMethod.SEND_FEEDBACK,)
    needs_endpoint = (
        unit.implementation not in BUILTIN_IMPLEMENTATIONS
        and unit.name in container_names
        and (unit.endpoint is None or unit.endpoint.service_port == 0)
    )
    if needs_endpoint:
        port = PU_PORT_BASE + len(port_alloc)
        port_alloc[unit.name] = port
        etype = unit.endpoint.type if unit.endpoint else EndpointType.REST
        update["endpoint"] = Endpoint(service_host="localhost", service_port=port, type=etype)
    children = tuple(_default_unit(c, container_names, port_alloc) for c in unit.children)
    if children != unit.children:
        update["children"] = children
    if not update:
        return unit
    return dataclasses.replace(unit, **update)


def default_deployment(dep: SeldonDeployment, n_devices: int | None = None) -> SeldonDeployment:
    """Return a defaulted copy; the input is never mutated."""
    if n_devices is None:
        import torch

        n_devices = max(1, torch.cuda.device_count())
    predictors = []
    for pred in dep.spec.predictors:
        container_names = {c.name for c in pred.componentSpec.containers}
        graph = _default_unit(pred.graph, container_names, {})
        tpu = pred.tpu
        tpu_update: dict = {}
        if not tpu.mesh:
            tpu_update["mesh"] = {"data": n_devices}
        if not tpu.batch_buckets:
            tpu_update["batch_buckets"] = default_buckets(tpu.max_batch)
        if tpu_update:
            tpu = dataclasses.replace(tpu, **tpu_update)
        predictors.append(dataclasses.replace(pred, graph=graph, tpu=tpu))
    spec = dataclasses.replace(dep.spec, predictors=tuple(predictors))
    return dataclasses.replace(dep, spec=spec)
