"""Deployment defaulting — a pure spec -> spec function.

Port of ``seldon_core_tpu/graph/defaulting.py``:

- every unit with a type but no methods gets the type-implied methods;
- container-backed units without a built-in implementation get an endpoint
  wired to sequential ports from PU_PORT_BASE;
- a default mesh ({"data": n_local_devices}) and batch buckets derived
  from max_batch.

``mesh_from_spec`` is the device-count rule of
``seldon_core_tpu/parallel/mesh.py::mesh_from_spec``, which the server
applies to the mesh it is asked for. ``spec_problems`` holds a
predictor's ``tpu`` block to the JAX package's validation rules
(``seldon_core_tpu/graph/validation.py``): ``weight_quant`` and the deadline
here, the generative tier's ``decode_*`` knobs in ``decode_problems``, which
names every knob of that tier the port does not serve yet. A generative
model with ``weight_quant`` is refused by name where the model is built
(``models/zoo.py``): only the build knows the model decodes.
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


# decode_* knobs of the JAX package the port does not serve yet, with their
# defaults there: a deployment that sets one to anything else is refused by
# name, as engine/builtin.py refuses an unported built-in (the speculation
# and SLO knobs are served and held to the JAX package's rules below)
UNPORTED_DECODE_KNOBS = {
    "decode_kv_host_bytes": 0,
    "decode_kv_store_tier": "",
    "decode_mesh_axes": {},
    "decode_replicas": 1,
    "decode_router_policy": "",
    "decode_autoscale_replicas": 0,
    "decode_autoscale_queue_depth": 0,
    "decode_health_poll_ms": 0.0,
    "decode_health_miss_threshold": 3,
    "decode_drain_timeout_ms": 5000.0,
    "decode_npy_bindata": True,
}


def spec_problems(name: str, tpu) -> list[str]:
    """Every problem with predictor ``name``'s ``tpu`` block: the JAX
    package's rules for ``weight_quant`` and the budgets, then the decode
    tier's (``decode_problems``)."""
    problems = [
        f"predictor '{name}' {knob} must be >= 0"
        for knob in ("batch_timeout_ms", "deadline_ms", "queue_timeout_ms")
        if getattr(tpu, knob) < 0
    ]
    if tpu.weight_quant not in ("", "int8"):
        problems.append(
            f"predictor '{name}' weight_quant '{tpu.weight_quant}' unsupported (want '' or 'int8')"
        )
    return problems + decode_problems(name, tpu)


def decode_problems(name: str, tpu) -> list[str]:
    """Every problem with predictor ``name``'s decode_* knobs: the JAX
    package's validation rules for the knobs the port serves, and each
    unported knob a deployment sets."""
    problems = [
        f"predictor '{name}' sets {knob}={tpu.extra[knob]!r}: that part of the "
        "generative tier is not part of the torch port yet"
        for knob, default in UNPORTED_DECODE_KNOBS.items()
        if knob in tpu.extra and tpu.extra[knob] != default
    ]
    if tpu.decode_eos_id < -1:
        problems.append(f"predictor '{name}' decode_eos_id must be >= -1")
    for knob in ("decode_prefix_slots", "decode_prefix_ctx", "decode_prefill_chunk",
                 "decode_kv_page_size", "decode_kv_pages", "decode_slo_ttft_ms", "decode_slo_itl_ms"):
        if getattr(tpu, knob) < 0:
            problems.append(f"predictor '{name}' {knob} must be >= 0")
    if (tpu.decode_slo_ttft_ms > 0 or tpu.decode_slo_itl_ms > 0) and tpu.decode_slots <= 0:
        problems.append(
            f"predictor '{name}' decode_slo_ttft_ms/decode_slo_itl_ms need decode_slots > 0 "
            "(the SLO attainment telemetry lives in the decode scheduler)"
        )
    if tpu.decode_kv_dtype not in ("", "int8"):
        problems.append(
            f"predictor '{name}' decode_kv_dtype '{tpu.decode_kv_dtype}' unsupported (want '' or 'int8')"
        )
    if (tpu.decode_kv_page_size > 0 or tpu.decode_kv_pages > 0 or tpu.decode_kv_dtype) and tpu.decode_slots <= 0:
        problems.append(
            f"predictor '{name}' decode_kv_page_size/decode_kv_pages/decode_kv_dtype "
            "need decode_slots > 0 (the continuous-batching scheduler)"
        )
    if (
        tpu.decode_kv_page_size > 0
        and tpu.decode_prefill_chunk > 0
        and tpu.decode_prefill_chunk % tpu.decode_kv_page_size != 0
    ):
        # every chunk boundary on a page boundary: chunked prefill never
        # copy-on-writes its own half-written page
        problems.append(
            f"predictor '{name}' decode_prefill_chunk ({tpu.decode_prefill_chunk}) "
            f"must be a multiple of decode_kv_page_size ({tpu.decode_kv_page_size})"
        )
    if 0 < tpu.decode_kv_pages < tpu.decode_slots + 1:
        problems.append(
            f"predictor '{name}' decode_kv_pages ({tpu.decode_kv_pages}) is below "
            f"decode_slots + 1 ({tpu.decode_slots + 1}) — the page budget cannot "
            "host the configured concurrency"
        )
    if tpu.decode_prefix_ctx > 0 and tpu.decode_prefix_slots == 0:
        problems.append(f"predictor '{name}' decode_prefix_ctx needs decode_prefix_slots > 0")
    if (tpu.decode_prefix_slots > 0 or tpu.decode_prefill_chunk > 0) and tpu.decode_slots <= 0:
        problems.append(
            f"predictor '{name}' decode_prefix_slots/decode_prefill_chunk need "
            "decode_slots > 0 (the continuous-batching scheduler)"
        )
    return problems + _speculation_problems(name, tpu)


def _speculation_problems(name: str, tpu) -> list[str]:
    """The JAX package's rules for the speculation knobs
    (``seldon_core_tpu/graph/validation.py``), with its messages."""
    from seldon_core_tpu_torch.models.spec_tree import MAX_TREE_NODES, SpecTree

    problems = []
    if tpu.decode_spec_k < 0:
        problems.append(f"predictor '{name}' decode_spec_k must be >= 0")
    if tpu.decode_spec_k > 0 or tpu.decode_spec_tree:
        if tpu.decode_slots <= 0:
            problems.append(
                f"predictor '{name}' decode_spec_k/decode_spec_tree "
                "need decode_slots > 0 (the continuous-batching scheduler)"
            )
        if not tpu.decode_draft_model:
            problems.append(
                f"predictor '{name}' decode_spec_k/decode_spec_tree "
                "need decode_draft_model (the draft that proposes)"
            )
    if tpu.decode_spec_tree:
        # the tree must parse and fit the widened verify's node cap
        try:
            tree = SpecTree.from_text(tpu.decode_spec_tree)
        except ValueError as e:
            problems.append(f"predictor '{name}' decode_spec_tree: {e}")
        else:
            if tree.n_tree > MAX_TREE_NODES:
                problems.append(
                    f"predictor '{name}' decode_spec_tree "
                    f"'{tpu.decode_spec_tree}' flattens to "
                    f"{tree.n_tree} nodes — the widened verify dispatch "
                    f"caps at {MAX_TREE_NODES}"
                )
    elif tpu.decode_spec_k > MAX_TREE_NODES:
        problems.append(
            f"predictor '{name}' decode_spec_k "
            f"({tpu.decode_spec_k}) exceeds the widened-verify "
            f"headroom ({MAX_TREE_NODES} proposed tokens per dispatch)"
        )
    if not (0.0 <= tpu.decode_spec_accept_floor < 1.0):
        problems.append(
            f"predictor '{name}' decode_spec_accept_floor "
            f"({tpu.decode_spec_accept_floor}) must be in [0, 1)"
        )
    if tpu.decode_spec_accept_floor > 0 and not (tpu.decode_spec_k > 0 or tpu.decode_spec_tree):
        problems.append(
            f"predictor '{name}' decode_spec_accept_floor needs "
            "decode_spec_k > 0 or decode_spec_tree (nothing to adapt)"
        )
    return problems


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
