"""Deployment validation: a pure function of the spec.

Port of ``seldon_core_tpu/graph/validation.py``, every rule with its
messages word for word, over the port's dataclass spec (``graph/spec.py``):

- every non-builtin unit names an existing container, and every unit has a
  type, methods or an implementation;
- predictor names are unique and unit names unique within a graph;
- a ROUTER or a COMBINER has children;
- ``oauth_key`` and ``oauth_secret`` are set together;
- the ``tpu`` block: positive mesh sizes, ascending batch buckets, a served
  dtype, ``max_batch`` >= 1, non-negative budgets, and the generative
  tier's ``decode_*`` rules (``decode_problems``).

The port adds its own refusal by name of each ``decode_*`` knob it does not
serve (``UNPORTED_DECODE_KNOBS``, empty since tensor-parallel decode was
ported; such a knob is read from ``TpuSpec.extra``). One refusal stays where it is made: a ``tpu.mesh`` one card cannot hold
(``graph/defaulting.py::mesh_from_spec``, applied by the server).
``validate_deployment`` raises ValidationError listing every problem, not
just the first.
"""

from __future__ import annotations

from seldon_core_tpu_torch.graph.spec import (
    BUILTIN_IMPLEMENTATIONS,
    PredictiveUnit,
    PredictiveUnitImplementation,
    PredictiveUnitType,
    SeldonDeployment,
)


class ValidationError(ValueError):
    def __init__(self, problems: list[str]):
        self.problems = problems
        super().__init__("; ".join(problems))


# decode_* knobs of the JAX package the port does not serve yet, with their
# defaults there: a deployment that sets one to anything else is refused by
# name (none: every knob is served)
UNPORTED_DECODE_KNOBS: dict = {}


# TpuSpec knobs that deliberately carry NO validation rule, acknowledged
# here so the registry-drift lint (RD003, ``analysis/registry_drift.py``)
# can hold "every knob has a rule or a recorded waiver" at zero (the JAX
# package's list):
# - batch_across_requests / fuse_graph / donate_input: booleans, parsed by
#   ``spec.bool_param``;
# - decode_temperature: <= 0 means greedy by contract, any float is legal;
# - decode_top_k: <= 0 means full vocabulary by contract;
# - decode_seed: any int seeds the per-deployment RNG stream.
UNCONSTRAINED_KNOBS = (
    "batch_across_requests",
    "fuse_graph",
    "donate_input",
    "decode_temperature",
    "decode_top_k",
    "decode_seed",
)


def _validate_unit(
    unit: PredictiveUnit, container_names: set[str], seen: set[str], problems: list[str]
) -> None:
    if unit.name in seen:
        problems.append(f"duplicate unit name '{unit.name}' in graph")
    seen.add(unit.name)

    has_builtin = (
        unit.implementation is not None
        and unit.implementation != PredictiveUnitImplementation.UNKNOWN_IMPLEMENTATION
        and unit.implementation in BUILTIN_IMPLEMENTATIONS
    )
    has_endpoint = unit.endpoint is not None and unit.endpoint.service_port != 0
    if not has_builtin and not has_endpoint and unit.name not in container_names:
        problems.append(f"unit '{unit.name}' has no implementation and no matching container")
    if unit.type is None and not unit.methods and unit.implementation is None:
        problems.append(f"unit '{unit.name}' must have a type, methods, or implementation")

    if unit.type == PredictiveUnitType.COMBINER and not unit.children:
        problems.append(f"COMBINER '{unit.name}' must have children")
    if unit.type == PredictiveUnitType.ROUTER and not unit.children:
        problems.append(f"ROUTER '{unit.name}' must have children")

    for c in unit.children:
        _validate_unit(c, container_names, seen, problems)


def validate_deployment(dep: SeldonDeployment) -> None:
    problems: list[str] = []
    if not dep.spec.predictors:
        problems.append("deployment must have at least one predictor")
    names = [p.name for p in dep.spec.predictors]
    if len(set(names)) != len(names):
        problems.append("predictor names must be unique")
    if bool(dep.spec.oauth_key) != bool(dep.spec.oauth_secret):
        problems.append("oauth_key and oauth_secret must be set together")

    for pred in dep.spec.predictors:
        container_names = {c.name for c in pred.componentSpec.containers}
        _validate_unit(pred.graph, container_names, set(), problems)
        if pred.replicas < 0:
            problems.append(f"predictor '{pred.name}' replicas must be >= 0")
        problems += spec_problems(pred.name, pred.tpu)

    # wire semantics are deployment-level: predictors must agree on
    # whether binData is sniffed for npy
    toggles = {p.tpu.decode_npy_bindata for p in dep.spec.predictors}
    if len(toggles) > 1:
        problems.append(
            "all predictors must agree on tpu.decode_npy_bindata "
            "(wire-level sniffing is per-deployment, not per-predictor)"
        )

    if problems:
        raise ValidationError(problems)


def spec_problems(name: str, tpu) -> list[str]:
    """Every problem with predictor ``name``'s ``tpu`` block, in the JAX
    package's order: mesh, buckets, dtype, max_batch, budgets,
    ``weight_quant``, ``offload_compute``, then the decode tier's
    (``decode_problems``)."""
    problems = [
        f"predictor '{name}' mesh axis '{axis}' must be > 0" for axis, size in tpu.mesh.items() if size <= 0
    ]
    bb = list(tpu.batch_buckets)
    if bb and bb != sorted(bb):
        problems.append(f"predictor '{name}' batch_buckets must be ascending")
    if tpu.dtype not in ("float32", "bfloat16", "float16"):
        problems.append(f"predictor '{name}' dtype '{tpu.dtype}' unsupported")
    if tpu.max_batch < 1:
        problems.append(f"predictor '{name}' max_batch must be >= 1")
    for knob in ("batch_timeout_ms", "deadline_ms", "queue_timeout_ms"):
        if getattr(tpu, knob) < 0:
            problems.append(f"predictor '{name}' {knob} must be >= 0")
    if tpu.weight_quant not in ("", "int8"):
        problems.append(
            f"predictor '{name}' weight_quant '{tpu.weight_quant}' unsupported (want '' or 'int8')"
        )
    if tpu.offload_compute not in ("auto", "always", "never"):
        problems.append(
            f"predictor '{name}' offload_compute '{tpu.offload_compute}' must be auto|always|never"
        )
    return problems + decode_problems(name, tpu)


def decode_problems(name: str, tpu) -> list[str]:
    """Every problem with predictor ``name``'s decode_* knobs: each unported
    knob a deployment sets, then the JAX package's rules in its order."""
    problems = [
        f"predictor '{name}' sets {knob}={tpu.extra[knob]!r}: that part of the "
        "generative tier is not part of the torch port yet"
        for knob, default in UNPORTED_DECODE_KNOBS.items()
        if knob in tpu.extra and tpu.extra[knob] != default
    ]
    if tpu.decode_eos_id < -1:
        # -1 is the "no EOS" sentinel; anything below it is a typo that
        # would silently disable early retirement
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
    problems += _mesh_axes_problems(name, tpu)
    problems += _speculation_problems(name, tpu)
    problems += _fleet_problems(name, tpu)
    if tpu.decode_kv_host_bytes < 0:
        problems.append(f"predictor '{name}' decode_kv_host_bytes must be >= 0")
    if tpu.decode_kv_host_bytes > 0 and tpu.decode_prefix_slots <= 0:
        # the host tier demotes and promotes prefix entries: without the
        # prefix cache there is nothing to tier
        problems.append(
            f"predictor '{name}' decode_kv_host_bytes needs decode_prefix_slots > 0 "
            "(the host tier holds demoted prefix-cache entries)"
        )
    if tpu.decode_kv_store_tier and tpu.decode_kv_host_bytes <= 0:
        problems.append(
            f"predictor '{name}' decode_kv_store_tier needs decode_kv_host_bytes > 0 "
            "(the store is fed by the host tier's LRU)"
        )
    if tpu.decode_prefix_ctx > 0 and tpu.decode_prefix_slots == 0:
        problems.append(f"predictor '{name}' decode_prefix_ctx needs decode_prefix_slots > 0")
    if (tpu.decode_prefix_slots > 0 or tpu.decode_prefill_chunk > 0) and tpu.decode_slots <= 0:
        problems.append(
            f"predictor '{name}' decode_prefix_slots/decode_prefill_chunk need "
            "decode_slots > 0 (the continuous-batching scheduler)"
        )
    return problems


def _mesh_axes_problems(name: str, tpu) -> list[str]:
    """The JAX package's structural rules for tensor-parallel decode. The
    head/FFN divisibility rules need the model's geometry and are enforced
    at scheduler build (a hard error on direct construction,
    warn-and-disable through serving). NO device-budget check here:
    validation may run on a control-plane host whose device count says
    nothing about the data plane's (the ``tpu.mesh`` precedent)."""
    axes = dict(tpu.decode_mesh_axes or {})
    if not axes:
        return []
    problems = []
    if len(axes) != 1:
        problems.append(
            f"predictor '{name}' decode_mesh_axes must name exactly one tensor-parallel axis, got {axes}"
        )
    for axis, size in axes.items():
        if int(size) < 1:
            problems.append(f"predictor '{name}' decode_mesh_axes axis '{axis}' must be >= 1")
    if tpu.decode_slots <= 0:
        problems.append(
            f"predictor '{name}' decode_mesh_axes needs decode_slots > 0 (the continuous-batching "
            "scheduler owns the sharded decode programs)"
        )
    return problems


def _speculation_problems(name: str, tpu) -> list[str]:
    """The JAX package's rules for the speculation knobs, with its messages.
    A feature draft (``zoo://draft?features=1``) is held to the same rules:
    its chain promotes to a tree at scheduler build, under the same cap."""
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


def _fleet_problems(name: str, tpu) -> list[str]:
    """The JAX package's rules for the replicated decode fleet."""
    replicas = int(tpu.decode_replicas)
    auto = int(tpu.decode_autoscale_replicas)
    depth = int(tpu.decode_autoscale_queue_depth)
    policy = str(tpu.decode_router_policy or "")
    poll = float(tpu.decode_health_poll_ms)
    problems = []
    if replicas < 1:
        problems.append(f"predictor '{name}' decode_replicas must be >= 1")
    if auto < 0:
        problems.append(f"predictor '{name}' decode_autoscale_replicas must be >= 0")
    if depth < 0:
        problems.append(f"predictor '{name}' decode_autoscale_queue_depth must be >= 0")
    fleet_max = max(replicas, auto)
    if fleet_max > 1:
        if tpu.decode_slots <= 0:
            problems.append(
                f"predictor '{name}' decode_replicas/decode_autoscale_replicas need decode_slots > 0 (the "
                "replicated tier multiplies the continuous-batching scheduler)"
            )
        if tpu.decode_mesh_axes:
            problems.append(
                f"predictor '{name}' decode_replicas/decode_autoscale_replicas cannot combine with "
                "decode_mesh_axes yet (replica scale-out and tensor parallelism partition the same "
                "device budget)"
            )
    if 0 < auto <= replicas:
        # a cap equal to the configured fleet leaves the autoscaler nothing
        # to add: the config would be silently inert
        problems.append(
            f"predictor '{name}' decode_autoscale_replicas ({auto}) must exceed decode_replicas "
            f"({replicas}) — the autoscale cap needs headroom to scale into (and cannot shrink the "
            "configured fleet)"
        )
    if auto > replicas and depth <= 0:
        problems.append(
            f"predictor '{name}' decode_autoscale_replicas needs decode_autoscale_queue_depth > 0 "
            "(the scale-up signal)"
        )
    if depth > 0 and auto <= 0:
        problems.append(
            f"predictor '{name}' decode_autoscale_queue_depth needs decode_autoscale_replicas > 0 "
            "(nothing to scale)"
        )
    if policy not in ("", "affinity", "round_robin", "bandit"):
        problems.append(
            f"predictor '{name}' decode_router_policy '{policy}' must be affinity|round_robin|bandit "
            "(or empty for the affinity default)"
        )
    if policy and fleet_max <= 1:
        problems.append(
            f"predictor '{name}' decode_router_policy needs decode_replicas > 1 or "
            "decode_autoscale_replicas > 1 (one replica leaves nothing to route)"
        )
    if poll < 0:
        problems.append(f"predictor '{name}' decode_health_poll_ms must be >= 0")
    if int(tpu.decode_health_miss_threshold) < 1:
        problems.append(
            f"predictor '{name}' decode_health_miss_threshold must be >= 1 (zero would evict on the "
            "first poll)"
        )
    if float(tpu.decode_drain_timeout_ms) < 0:
        problems.append(f"predictor '{name}' decode_drain_timeout_ms must be >= 0")
    if poll > 0 and fleet_max <= 1:
        problems.append(
            f"predictor '{name}' decode_health_poll_ms needs decode_replicas > 1 or "
            "decode_autoscale_replicas > 1 (a single replica has no surviving arm to evict onto)"
        )
    return problems
