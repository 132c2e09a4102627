"""Built-in graph units (no container needed).

Port of ``seldon_core_tpu/engine/builtin.py``: SIMPLE_MODEL (constant
output test stub), SIMPLE_ROUTER (always child 0), RANDOM_ABTEST (seeded
A/B split), EPSILON_GREEDY (bandit router fed by send_feedback),
MEAN_TRANSFORMER (subtracts stored means), AVERAGE_COMBINER (element-wise
mean ensemble), FAULT_INJECTOR (seeded failures and latency), SHADOW
(serve child 0, mirror the rest), OUTLIER_DETECTOR (max |z| score tags)
PYTHON_CLASS (a user's class loaded in-process) and PREFIX_AFFINITY (the
replicated decode fleet's affinity balancer as a graph ROUTER), plus
JAX_MODEL, the deployment JSON's name for an in-process zoo model. Every
built-in of the JAX package is served. Routing draws from
Python's ``random.Random`` exactly as the JAX package does, so the same
requests give the same ``meta.routing`` in both packages.

A payload here is host numpy or a torch tensor on the card: in the
single-request walk a model's output reaches its parent still on the
device. The combiner and the transformer compute on the device for tensors
and on the host for numpy, so nothing is read back mid-graph.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_host
from seldon_core_tpu_torch.engine.units import PythonClassUnit, Unit, UnitRegistry
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, PredictiveUnitImplementation, parameters_dict


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


class ShadowRouterUnit(Unit):
    """Traffic shadowing: child 0 is the primary and serves the response;
    every other child is a shadow that gets a copy of the same input,
    detached. Its latency and failures never reach the caller, but its unit
    timers tick and its answers are compared with the primary's
    (``seldon_tpu_shadow_comparisons``), so a candidate model is validated
    under production traffic before an A/B test sends it live requests.
    Routing records branch 0, so feedback replays down the primary only.
    The executor does the mirroring (``GraphExecutor._spawn_shadow``),
    keyed off ``shadow_fanout``."""

    shadow_fanout = True

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        if len(spec.children) < 2:
            raise APIException(
                ErrorCode.ENGINE_INVALID_ROUTING,
                f"SHADOW '{self.name}' needs >= 2 children "
                f"(primary + shadows), has {len(spec.children)}",
            )

    async def route(self, msg: SeldonMessage) -> int:
        return 0  # the primary; shadows are mirrored by the executor


class EpsilonGreedyRouter(Unit):
    """Multi-armed bandit router. Parameters: ``epsilon`` (exploration rate,
    default 0.1), ``seed``. Per-arm pull counts and summed rewards live on
    the host, move only through send_feedback, and pickle for a
    ``StatePersister``."""

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

    # the persistence hooks (persistence/state.py): the arms, the rng and
    # the parameters pickle; the lock is made anew
    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class PrefixAffinityRouterUnit(Unit):
    """Generative replica router: prompts that share a leading token block
    rendezvous-hash to one child, whose prefix pool is warm for them; a
    prompt with no affinity signal (shorter than one block, or no tensor)
    rides reward-driven per-child bandit arms, and a home whose observed
    queue depth runs past the bounded-load factor sheds to its second
    rendezvous rank. The policy is ``serving/affinity_router.AffinityBalancer``,
    the fleet's own. Rewards come through send_feedback (replayed down
    ``meta.routing``) and, with no client change, from the SLO verdicts the
    serving layer feeds back (``consumes_slo_feedback``); child depths come
    through ``observe_depth`` (a poll of each child's ``/decode/health``).

    Parameters: ``block`` (default 16, one KV page), ``fallback``
    ("epsilon_greedy" | "thompson"), ``epsilon``, ``load_factor`` (default
    1.25), ``seed``. The learned arms pickle (persistence/state.py)."""

    # serving/service.py feeds meta.tags.slo verdicts back as rewards to
    # graphs that hold this unit
    consumes_slo_feedback = True

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        from seldon_core_tpu_torch.serving.affinity_router import DEFAULT_AFFINITY_BLOCK, AffinityBalancer

        if not spec.children:
            raise APIException(
                ErrorCode.ENGINE_INVALID_ROUTING, f"PREFIX_AFFINITY '{spec.name}' needs children to route over"
            )
        self.block = int(self.params.get("block", DEFAULT_AFFINITY_BLOCK))
        self.balancer = AffinityBalancer(
            len(spec.children),
            policy="affinity",
            fallback=str(self.params.get("fallback", "epsilon_greedy")),
            epsilon=float(self.params.get("epsilon", 0.1)),
            load_factor=float(self.params.get("load_factor", 1.25)),
            seed=self.params.get("seed"),
        )

    def observe_depth(self, child: int, depth: int) -> None:
        """One child's polled queue depth, for the bounded-load shed."""
        self.balancer.observe_depth(child, depth)

    async def route(self, msg: SeldonMessage) -> int:
        from seldon_core_tpu_torch.serving.affinity_router import prefix_route_key

        key = ()
        if msg.array is not None:
            arr = np.atleast_2d(np.asarray(to_host(msg.array)))
            if arr.size and np.issubdtype(arr.dtype, np.number):
                # a batch routes on row 0: a ROUTER decides per request
                key = prefix_route_key(arr[0], block=self.block)
        arm, _reason = self.balancer.pick(key)
        return arm

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        self.balancer.reward(routing, feedback.reward)

    def __getstate__(self):
        return {"block": self.block, "balancer": self.balancer}

    def __setstate__(self, state):
        # restored onto a unit built for the current graph: keep its arm
        # count and copy the learned estimates of the arms that still exist
        self.block = state["block"]
        restored, bal = state["balancer"], self.balancer
        for i in range(min(bal.n_arms, restored.n_arms)):
            bal.counts[i] = restored.counts[i]
            bal.rewards[i] = restored.rewards[i]
            bal.alpha[i] = restored.alpha[i]
            bal.beta[i] = restored.beta[i]


class FaultInjectorUnit(Unit):
    """Chaos-testing transformer: fails a seeded fraction of requests
    transport-class or adds latency, so retries, breakers and fallbacks can
    be exercised without breaking a real model. Parameters: ``fail_rate``
    (0..1, default 0), ``delay_ms`` (added latency, default 0), ``seed``."""

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        self.fail_rate = float(self.params.get("fail_rate", 0.0))
        self.delay_ms = float(self.params.get("delay_ms", 0.0))
        self._rng = _seeded_rng(self.params.get("seed"))
        self._lock = threading.Lock()

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if self.delay_ms > 0:
            import asyncio

            await asyncio.sleep(self.delay_ms / 1000.0)
        with self._lock:
            fail = self._rng.random() < self.fail_rate
        if fail:
            raise APIException(
                ErrorCode.ENGINE_MICROSERVICE_ERROR,
                f"fault injected by unit '{self.name}'",
            )
        return msg


class ZScoreOutlierUnit(Unit):
    """Built-in outlier detector: scores each request by the max absolute
    z-score of its features against stored training stats and writes
    ``meta.tags.outlierScore`` (and ``outlier`` when ``threshold`` is set),
    passing the data through unchanged. Custom scorers are user classes
    with ``score()`` (``engine/units.py::OutlierDetectorUnit``).

    Parameters: ``means`` / ``stds`` (comma-separated floats, a single
    value broadcasts; default 0 / 1), ``threshold`` (optional cutoff)."""

    def __init__(self, spec: PredictiveUnit):
        super().__init__(spec)
        label = f"OUTLIER_DETECTOR '{spec.name}'"
        self.means = _parse_float_vec(label, "means", self.params.get("means", "0"))
        self.stds = _parse_float_vec(label, "stds", self.params.get("stds", "1"))
        if np.any(self.stds <= 0):
            raise ValueError(f"OUTLIER_DETECTOR '{spec.name}': stds must be positive")
        self.threshold = float(self.params["threshold"]) if "threshold" in self.params else None

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if msg.array is None:
            raise APIException(ErrorCode.ENGINE_INVALID_RESPONSE, f"unit '{self.name}' needs tensor data")
        x = to_host(msg.array).astype(np.float32, copy=False)
        for name, vec in (("means", self.means), ("stds", self.stds)):
            if vec.size not in (1, x.shape[-1]):
                raise APIException(
                    ErrorCode.ENGINE_MICROSERVICE_ERROR,
                    f"unit '{self.name}': {name} has {vec.size} values "
                    f"but input has {x.shape[-1]} features",
                )
        score = float(np.max(np.abs((x - self.means) / self.stds)))
        tags = {**msg.meta.tags, "outlierScore": score}
        if self.threshold is not None:
            tags["outlier"] = score > self.threshold
        return msg.with_meta(dataclasses.replace(msg.meta, tags=tags))


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


def make_python_class_unit(spec: PredictiveUnit, context: dict) -> PythonClassUnit:
    """PYTHON_CLASS: load a duck-typed user class in-process.

    Parameters: ``module`` (module name == class name, the reference
    wrappers/python convention), optional ``model_dir`` (the directory the
    module is imported from, isolated per directory), and every remaining
    parameter is passed to the class constructor. The CR names code that
    runs in the serving process: ``context["allow_python_class"]`` False
    refuses it (a direct ``build_executor`` caller is already code, so the
    default allows it)."""
    from seldon_core_tpu_torch.serving.microservice import load_user_object

    if not context.get("allow_python_class", True):
        raise APIException(
            ErrorCode.ENGINE_MICROSERVICE_ERROR,
            f"PYTHON_CLASS unit '{spec.name}' refused: this platform was not "
            "started with allow_python_class (start with "
            "--allow-python-class, set SELDON_TPU_ALLOW_PYTHON_CLASS=1, or "
            "DeploymentManager(allow_python_class=True) to let CRs load "
            "local code in-process)",
        )
    params = parameters_dict(spec.parameters)
    try:
        module = params.pop("module")
    except KeyError:
        raise APIException(
            ErrorCode.ENGINE_MICROSERVICE_ERROR,
            f"PYTHON_CLASS unit '{spec.name}' needs a 'module' parameter",
        ) from None
    model_dir = params.pop("model_dir", None)
    return PythonClassUnit(spec, load_user_object(str(module), model_dir, params))


def _not_ported(spec: PredictiveUnit, context: dict) -> Unit:
    raise ValueError(
        f"unit '{spec.name}': implementation {spec.implementation.value} is not "
        "part of the torch port yet"
    )


# built-ins of the JAX package the port does not serve: none
_NOT_PORTED: tuple[PredictiveUnitImplementation, ...] = ()


def register_builtins(registry: UnitRegistry) -> None:
    simple = {
        PredictiveUnitImplementation.SIMPLE_MODEL: SimpleModelUnit,
        PredictiveUnitImplementation.SIMPLE_ROUTER: SimpleRouterUnit,
        PredictiveUnitImplementation.RANDOM_ABTEST: RandomABTestUnit,
        PredictiveUnitImplementation.AVERAGE_COMBINER: AverageCombinerUnit,
        PredictiveUnitImplementation.EPSILON_GREEDY: EpsilonGreedyRouter,
        PredictiveUnitImplementation.MEAN_TRANSFORMER: MeanTransformerUnit,
        PredictiveUnitImplementation.FAULT_INJECTOR: FaultInjectorUnit,
        PredictiveUnitImplementation.OUTLIER_DETECTOR: ZScoreOutlierUnit,
        PredictiveUnitImplementation.SHADOW: ShadowRouterUnit,
        PredictiveUnitImplementation.PREFIX_AFFINITY: PrefixAffinityRouterUnit,
    }
    for impl, cls in simple.items():
        registry.register(impl, lambda spec, ctx, _cls=cls: _cls(spec))
    registry.register(PredictiveUnitImplementation.PYTHON_CLASS, make_python_class_unit)
    for impl in _NOT_PORTED:
        registry.register(impl, _not_ported)
    registry.register(PredictiveUnitImplementation.JAX_MODEL, _make_model_unit)
