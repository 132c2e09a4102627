"""Deployment reconciler: the control plane's core loop.

Port of ``seldon_core_tpu/operator/reconciler.py``. Parity with the
reference cluster-manager's createOrReplaceSeldonDeployment: the FAILED
latch (a CR that failed is not retried until its spec changes), the
spec-hash cache, defaulting, validation, the build, idempotent
create-or-update, status writeback.

A CR becomes a ``RunningDeployment`` in this process: executors with their
parameters on the card, registered with the gateway, so one card serves
many deployments. Admission counts the card's memory: the incoming
deployment's parameter bytes are estimated on the host (the zoo builds its
numpy parameters, nothing touches the card) and refused before the build
when they would not fit the budget beside the resident tenants. An update
builds the new version while the old one serves, registers it, then drains
the old one's batchers and collects it: its tensors and captured graphs are
freed once the last request holding it ends, also where the serving GC
policy froze it, and the heap is frozen again once it has gone
(``_Release``; tests hold this with weak references).

The default service factory builds what ``serving/server.py::
PredictorServer`` builds (the executor on the manager's device with its
hooks, the batcher, the service, the predictor's mesh)
and, as the JAX factory, no decode scheduler: a generative deployment
applied here serves its fused ``generate``. ``RunningDeployment.warmup``
captures every runtime's graphs; ``apply`` does not call it (as in the JAX
package, the first request of a key captures it).
"""

from __future__ import annotations

import asyncio
import atexit
import gc
import hashlib
import json
import logging
import os
import random
import threading
import time
import weakref
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np

from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import (
    DeploymentStatus,
    PredictorStatus,
    SeldonDeployment,
    to_json,
)
from seldon_core_tpu_torch.graph.validation import validate_deployment
from seldon_core_tpu_torch.utils.env import SELDON_TPU_ALLOW_PYTHON_CLASS

log = logging.getLogger(__name__)


def _spec_hash(dep: SeldonDeployment) -> str:
    """sha256 of the spec's JSON with sorted keys: the JAX package's hash
    for the same CR dict (``graph/spec.py::to_json`` dumps what pydantic
    dumps)."""
    return hashlib.sha256(json.dumps(to_json(dep.spec), sort_keys=True).encode()).hexdigest()


class RunningDeployment:
    """One live deployment: a PredictionService per predictor, traffic split
    by the predictors' ``replicas`` weights."""

    def __init__(self, dep: SeldonDeployment, services: dict[str, object], seed: int = 1337, persister=None):
        self.dep = dep
        self.services = services  # predictor name -> PredictionService
        self.persister = persister
        weights = [(p.name, max(0, p.replicas)) for p in dep.spec.predictors]
        if sum(w for _, w in weights) == 0:
            weights = [(n, 1) for n, _ in weights]
        total = sum(w for _, w in weights)
        self._weights = [(n, w / total) for n, w in weights]
        self._rng = random.Random(seed)

    def _pick(self) -> object:
        r = self._rng.random()
        acc = 0.0
        for name, w in self._weights:
            acc += w
            if r <= acc:
                return self.services[name]
        return self.services[self._weights[-1][0]]

    async def predict(
        self, msg: SeldonMessage, wire_npy: bool = False, traceparent: str | None = None
    ) -> SeldonMessage:
        return await self._pick().predict(msg, wire_npy=wire_npy, traceparent=traceparent)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        # feedback follows the routing recorded in the response meta, which
        # is predictor-internal: the first predictor takes it, as the
        # reference's one Service would
        return await next(iter(self.services.values())).send_feedback(fb)

    def runtimes(self) -> list:
        """Every model runtime of every predictor."""
        return [
            unit.runtime
            for svc in self.services.values()
            for unit in svc.executor.units()
            if getattr(unit, "runtime", None) is not None
        ]

    def flush_state(self) -> None:
        """Final snapshot of stateful units."""
        if self.persister is not None:
            self.persister.stop()

    def close_batchers(self, then: Callable[[], None] | None = None) -> None:
        """Drain every predictor's batcher; ``then`` runs once every drain
        has ended (at once for a deployment without batchers)."""
        batchers = [svc.batcher for svc in self.services.values() if getattr(svc, "batcher", None) is not None]
        if then is None or not batchers:
            for batcher in batchers:
                batcher.close_nowait()
            if then is not None:
                then()
            return
        left, lock = [len(batchers)], threading.Lock()

        def drained() -> None:
            with lock:
                left[0] -= 1
                last = left[0] == 0
            if last:
                then()

        for batcher in batchers:
            batcher.close_nowait(drained)

    def warmup(self) -> None:
        """Capture every runtime's batch buckets ahead of traffic (the walk
        of ``PredictorServer.warmup``). The serving GC policy is not applied
        here: warmup can run while the loop serves other tenants, and a
        freeze would pin their in-flight state; re-freeze from a quiet
        moment with the platform's ``POST /v1/gc-policy``."""
        for runtime in self.runtimes():
            if runtime.feature_shape is not None:
                runtime.warmup()

    def close(self, then: Callable[[], None] | None = None) -> None:
        self.close_batchers(then)
        self.flush_state()


def _parts(running: RunningDeployment) -> list:
    """What of a dropped version must be gone before the heap is frozen
    again: the deployment, its services, runtimes and graph caches (a
    request still in a runtime holds it, not the deployment)."""
    parts = [running, *running.services.values()]
    for runtime in running.runtimes():
        parts.append(runtime)
        if getattr(runtime, "graphs", None) is not None:
            parts.append(runtime.graphs)
    return parts


class _Release:
    """Frees dropped versions that the serving GC policy froze.

    A dropped version is freed by the cycle collector (its runtimes, graph
    caches and executor hold one another), which never visits what the
    policy froze (``serving/gc_policy.py``: every ``start`` and ``POST
    /v1/gc-policy`` freezes what is alive). So where the policy is in force
    ``drop`` thaws the frozen generation; once the version has drained,
    ``settle`` collects it, and once every dropped version is gone it
    freezes the heap again, so the tenants left serving get back the
    policy they had (a freeze pins what is in flight at that moment, as
    the policy's own does: reference counting still frees it, a cycle
    among it stays). A version still held by a request that has not yet
    resumed is looked at again after SETTLE_DELAY_S, doubling,
    SETTLE_TRIES times; until it goes the heap stays thawed (collectable,
    at the cost of full scans)."""

    SETTLE_DELAY_S = 0.05
    SETTLE_TRIES = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._dropped: list = []  # weak references to the parts of versions not yet collected
        self._refreeze = False
        self._scheduled = False
        # what the last settles cost the serving thread: seconds of each
        # full collection, and how many times the heap was frozen again
        self.stat_collect_s: list[float] = []
        self.stat_refreezes = 0
        self._timers: list[threading.Timer] = []  # settles due from a worker thread
        _RELEASES.add(self)

    def pending(self) -> int:
        """Parts of dropped versions not yet collected."""
        with self._lock:
            return sum(1 for r in self._dropped if r() is not None)

    def drop(self, running: RunningDeployment) -> Callable[[], None]:
        """Thaw for ``running`` and return the callback to run once it has
        drained."""
        from seldon_core_tpu_torch.serving.gc_policy import policy_applied

        with self._lock:
            if policy_applied():
                gc.unfreeze()
                self._refreeze = True
            self._dropped += [weakref.ref(part) for part in _parts(running)]
        return self.settle

    def settle(self, tries: int = 0) -> None:
        t0 = time.perf_counter()
        gc.collect()
        with self._lock:
            self.stat_collect_s = self.stat_collect_s[-31:] + [time.perf_counter() - t0]
            self._dropped = [r for r in self._dropped if r() is not None]
            if not self._dropped and self._refreeze:
                self._refreeze = False
                gc.freeze()
                self.stat_refreezes += 1
            if tries > 0:
                self._scheduled = False
            if not self._dropped or self._scheduled or tries >= self.SETTLE_TRIES:
                return
            self._scheduled = True
        delay = self.SETTLE_DELAY_S * 2**tries
        try:
            asyncio.get_running_loop().call_later(delay, self.settle, tries + 1)
        except RuntimeError:  # a drain on a worker thread: no loop here
            timer = threading.Timer(delay, self.settle, (tries + 1,))
            timer.daemon = True
            with self._lock:
                self._timers = [t for t in self._timers if t.is_alive()] + [timer]
            timer.start()

    def close(self) -> None:
        """Cancel the settles still due on timer threads and join them (a
        settle in progress finishes first): the owner is going away."""
        while True:
            with self._lock:
                timers, self._timers = self._timers, []
            if not timers:
                return
            for timer in timers:  # a settle in progress may start one more
                timer.cancel()
                if timer is not threading.current_thread():
                    timer.join()


# every _Release: timers still due at exit are cancelled and joined before
# the interpreter finalises (a daemon thread killed inside gc.collect() can
# abort the process)
_RELEASES: "weakref.WeakSet[_Release]" = weakref.WeakSet()


@atexit.register
def _close_releases_at_exit() -> None:
    for release in list(_RELEASES):
        release.close()


@dataclass
class ReconcileResult:
    name: str
    action: str  # created | updated | unchanged | failed | deleted
    message: str = ""


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def deployment_param_bytes(services: dict) -> int:
    """Device bytes held by a deployment's model parameters: ``numel() *
    element_size()`` of every parameter tensor of every runtime (int8
    payloads and their float32 scales included), each tensor once: on a
    mesh a replicated leaf is held once per distinct device
    (``ModelRuntime.param_bytes``)."""
    total = 0
    for svc in services.values():
        executor = getattr(svc, "executor", None)
        if executor is None:
            continue
        for unit in executor.units():
            runtime = getattr(unit, "runtime", None)
            if runtime is not None:
                total += runtime.param_bytes()
    return total


def estimate_deployment_bytes(dep: SeldonDeployment) -> int:
    """Pre-build estimate of a deployment's parameter bytes on the card: each
    JAX_MODEL unit's parameters built on the host (the zoo's numpy
    builders; a ``file://`` checkpoint read from disk), summed at the
    predictor's serving dtype, int8 leaves by the quantization scheme's own
    formula. The JAX package's estimate, byte for byte: an over-budget
    deployment is refused before anything reaches the card."""
    from seldon_core_tpu_torch.graph.spec import PredictiveUnitImplementation, parameters_dict
    from seldon_core_tpu_torch.models import zoo

    total = 0
    for pred in dep.spec.predictors:
        dtype_factor = 0.5 if pred.tpu.dtype == "bfloat16" else 1.0
        containers = {c.name: c for c in pred.componentSpec.containers}
        for unit in pred.graph.walk():
            uri = None
            if unit.implementation == PredictiveUnitImplementation.JAX_MODEL:
                params = parameters_dict(unit.parameters)
                uri = params.get("model_uri") or (f"zoo://{params['model']}" if "model" in params else None)
            if uri is None:
                c = containers.get(unit.name)
                uri = getattr(c, "model_uri", "") or None
            if not uri:
                continue
            try:
                if uri.startswith("zoo://"):
                    name, kwargs = zoo._parse_zoo_uri(uri)
                    ms = zoo.get_model(name, **kwargs)
                elif uri.startswith("file://"):
                    from seldon_core_tpu_torch.persistence.checkpoint import restore_model

                    ms = restore_model(uri[len("file://"):])
                else:
                    continue
            except Exception:  # noqa: BLE001 - the real build surfaces it
                continue
            if getattr(pred.tpu, "weight_quant", "") == "int8":
                # the scheme's own residency formula: admission must see the
                # int8 footprint, or a quantized deployment that fits is refused
                from seldon_core_tpu_torch.models.quant import quantized_nbytes

                def leaf_bytes(leaf) -> float:
                    return quantized_nbytes(leaf, nonquant_factor=dtype_factor)

            else:

                def leaf_bytes(leaf) -> float:
                    return np.asarray(leaf).nbytes * dtype_factor

            total += int(sum(leaf_bytes(leaf) for leaf in _leaves(ms.params)))
    return total


class DeploymentManager:
    """Reconciles SeldonDeployment resources into running state.

    ``store`` (the gateway's DeploymentStore) and ``backend`` (its
    InProcessBackend) make applied deployments routable through the
    gateway. ``device`` is where the default factory builds (default: the
    card, raising when none is visible). A predictor's ``tpu.mesh`` is
    built over ``mesh_devices`` (positions; a list may repeat a device) or,
    without it, over the cards of the host where it has an axis other than
    "data" (``parallel/mesh.py::serving_positions``), under the JAX
    package's device-count rule."""

    def __init__(
        self,
        store=None,
        backend=None,
        metrics=None,
        service_factory: Optional[Callable] = None,
        state_store_url: str = "",
        state_period_s: float = 60.0,
        hbm_budget_bytes: int | None = None,
        allow_python_class: bool | None = None,
        device=None,
        mesh_devices=None,
    ):
        from seldon_core_tpu_torch.core.tensor import resolve_device

        self.mesh_devices = None if mesh_devices is None else list(mesh_devices)
        self.store = store
        self.backend = backend
        self.metrics = metrics
        self.device = resolve_device(device)
        self._service_factory = service_factory or self._default_service_factory
        self.state_store_url = state_store_url
        self.state_period_s = state_period_s
        # PYTHON_CLASS units run code named by the CR in this process, and
        # CRs arrive declaratively (directory, control API, Kubernetes) from
        # actors who may hold only CR rights: opt-in here, default from
        # SELDON_TPU_ALLOW_PYTHON_CLASS
        if allow_python_class is None:
            allow_python_class = os.environ.get(SELDON_TPU_ALLOW_PYTHON_CLASS, "").strip().lower() in (
                "1", "true", "yes")
        self.allow_python_class = allow_python_class
        # None: unlimited; else the card's bytes the tenants' parameters may
        # hold, so a deployment that would not fit is refused instead of
        # running every tenant out of memory
        self.hbm_budget_bytes = hbm_budget_bytes
        self._hbm_bytes: dict[str, int] = {}
        self._cache: dict[str, str] = {}  # name -> spec hash
        self._failed: dict[str, str] = {}  # FAILED latch: name -> failed spec hash
        self._running: dict[str, RunningDeployment] = {}
        self._status: dict[str, DeploymentStatus] = {}
        # apply and delete run on worker threads (control API, watchers); one
        # lock serializes reconciliation, or a concurrent double apply would
        # build twice and leak the losing version
        self._reconcile_lock = threading.RLock()
        self.release = _Release()

    # ------------------------------------------------------------ factories
    def _default_service_factory(self, dep: SeldonDeployment, predictor):
        from seldon_core_tpu_torch.engine.executor import build_executor
        from seldon_core_tpu_torch.metrics.registry import MetricsResilienceEvents
        from seldon_core_tpu_torch.parallel.mesh import mesh_from_spec, serving_positions
        from seldon_core_tpu_torch.serving.batcher import make_batcher
        from seldon_core_tpu_torch.serving.service import PredictionService

        dep_name = dep.spec.name or dep.metadata.name
        metrics = self.metrics
        unit_call_hook = feedback_hook = shadow_hook = None
        if metrics is not None:
            def unit_call_hook(unit_name, method, duration_s):  # noqa: E306
                metrics.unit_call(dep_name, predictor.name, unit_name, method, duration_s)

            def feedback_hook(unit_name, reward):  # noqa: E306
                metrics.feedback(dep_name, predictor.name, unit_name, reward)

            def shadow_hook(shadow_unit, agree):  # noqa: E306
                metrics.shadow_compare(dep_name, predictor.name, shadow_unit, agree)

        # the CR's tpu.mesh over the positions asked for, or the cards where it
        # shards (a data-only mesh stays on self.device): a larger data axis
        # shrinks, another axis that needs more is refused
        mesh = mesh_from_spec(predictor.tpu.mesh,
                              serving_positions(predictor.tpu.mesh, self.device, self.mesh_devices))
        if mesh is not None:
            log.info("deployment %s predictor %r serves over mesh %s: %d positions on %d distinct device(s)",
                     dep_name, predictor.name, mesh.shape, mesh.size, mesh.n_devices)
        executor = build_executor(
            predictor,
            context={
                "allow_python_class": self.allow_python_class,
                "device": self.device,
                "mesh": mesh,
            },
            feedback_metrics_hook=feedback_hook,
            unit_call_hook=unit_call_hook,
            shadow_compare_hook=shadow_hook,
            resilience_events=None if metrics is None else MetricsResilienceEvents(metrics, dep_name),
        )
        batcher = make_batcher(
            predictor.tpu,
            executor.execute,
            execute_many=executor.execute_many,
            metrics=metrics,
            deployment_name=dep_name,
        )
        return PredictionService(
            executor,
            deployment_name=dep_name,
            predictor_name=predictor.name,
            batcher=batcher,
            metrics=metrics,
            decode_npy=predictor.tpu.decode_npy_bindata,
            deadline_ms=predictor.tpu.deadline_ms,
            mesh_attrs=None if mesh is None else mesh.describe(),
        )

    def _make_persister(self, name: str, services: dict):
        """Restore at build and periodic snapshots for stateful units."""
        if not self.state_store_url:
            return None
        from seldon_core_tpu_torch.persistence.state import StatePersister, make_state_store

        store = make_state_store(self.state_store_url)
        if store is None:
            return None
        persister = StatePersister(store, name, period_s=self.state_period_s)
        single = len(services) == 1
        for pred_name, svc in services.items():
            executor = getattr(svc, "executor", None)
            if executor is not None:
                # namespaced by predictor, so same-named units of two
                # predictors (canary, A/B) never share a store key; a single
                # predictor keeps the reference's key
                persister.attach(executor.units(), prefix="" if single else pred_name)
        persister.start()
        return persister

    # ------------------------------------------------------------ reconcile
    def apply(self, dep: SeldonDeployment | dict) -> ReconcileResult:
        if isinstance(dep, dict):
            name_hint = str((dep.get("metadata") or {}).get("name") or (dep.get("spec") or {}).get("name") or "")
            try:
                dep = SeldonDeployment.from_dict(dep)
            except Exception as e:  # noqa: BLE001 - structurally invalid CR
                log.warning("deployment %s failed schema validation: %s", name_hint, e)
                if name_hint:
                    self._status[name_hint] = DeploymentStatus(state="FAILED", description=str(e))
                return ReconcileResult(name_hint, "failed", str(e))
        name = dep.metadata.name or dep.spec.name
        if not name:
            return ReconcileResult("", "failed", "deployment has no name")
        with self._reconcile_lock:
            return self._apply_locked(dep, name)

    def _apply_locked(self, dep: SeldonDeployment, name: str) -> ReconcileResult:
        h = _spec_hash(dep)

        # FAILED latch: a spec that failed is not reconciled again; a changed
        # spec clears the latch
        if self._failed.get(name) == h:
            return ReconcileResult(name, "failed", "previously failed; spec unchanged")
        if self._cache.get(name) == h:
            # the running version is the desired one; repair the status a
            # rejected update may have written
            if name in self._running:
                self._write_available_status(name, self._running[name].dep)
            return ReconcileResult(name, "unchanged")

        try:
            dep = default_deployment(dep)
            validate_deployment(dep)
        except Exception as e:  # noqa: BLE001 - an invalid spec latches FAILED
            self._failed[name] = h
            self._write_rejected_status(name, str(e))
            log.warning("deployment %s failed reconcile: %s", name, e)
            return ReconcileResult(name, "failed", str(e))

        # admission before the build: the estimate is host-side only, so an
        # over-budget model never touches the card. During an update both
        # versions are resident for a moment, so the deployment's own bytes
        # are not excluded: the swap needs the headroom
        if self.hbm_budget_bytes is not None:
            incoming = estimate_deployment_bytes(dep)
            resident = sum(self._hbm_bytes.values())
            if resident + incoming > self.hbm_budget_bytes:
                # no FAILED latch: a resource condition, not a spec defect;
                # once a tenant is deleted the same spec reconciles
                msg = (
                    f"insufficient HBM: deployment needs {incoming} B "
                    f"(swap headroom included), "
                    f"{self.hbm_budget_bytes - resident} B free of "
                    f"{self.hbm_budget_bytes} B budget"
                )
                self._write_rejected_status(name, msg)
                log.warning("deployment %s rejected: %s", name, msg)
                return ReconcileResult(name, "failed", msg)

        try:
            services = {p.name: self._service_factory(dep, p) for p in dep.spec.predictors}
        except Exception as e:  # noqa: BLE001 - unit or model build failure
            self._failed[name] = h
            self._write_rejected_status(name, str(e))
            log.warning("deployment %s failed reconcile: %s", name, e)
            return ReconcileResult(name, "failed", str(e))

        existed = name in self._running
        old = self._running.pop(name, None)
        if old is not None:
            # flush the old version's learned state before the new persister
            # restores from the store, but keep its batchers serving until
            # the new version is registered, so the swap drops nothing
            old.flush_state()
        persister = self._make_persister(name, services)
        self._running[name] = RunningDeployment(dep, services, persister=persister)
        self._hbm_bytes[name] = deployment_param_bytes(services)
        self._failed.pop(name, None)
        self._cache[name] = h

        # register with the gateway (store: oauth_key routing; backend: the
        # in-process engine)
        if self.store is not None:
            self.store.deployment_added(replace(dep.spec, name=dep.spec.name or name))
        if self.backend is not None:
            self.backend.register(dep.spec.name or name, self._running[name])
        if old is not None:
            # the new version is routable: drain the old, then collect it
            old.close_batchers(self.release.drop(old))

        self._write_available_status(name, dep)
        return ReconcileResult(name, "updated" if existed else "created")

    def _write_rejected_status(self, name: str, reason: str) -> None:
        """A failed reconcile: a running previous version keeps serving
        (state Available, the rejection in the description); otherwise the
        deployment is FAILED."""
        if name in self._running:
            st = self._write_available_status(name, self._running[name].dep)
            self._status[name] = replace(st, description=f"update rejected: {reason}")
        else:
            self._status[name] = DeploymentStatus(state="FAILED", description=reason)

    def _write_available_status(self, name: str, dep: SeldonDeployment) -> DeploymentStatus:
        st = DeploymentStatus(
            state="Available",
            predictorStatus=tuple(
                PredictorStatus(name=f"{name}-{p.name}", replicas=p.replicas, replicasAvailable=p.replicas)
                for p in dep.spec.predictors
            ),
        )
        self._status[name] = st
        return st

    def delete(self, name: str) -> ReconcileResult:
        with self._reconcile_lock:
            return self._delete_locked(name)

    def _delete_locked(self, name: str) -> ReconcileResult:
        running = self._running.pop(name, None)
        self._cache.pop(name, None)
        self._failed.pop(name, None)
        self._status.pop(name, None)
        self._hbm_bytes.pop(name, None)
        if running is None:
            return ReconcileResult(name, "unchanged", "not running")
        if self.backend is not None:
            self.backend.unregister(running.dep.spec.name or name)
        if self.store is not None:
            self.store.deployment_removed(running.dep.spec.name or name)
        running.close(self.release.drop(running))
        return ReconcileResult(name, "deleted")

    # ------------------------------------------------------------ queries
    def status(self, name: str) -> DeploymentStatus | None:
        return self._status.get(name)

    def hbm_usage(self) -> dict:
        """Resident parameter bytes: {"deployments": {name: bytes},
        "total": int, "budget": int | None}."""
        return {
            "deployments": dict(self._hbm_bytes),
            "total": sum(self._hbm_bytes.values()),
            "budget": self.hbm_budget_bytes,
        }

    def names(self) -> list[str]:
        return sorted(self._running)

    def get(self, name: str) -> RunningDeployment | None:
        return self._running.get(name)


class DirectoryWatcher:
    """Reconcile from a directory of CR JSON files: dropping, rewriting or
    removing a file is kubectl apply or delete. Only deployments this
    watcher applied are deleted when their file disappears; a file that
    cannot be read or parsed (a torn write) keeps its deployment."""

    def __init__(self, manager: DeploymentManager, directory: str):
        self.manager = manager
        self.directory = directory
        self._seen: dict[str, str] = {}  # file name -> deployment name

    def scan_once(self) -> None:
        try:
            files = {
                f: os.path.join(self.directory, f) for f in sorted(os.listdir(self.directory)) if f.endswith(".json")
            }
        except FileNotFoundError:
            files = {}
        current: dict[str, str] = {}
        for fname, path in files.items():
            try:
                with open(path) as fh:
                    obj = json.load(fh)
                result = self.manager.apply(obj)
                if result.name:
                    current[fname] = result.name
            except (json.JSONDecodeError, OSError) as e:
                log.warning("skipping %s: %s", path, e)
                # a torn read keeps the previous mapping: only a file's true
                # disappearance deletes its deployment
                if fname in self._seen:
                    current[fname] = self._seen[fname]
        for fname, name in self._seen.items():
            if fname not in current:
                self.manager.delete(name)
        self._seen = current

    async def run(self, interval_s: float = 5.0, stop_event: asyncio.Event | None = None) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # a build inside apply() must not block the serving loop
            await loop.run_in_executor(None, self.scan_once)
            if stop_event is not None and stop_event.is_set():
                return
            await asyncio.sleep(interval_s)


async def watch_directory(
    manager: DeploymentManager,
    directory: str,
    interval_s: float = 5.0,
    stop_event: asyncio.Event | None = None,
) -> None:
    await DirectoryWatcher(manager, directory).run(interval_s, stop_event)
