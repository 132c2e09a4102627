"""Predictor server: one process serves one predictor on one device, or over a mesh.

Port of ``seldon_core_tpu/serving/server.py``: parse, default and
validate the deployment (``graph/validation.py::validate_deployment``, the
JAX package's rules and the port's refusal of the knobs it does not serve,
on every path: ``load_predictor`` validates the whole deployment and
``PredictorServer`` the predictor it is given, as the JAX ``_prepare``
does), build its ``tpu.mesh`` (``parallel/mesh.py``) over the positions
its caller asked for (``mesh_devices``, a list that may repeat a device:
``[cuda:0] * 8`` serves an 8-position mesh on one card) or, where the mesh
has an axis other than "data", over the cards this process sees (a
data-only mesh stays on the server's device: ``parallel/mesh.py::
serving_positions``), under the JAX package's rule (a larger
data axis shrinks, any other axis that needs more devices is refused),
build the executor (models on the device or the mesh, pure subtrees fused)
and, for a single generative model with
``tpu.decode_slots``, its continuous-batching decode scheduler (tensor-parallel
with ``tpu.decode_mesh_axes``, over the same ``mesh_devices`` positions, or
the host's cards without them: ``parallel/tp.py``), warm every
batch bucket, serve REST through the fast ingress and, when asked, gRPC
beside it (``serving/grpc_server.py``), and on shutdown stop taking
traffic, flush the micro-batcher, drain the scheduler and give in-flight
gRPC calls ``GRACE_DRAIN_S`` (``ENGINE_DRAIN_SECONDS``, default 5) before
the ingress closes.

Two differences from the JAX server, on purpose: ``start`` serves no gRPC
unless it is given ``grpc_port`` (tests and ``chip_smoke.py`` start many
servers in one process, where a default of 5000 would collide; the CLI
keeps JAX's default from ``ENGINE_SERVER_GRPC_PORT``), and where ``grpc``
cannot be imported the CLI's default gRPC port is skipped with a warning
naming the missing module, not silently, while a gRPC port asked for
explicitly is an error.

Metrics are on by default (``metrics_enabled=False`` swaps in a registry
that records nothing): the executor's unit calls, feedback and resilience
events, the batcher, the decode scheduler and the ingress all report to
one ``metrics.registry.Metrics``, served at ``/metrics``. ``start`` runs
the event-loop lag probe and freezes the warmed-up heap out of the
garbage collector's scans (``serving/gc_policy.py``). A SHADOW router's
agreement verdicts count in ``seldon_tpu_shadow_comparisons``, and
``stop`` awaits the mirror walks still in flight.

CLI:
    python -m seldon_core_tpu_torch.serving.server --deployment dep.json \
        [--predictor NAME] [--device cuda|cpu] [--host H] [--port 8000] \
        [--grpc-port 5000] [--warmup] [--no-batch]

``--grpc-port`` defaults to ENGINE_SERVER_GRPC_PORT, else 5000; 0 turns
gRPC off.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal

from seldon_core_tpu_torch.core.tensor import resolve_device
from seldon_core_tpu_torch.engine.executor import GraphExecutor, build_executor
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import DeploymentSpec, PredictorSpec, SeldonDeployment
from seldon_core_tpu_torch.graph.validation import validate_deployment
from seldon_core_tpu_torch.metrics.registry import MetricsResilienceEvents, get_metrics, run_loop_lag_probe
from seldon_core_tpu_torch.parallel.mesh import mesh_from_spec, serving_positions
from seldon_core_tpu_torch.serving.batcher import make_batcher
from seldon_core_tpu_torch.serving.decode_scheduler import scheduler_for_executor
from seldon_core_tpu_torch.serving.fast_http import engine_routes, start_fast_server
from seldon_core_tpu_torch.serving.gc_policy import apply_serving_gc_policy
from seldon_core_tpu_torch.serving.service import PredictionService
from seldon_core_tpu_torch.utils.env import ENGINE_DRAIN_SECONDS, ENGINE_SERVER_GRPC_PORT

log = logging.getLogger(__name__)

GRACE_DRAIN_S = float(os.environ.get(ENGINE_DRAIN_SECONDS, "5"))


class PredictorServer:
    def __init__(
        self,
        predictor: PredictorSpec,
        *,
        deployment_name: str = "",
        enable_batching: bool = True,
        device=None,
        cuda_graphs: bool = True,
        metrics_enabled: bool = True,
        mesh_devices=None,
    ):
        self.predictor = predictor
        self.deployment_name = deployment_name
        self.device = resolve_device(device)
        self.metrics = get_metrics(metrics_enabled)
        # whichever way the spec came, it is held to the deployment rules,
        # then to the devices this process serves on
        validate_predictor(predictor, deployment_name)
        self.mesh = mesh_from_spec(predictor.tpu.mesh,
                                   serving_positions(predictor.tpu.mesh, self.device, mesh_devices))
        if self.mesh is not None:
            log.info("predictor %r serves over mesh %s: %d positions on %d distinct device(s)", predictor.name,
                     self.mesh.shape, self.mesh.size, self.mesh.n_devices)
        # cuda_graphs=False: every runtime and the decode scheduler run their
        # dispatch keys eagerly (the eager twins the card checks compare with)
        self.executor: GraphExecutor = build_executor(
            predictor,
            context={"device": self.device, "cuda_graphs": cuda_graphs, "mesh": self.mesh},
            resilience_events=MetricsResilienceEvents(self.metrics, deployment_name),
            unit_call_hook=lambda unit, method, dt: self.metrics.unit_call(
                deployment_name, predictor.name, unit, method, dt
            ),
            feedback_metrics_hook=lambda unit, reward: self.metrics.feedback(
                deployment_name, predictor.name, unit, reward
            ),
            shadow_compare_hook=lambda unit, agree: self.metrics.shadow_compare(
                deployment_name, predictor.name, unit, agree
            ),
        )
        # decode_mesh_axes decodes over the same positions tpu.mesh gets
        self.decode_scheduler = scheduler_for_executor(
            self.executor, predictor.tpu, metrics=self.metrics, deployment_name=deployment_name,
            mesh_devices=mesh_devices,
        )
        self.batcher = (
            make_batcher(
                predictor.tpu,
                self.executor.execute,
                execute_many=self.executor.execute_many,
                decode_scheduler=self.decode_scheduler,
                metrics=self.metrics,
                deployment_name=deployment_name,
            )
            if enable_batching
            else None
        )
        self.service = PredictionService(
            self.executor,
            deployment_name=deployment_name,
            predictor_name=predictor.name,
            batcher=self.batcher,
            decode_scheduler=self.decode_scheduler,
            deadline_ms=predictor.tpu.deadline_ms,
            metrics=self.metrics,
            decode_npy=predictor.tpu.decode_npy_bindata,
            mesh_attrs=None if self.mesh is None else self.mesh.describe(),
        )
        self.state = {"paused": False}
        self._server: asyncio.AbstractServer | None = None
        self._grpc_server = None
        self._lag_probe: asyncio.Task | None = None

    def warmup(self) -> None:
        """One forward per batch bucket of every model, and every dispatch
        shape of the decode scheduler, before traffic: on the card each is
        captured as a CUDA graph (``ops/graphs.py``) unless the server was
        built with ``cuda_graphs=False``."""
        for node in self.executor.root.walk():
            runtime = getattr(node.unit, "runtime", None)
            if runtime is not None and runtime.feature_shape is not None:
                runtime.warmup()
        if self.decode_scheduler is not None:
            self.decode_scheduler.warmup()

    async def start(self, host: str = "0.0.0.0", port: int = 8000, grpc_port: int | None = None) -> None:
        """Serve REST on ``port`` and, when ``grpc_port`` is given (0 binds a
        free one), gRPC on it; ImportError where ``grpc`` is missing."""
        if grpc_port is not None:
            from seldon_core_tpu_torch.serving.grpc_server import start_grpc_server

            self._grpc_server = await start_grpc_server(self.service, host, grpc_port, device=self.device)
        self._server = await start_fast_server(
            engine_routes(self.service, self.state), host, port
        )
        # seldon_tpu_event_loop_lag_ms: whatever stalls the loop shows here
        # before it shows as every request's tail latency
        self._lag_probe = asyncio.ensure_future(run_loop_lag_probe(self.metrics))
        apply_serving_gc_policy()

    @property
    def port(self) -> int:
        """The bound port (useful after start(port=0))."""
        return self._server.sockets[0].getsockname()[1]

    @property
    def grpc_port(self) -> int | None:
        """The bound gRPC port, or None when gRPC is not served."""
        return None if self._grpc_server is None else self._grpc_server.bound_port

    async def stop(self) -> None:
        self.state["paused"] = True  # readiness false -> load balancers drain
        if self._lag_probe is not None:
            self._lag_probe.cancel()
        if self.batcher is not None:
            await self.batcher.close()
        if self.decode_scheduler is not None:
            await self.decode_scheduler.close()
        await self.executor.drain_shadows()
        if self._grpc_server is not None:
            await self._grpc_server.stop(GRACE_DRAIN_S)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        from seldon_core_tpu_torch.engine.remote import close_remote_units

        await close_remote_units(self.executor)


def validate_predictor(predictor: PredictorSpec, deployment_name: str = "") -> None:
    """Hold one predictor to ``validate_deployment``, defaulted as the only
    predictor of its deployment (the JAX server's ``_prepare``): raises
    ValidationError listing every problem."""
    dep = SeldonDeployment(spec=DeploymentSpec(name=deployment_name or "default", predictors=(predictor,)))
    validate_deployment(default_deployment(dep, n_devices=1))


def load_predictor(path: str, predictor: str | None = None) -> tuple[PredictorSpec, str]:
    with open(path) as f:
        dep = default_deployment(SeldonDeployment.from_dict(json.load(f)))
    validate_deployment(dep)
    preds = {p.name: p for p in dep.spec.predictors}
    if not preds:
        raise ValueError(f"deployment {path} has no predictors")
    if predictor is not None and predictor not in preds:
        raise ValueError(f"predictor '{predictor}' not in {sorted(preds)}")
    return (preds[predictor] if predictor else dep.spec.predictors[0]), dep.spec.name


async def _amain(args) -> None:
    predictor, dep_name = load_predictor(args.deployment, args.predictor)
    server = PredictorServer(
        predictor,
        deployment_name=dep_name,
        enable_batching=not args.no_batch,
        device=args.device,
    )
    if args.warmup:
        server.warmup()
    explicit = args.grpc_port is not None
    grpc_port = args.grpc_port if explicit else int(os.environ.get(ENGINE_SERVER_GRPC_PORT, "5000"))
    try:
        await server.start(host=args.host, port=args.port, grpc_port=grpc_port or None)
    except ImportError as e:
        if explicit:
            raise
        # the default port on a host without grpc: REST alone, said aloud
        log.warning("gRPC not served: %s cannot be imported (%s); REST only", e.name, e)
        await server.start(host=args.host, port=args.port)
    stop_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_event.set)
    print(
        f"seldon-core-tpu-torch predictor '{predictor.name}' of deployment "
        f"'{dep_name}' serving REST :{server.port}"
        + (f" gRPC :{server.grpc_port}" if server.grpc_port is not None else "")
        + f" on {server.device}"
        + ("" if server.mesh is None else f", mesh {server.mesh.shape} over {server.mesh.size} positions on "
           f"{server.mesh.n_devices} distinct device(s)"),
        flush=True,
    )
    await stop_event.wait()
    await server.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu torch predictor server")
    parser.add_argument("--deployment", required=True, help="SeldonDeployment JSON file")
    parser.add_argument("--predictor", help="predictor name (default: first)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--grpc-port", type=int, default=None,
        help="gRPC port (default ENGINE_SERVER_GRPC_PORT, else 5000; 0 turns gRPC off)",
    )
    parser.add_argument("--no-batch", action="store_true")
    parser.add_argument("--warmup", action="store_true")
    asyncio.run(_amain(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
