"""Predictor server: one process serves one predictor on one device.

Port of ``seldon_core_tpu/serving/server.py``: parse and default the
deployment, hold its ``tpu.mesh`` to the one device this process serves
(a larger data axis shrinks, any other axis that needs more devices is
refused, as the JAX package's mesh rule does), hold the ``tpu`` block to
the JAX package's rules and refuse the knobs the port does not serve
(``graph/defaulting.py::spec_problems``), build the executor (models on the device, pure
subtrees fused) and, for a single generative model with
``tpu.decode_slots``, its continuous-batching decode scheduler, warm every
batch bucket, serve REST through the fast ingress, and on shutdown stop
taking traffic, flush the micro-batcher and drain the scheduler.

CLI:
    python -m seldon_core_tpu_torch.serving.server --deployment dep.json \
        [--predictor NAME] [--device cuda|cpu] [--host H] [--port 8000] \
        [--warmup] [--no-batch]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from seldon_core_tpu_torch.core.tensor import resolve_device
from seldon_core_tpu_torch.engine.executor import GraphExecutor, build_executor
from seldon_core_tpu_torch.graph.defaulting import default_deployment, mesh_from_spec, spec_problems
from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeployment
from seldon_core_tpu_torch.serving.batcher import make_batcher
from seldon_core_tpu_torch.serving.decode_scheduler import scheduler_for_executor
from seldon_core_tpu_torch.serving.fast_http import engine_routes, start_fast_server
from seldon_core_tpu_torch.serving.service import PredictionService


class PredictorServer:
    def __init__(
        self,
        predictor: PredictorSpec,
        *,
        deployment_name: str = "",
        enable_batching: bool = True,
        device=None,
        cuda_graphs: bool = True,
    ):
        self.predictor = predictor
        self.deployment_name = deployment_name
        self.device = resolve_device(device)
        mesh_from_spec(predictor.tpu.mesh, n_devices=1)  # one process serves one device
        problems = spec_problems(predictor.name, predictor.tpu)
        if problems:
            raise ValueError("; ".join(problems))
        # cuda_graphs=False: every runtime and the decode scheduler run their
        # dispatch keys eagerly (the eager twins the card checks compare with)
        self.executor: GraphExecutor = build_executor(
            predictor, context={"device": self.device, "cuda_graphs": cuda_graphs}
        )
        self.decode_scheduler = scheduler_for_executor(self.executor, predictor.tpu)
        self.batcher = (
            make_batcher(
                predictor.tpu,
                self.executor.execute,
                execute_many=self.executor.execute_many,
                decode_scheduler=self.decode_scheduler,
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
        )
        self.state = {"paused": False}
        self._server: asyncio.AbstractServer | None = None

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

    async def start(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        self._server = await start_fast_server(
            engine_routes(self.service, self.state), host, port
        )

    @property
    def port(self) -> int:
        """The bound port (useful after start(port=0))."""
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self.state["paused"] = True  # readiness false -> load balancers drain
        if self.batcher is not None:
            await self.batcher.close()
        if self.decode_scheduler is not None:
            await self.decode_scheduler.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


def load_predictor(path: str, predictor: str | None = None) -> tuple[PredictorSpec, str]:
    with open(path) as f:
        dep = default_deployment(SeldonDeployment.from_dict(json.load(f)))
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
    await server.start(host=args.host, port=args.port)
    stop_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_event.set)
    print(
        f"seldon-core-tpu-torch predictor '{predictor.name}' of deployment "
        f"'{dep_name}' serving REST :{server.port} on {server.device}",
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
    parser.add_argument("--no-batch", action="store_true")
    parser.add_argument("--warmup", action="store_true")
    asyncio.run(_amain(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
