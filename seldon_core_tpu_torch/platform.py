"""All-in-one platform process: control plane, gateway and engines.

Port of ``seldon_core_tpu/platform.py``. The reference splits this across
three Java services and Kubernetes (the cluster-manager operator, the
api-frontend gateway, one engine pod per predictor). On one card the
economical shape is one process: deployments are applied through the
control API (or a watched directory of CR files, or the Kubernetes API),
reconciled into in-process executors whose weights stay on the card, and
served through the OAuth gateway, with no network hop inside a graph.

The port serves every route on its own ingress (``serving/fast_http.py``):
without ``--fast-ingress`` the gateway's routes, the operator's
(``operator/api.py``) and ``POST /v1/gc-policy`` share ``--port``; with it,
``--port`` serves the gateway's data plane and ``--admin-port`` all three,
the JAX package's layout. ``--grpc-port`` serves the gateway over gRPC
(``gateway/grpc_gateway.py``, ``--grpc-mode aio|sync``). ``--hbm-budget-gb``
keeps the reference's name and budgets the card's memory. ``--device``
(default ``cuda``) raises on a host without a visible card unless it names
``cpu``.

CLI:
    python -m seldon_core_tpu_torch.platform --port 8080 --grpc-port 5000 \
        [--watch-dir deployments/ | --watch-k8s] [--apply dep.json ...] \
        [--audit-sink file://audit/] [--token-store file://tokens.jsonl] \
        [--fast-ingress --admin-port 8082] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

from seldon_core_tpu_torch.gateway import (
    DeploymentStore,
    Gateway,
    InProcessBackend,
    OAuthProvider,
    make_audit_sink,
    make_token_store,
)
from seldon_core_tpu_torch.metrics import get_metrics
from seldon_core_tpu_torch.models.base import hold_compute_pool, release_compute_pool
from seldon_core_tpu_torch.operator import DeploymentManager, operator_routes, watch_directory
from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
from seldon_core_tpu_torch.serving.wire import WireRequest, WireResponse

log = logging.getLogger(__name__)


class Platform:
    def __init__(
        self,
        *,
        token_store_url: str = "",
        audit_sink_url: str = "",
        metrics_enabled: bool = True,
        state_store_url: str = "",
        hbm_budget_bytes: int | None = None,
        allow_python_class: bool | None = None,
        device=None,
        mesh_devices=None,
    ):
        """``mesh_devices``: the positions every predictor's ``tpu.mesh`` is
        built over (a list may repeat a device); default the host's cards for
        a mesh with an axis other than "data", else ``device``."""
        self.metrics = get_metrics(metrics_enabled)
        self.oauth = OAuthProvider(token_store=make_token_store(token_store_url))
        self.store = DeploymentStore(oauth=self.oauth)
        self.backend = InProcessBackend()
        self.gateway = Gateway(
            store=self.store,
            oauth=self.oauth,
            backend=self.backend,
            audit=make_audit_sink(audit_sink_url),
            metrics=self.metrics,
        )
        self.manager = DeploymentManager(
            store=self.store,
            backend=self.backend,
            metrics=self.metrics,
            state_store_url=state_store_url,
            hbm_budget_bytes=hbm_budget_bytes,
            allow_python_class=allow_python_class,
            device=device,
            mesh_devices=mesh_devices,
        )
        self._servers: list[asyncio.AbstractServer] = []
        hold_compute_pool()  # released by stop(): its threads go with the last holder
        self._holds_pool = True
        self._grpc_server = None
        self._lag_probe: asyncio.Task | None = None
        self._watch_task: asyncio.Task | None = None

    def routes(self) -> dict:
        """Every route of the platform: the gateway's, the operator's and
        the GC re-freeze."""

        async def gc_policy(req: WireRequest) -> WireResponse:
            # the operator's re-freeze for tenants applied at runtime
            # (serving/gc_policy.py): call it in a quiet window, since a
            # freeze pins whatever request state is in flight
            from seldon_core_tpu_torch.serving.gc_policy import apply_serving_gc_policy

            return WireResponse.json({"frozen": apply_serving_gc_policy()})

        return {**gateway_routes(self.gateway), **operator_routes(self.manager), ("POST", "/v1/gc-policy"): gc_policy}

    async def serve(
        self,
        host: str = "0.0.0.0",
        port: int = 8080,
        grpc_port: int | None = 5000,
        watch_dir: str | None = None,
        watch_interval_s: float = 5.0,
        watch_k8s: bool = False,
        k8s_namespace: str = "default",
        fast_ingress: bool = False,
        admin_port: int = 8082,
        grpc_mode: str = "aio",
    ):
        """Start serving; returns (the server of the operator routes, the
        gRPC server or None, the watch task or None). Port 0 binds a free
        port (``port`` and ``admin_port`` read the bound ones back)."""
        if watch_dir and watch_k8s:
            raise ValueError("watch_dir and watch_k8s are mutually exclusive")
        if fast_ingress:
            # the data plane alone on --port; the whole table, the control
            # API with it, on the admin port (the reference engine's 8082)
            self._servers.append(await start_fast_server(gateway_routes(self.gateway), host, port))
            self._servers.append(await start_fast_server(self.routes(), host, admin_port))
            log.info("platform ingress on %s:%s, admin on %s:%s", host, self.port, host, self.admin_port)
        else:
            self._servers.append(await start_fast_server(self.routes(), host, port))
            log.info("platform REST on %s:%s", host, self.port)

        if grpc_port is not None:
            from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc

            self._grpc_server = await start_gateway_grpc(self.gateway, host=host, port=grpc_port, mode=grpc_mode)
            log.info("platform gRPC on %s:%s (%s)", host, self._grpc_server.bound_port, grpc_mode)

        # seldon_tpu_event_loop_lag_ms: one tenant's host work stalling the
        # shared loop shows here before it shows as every tenant's tail
        from seldon_core_tpu_torch.metrics.registry import run_loop_lag_probe
        from seldon_core_tpu_torch.serving.gc_policy import apply_serving_gc_policy

        self._lag_probe = asyncio.ensure_future(run_loop_lag_probe(self.metrics))
        # freeze the boot survivors out of the collector's scans
        apply_serving_gc_policy()

        if watch_dir:
            self._watch_task = asyncio.ensure_future(watch_directory(self.manager, watch_dir, watch_interval_s))
        elif watch_k8s:
            from seldon_core_tpu_torch.operator.k8s_watcher import KubernetesWatcher

            # built before the task: a missing client fails the boot loudly,
            # not a background task silently
            watcher = KubernetesWatcher(self.manager, namespace=k8s_namespace)
            self._watch_task = asyncio.ensure_future(watcher.run(interval_s=watch_interval_s))
        return self._servers[-1], self._grpc_server, self._watch_task

    @property
    def port(self) -> int:
        return self._servers[0].sockets[0].getsockname()[1]

    @property
    def admin_port(self) -> int:
        """The port of the operator routes (``port`` without fast ingress)."""
        return self._servers[-1].sockets[0].getsockname()[1]

    async def stop(self, grace_s: float = 5.0) -> None:
        """Stop the watcher, the probe, gRPC and the ingress; delete every
        deployment (their batchers drain, their state is flushed)."""
        for task in (self._watch_task, self._lag_probe):
            if task is not None:
                task.cancel()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace_s)
        for server in self._servers:
            server.close()
            await server.wait_closed()
        for name in self.manager.names():
            await asyncio.get_running_loop().run_in_executor(None, self.manager.delete, name)
        self.manager.release.close()
        if self._holds_pool:
            self._holds_pool = False
            release_compute_pool()
        self._servers, self._grpc_server, self._watch_task, self._lag_probe = [], None, None, None


async def _amain(args) -> None:
    platform = Platform(
        token_store_url=args.token_store,
        audit_sink_url=args.audit_sink,
        state_store_url=args.state_store,
        hbm_budget_bytes=int(args.hbm_budget_gb * (1 << 30)) if args.hbm_budget_gb else None,
        # None: the manager falls back to SELDON_TPU_ALLOW_PYTHON_CLASS
        allow_python_class=True if args.allow_python_class else None,
        device=args.device,
    )
    for path in args.apply or []:
        with open(path) as f:
            result = platform.manager.apply(json.load(f))
        log.info("apply %s: %s %s", path, result.action, result.message)

    await platform.serve(
        host=args.host,
        port=args.port,
        grpc_port=args.grpc_port,
        watch_dir=args.watch_dir,
        watch_k8s=args.watch_k8s,
        k8s_namespace=args.k8s_namespace,
        fast_ingress=args.fast_ingress,
        admin_port=args.admin_port,
        grpc_mode=args.grpc_mode,
    )
    print(
        f"seldon-core-tpu-torch platform serving REST :{platform.port}"
        + (f" admin :{platform.admin_port}" if args.fast_ingress else "")
        + (f" gRPC :{platform._grpc_server.bound_port}" if platform._grpc_server is not None else "")
        + f" on {platform.manager.device}",
        flush=True,
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await platform.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu torch all-in-one platform")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--grpc-port", type=int, default=5000)
    watch_group = parser.add_mutually_exclusive_group()
    watch_group.add_argument("--watch-dir", default=None)
    watch_group.add_argument(
        "--watch-k8s",
        action="store_true",
        help="watch SeldonDeployment CRs on the Kubernetes API server (the "
        "'kubernetes' package, an in-cluster serviceaccount or "
        "SELDON_TPU_K8S_API); mutually exclusive with --watch-dir",
    )
    parser.add_argument("--k8s-namespace", default="default")
    parser.add_argument("--apply", nargs="*", help="CR JSON files to apply at boot")
    parser.add_argument("--token-store", default="", help="'' | file://p | redis://h")
    parser.add_argument("--audit-sink", default="", help="'' | mem:// | file://d | kafka://h")
    parser.add_argument("--state-store", default="", help="'' | file://d | redis://h (router state)")
    parser.add_argument(
        "--hbm-budget-gb",
        type=float,
        default=0.0,
        help="refuse deployments whose parameters would pass this budget of the card's memory (0 = unlimited)",
    )
    parser.add_argument("--no-grpc", action="store_true")
    parser.add_argument(
        "--grpc-mode",
        choices=("aio", "sync"),
        default="aio",
        help="gRPC ingress: 'aio' (grpc.aio on the serving loop) or 'sync' "
        "(the C-core server, one loop bridge per call)",
    )
    parser.add_argument(
        "--fast-ingress",
        action="store_true",
        help="serve the data plane alone on --port and every route, the "
        "control API included, on --admin-port",
    )
    parser.add_argument(
        "--admin-port",
        type=int,
        default=8082,  # the reference engine's admin port
        help="the control API's port when --fast-ingress is on",
    )
    parser.add_argument(
        "--allow-python-class",
        action="store_true",
        help="let CRs mount local user classes in-process (PYTHON_CLASS): CR "
        "authors gain code execution in this process, so only enable it when "
        "every CR source is trusted",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.no_grpc:
        args.grpc_port = None
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
