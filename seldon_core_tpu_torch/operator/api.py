"""Control-plane REST API: the kubectl-equivalent surface for local mode.

Port of ``seldon_core_tpu/operator/api.py`` as a route table for the port's
ingress (``serving/fast_http.py``), in the style of ``gateway_routes``:
``operator_routes(manager)`` takes the place of the JAX package's aiohttp
``add_operator_routes``. The resource paths keep the CRD's shape (group
machinelearning.seldon.io, version v1alpha1, plural seldondeployments), so
tooling written against the CRD maps one to one:

- ``POST``/``PUT`` ``BASE`` applies a CR (200, or 400 when the reconcile
  failed), ``GET BASE`` lists, ``GET BASE/{name}`` reads one (404 when not
  running), ``DELETE BASE/{name}`` deletes (404 when not running). Apply
  and delete run on a worker thread: a build must not stall the tenants
  the loop serves;
- ``/traces``, ``/traces/{id}``, ``/decode/flight``, ``/decode/health`` and
  ``/decode/profile``: the read-outs of ``serving/wire.py``, which the
  predictor's ingress serves too;
- ``POST /profiler/start[?dir=&duration_ms=]`` and ``POST /profiler/stop``:
  a device trace of the whole process. The JAX package drives
  ``jax.profiler``; the port drives ``torch.profiler`` with CPU and CUDA
  activity and writes a Chrome trace (``trace.json``, for chrome://tracing
  or Perfetto) into ``dir``. A second start is 409, a stop without a start
  409, a bad ``duration_ms`` 400; ``duration_ms`` arms an automatic stop;
  a stop that fails keeps the state, so it can be retried.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile

from seldon_core_tpu_torch.graph.spec import to_json
from seldon_core_tpu_torch.operator.reconciler import DeploymentManager
from seldon_core_tpu_torch.serving.wire import WireRequest, WireResponse

log = logging.getLogger(__name__)

BASE = "/apis/machinelearning.seldon.io/v1alpha1/seldondeployments"
PROFILE_DIR = os.path.join(tempfile.gettempdir(), "seldon-torch-profile")


def _name(req: WireRequest) -> str:
    return req.path.rsplit("/", 1)[-1]


class _Profiler:
    """One ``torch.profiler`` session at a time, started and stopped on the
    loop, its trace exported on a worker thread."""

    def __init__(self):
        self.dir: str | None = None
        self.timer: asyncio.Task | None = None
        self.session = None
        self.stopped = False  # stopped, trace not yet written

    def start(self, out_dir: str) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        session = torch.profiler.profile(activities=activities)
        session.start()
        self.session, self.dir, self.stopped = session, out_dir, False

    def stop(self) -> None:
        """Stop once, on the thread that started the session (the loop's):
        the profiler's state is per thread."""
        if not self.stopped:
            self.session.stop()
            self.stopped = True

    def write(self) -> str:
        """Export the stopped session's Chrome trace; raises with the state
        kept on failure."""
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.session.export_chrome_trace(path)
        return path

    def clear(self) -> None:
        self.session, self.dir, self.stopped = None, None, False

    def cancel_auto_stop(self) -> None:
        timer, self.timer = self.timer, None
        if timer is not None:
            timer.cancel()


def operator_routes(manager: DeploymentManager) -> dict:
    """The control API's route table for ``serving/fast_http.py``."""
    from seldon_core_tpu_torch.serving import wire

    async def apply_dep(req: WireRequest) -> WireResponse:
        try:
            obj = json.loads(req.body)
        except Exception as e:  # noqa: BLE001 - any undecodable body
            return WireResponse.json({"error": f"invalid JSON: {e}"}, status=400)
        # a build places weights and may capture graphs: off the loop, so
        # in-flight predictions of other deployments do not stall
        result = await asyncio.get_running_loop().run_in_executor(None, manager.apply, obj)
        return WireResponse.json(
            {"name": result.name, "action": result.action, "message": result.message},
            status=400 if result.action == "failed" else 200,
        )

    async def list_deps(req: WireRequest) -> WireResponse:
        items = []
        for name in manager.names():
            st = manager.status(name)
            items.append({"name": name, "status": to_json(st) if st else None})
        return WireResponse.json({"items": items})

    async def get_dep(req: WireRequest) -> WireResponse:
        name = _name(req)
        running = manager.get(name)
        if running is None:
            return WireResponse.json({"error": "not found"}, status=404)
        st = manager.status(name)
        body = running.dep.to_dict()
        if st is not None:
            body["status"] = to_json(st)
        return WireResponse.json(body)

    async def delete_dep(req: WireRequest) -> WireResponse:
        # off the loop too: the reconcile lock may be held by an apply
        result = await asyncio.get_running_loop().run_in_executor(None, manager.delete, _name(req))
        return WireResponse.json(
            {"name": result.name, "action": result.action},
            status=404 if result.message == "not running" else 200,
        )

    prof = _Profiler()

    async def profiler_start(req: WireRequest) -> WireResponse:
        if prof.dir is not None:
            return WireResponse.json({"error": f"already tracing to {prof.dir}"}, status=409)
        out_dir = req.query_param("dir") or PROFILE_DIR
        try:
            duration_ms = float(req.query_param("duration_ms") or 0)
        except (TypeError, ValueError):
            return WireResponse.json({"error": "duration_ms must be a number"}, status=400)
        try:
            prof.start(out_dir)
        except Exception as e:  # noqa: BLE001 - the profiler's errors as JSON
            return WireResponse.json({"error": str(e)}, status=500)
        resp = {"tracing": out_dir, "dir": os.path.abspath(out_dir)}
        if duration_ms > 0:
            async def _auto_stop() -> None:
                await asyncio.sleep(duration_ms / 1e3)
                # a manual stop (or a newer start) in the window wins
                if prof.dir != out_dir:
                    return
                try:
                    prof.stop()
                    await asyncio.get_running_loop().run_in_executor(None, prof.write)
                except Exception:  # noqa: BLE001 - nothing to report it to
                    log.exception("profiler auto-stop failed")
                prof.clear()
                prof.timer = None

            prof.timer = asyncio.ensure_future(_auto_stop())
            resp["auto_stop_ms"] = duration_ms
        return WireResponse.json(resp)

    async def profiler_stop(req: WireRequest) -> WireResponse:
        if prof.dir is None:
            return WireResponse.json({"error": "not tracing"}, status=409)
        out_dir = prof.dir
        prof.cancel_auto_stop()
        try:
            prof.stop()
            path = await asyncio.get_running_loop().run_in_executor(None, prof.write)
        except Exception as e:  # noqa: BLE001
            # keep the state: a failed stop (a full disk mid-write) must stay
            # retryable, not orphan the trace behind 409s
            return WireResponse.json({"error": str(e)}, status=500)
        prof.clear()
        return WireResponse.json({"written": out_dir, "dir": os.path.abspath(out_dir), "trace": path,
                                  "view": "chrome://tracing or https://ui.perfetto.dev: " + path})

    def read_out(fn):
        async def handler(req: WireRequest) -> WireResponse:
            return fn(req)

        return handler

    routes = {
        ("POST", BASE): apply_dep,
        ("PUT", BASE): apply_dep,
        ("GET", BASE): list_deps,
        ("GET", BASE + "/*"): get_dep,
        ("DELETE", BASE + "/*"): delete_dep,
        ("GET", "/traces"): read_out(wire.traces_list),
        ("GET", "/traces/*"): read_out(wire.trace_get),
        ("GET", "/decode/flight"): read_out(wire.decode_flight),
        ("GET", "/decode/health"): read_out(wire.decode_health),
        ("GET", "/decode/profile"): read_out(wire.decode_profile),
        ("POST", "/profiler/start"): profiler_start,
        ("POST", "/profiler/stop"): profiler_stop,
    }
    return routes
