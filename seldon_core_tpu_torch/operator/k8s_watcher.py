"""Kubernetes control plane: watch SeldonDeployment CRs on the API server
and feed the SAME reconciler the directory watcher uses.

Port of ``seldon_core_tpu/operator/k8s_watcher.py``; the status body is the
port's ``DeploymentStatus`` dumped by ``graph/spec.py::to_json``.

Parity (C12): reference cluster-manager watch loop —
- 5 s watch cadence with a resourceVersion high-water mark; events at or
  below the processed version are skipped
  (SeldonDeploymentWatcher.java:93,111-127, @Scheduled(5000):151-163);
- a "Status" kind event means the resourceVersion is too old -> reset to
  re-list from scratch (SeldonDeploymentWatcher.java:103-108);
- socket timeouts end the cycle and return the high-water mark
  (SeldonDeploymentWatcher.java:137-141);
- ADDED/MODIFIED -> createOrReplace, DELETED -> delete
  (SeldonDeploymentController processWatch:34-40);
- reconcile outcome is written back to the CR status subresource
  (KubeCRDHandlerImpl.updateSeldonDeployment:79-123 rewrites the object;
  we PATCH /status, the modern equivalent).

The ``kubernetes`` client is optional and imported lazily: construction
with no ``api`` uses the real cluster config; tests inject a fake api
object with the same two methods + stream shape (the repo environment has
no k8s client installed, so the real path is gated, never imported at
module level)."""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Iterable

from seldon_core_tpu_torch.graph.spec import to_json
from seldon_core_tpu_torch.operator.reconciler import DeploymentManager

log = logging.getLogger(__name__)

GROUP = "machinelearning.seldon.io"
VERSION = "v1alpha1"
PLURAL = "seldondeployments"


def _real_api():
    """Build a CustomObjectsApi against the cluster config (in-cluster when
    available, else local kubeconfig). Gated: only called when no fake api
    is injected. Without the ``kubernetes`` package, fall back to the
    stdlib HTTP client (operator/k8s_http.py) — serviceaccount in-cluster
    config or SELDON_TPU_K8S_API (kubectl proxy) — so k8s mode does not
    require the dependency at all."""
    try:
        import kubernetes  # type: ignore[import-not-found]
    except ImportError:
        from seldon_core_tpu_torch.operator.k8s_http import HttpK8sApi

        try:
            return HttpK8sApi.from_env()
        except RuntimeError as e:  # pragma: no cover - env dependent
            raise RuntimeError(
                "KubernetesWatcher needs the 'kubernetes' package, an "
                "in-cluster serviceaccount, SELDON_TPU_K8S_API (kubectl "
                "proxy), or an injected api object; alternatively use the "
                "directory watcher / control REST API"
            ) from e
    try:
        kubernetes.config.load_incluster_config()
    except Exception:  # noqa: BLE001 - fall back to kubeconfig
        kubernetes.config.load_kube_config()
    return kubernetes.client.CustomObjectsApi()


def _real_stream(api, namespace: str):
    """Default stream factory over kubernetes.watch.Watch. The import lives
    inside the returned fn so constructing a watcher with an injected fake
    api (tests) never touches the real client."""

    def stream(resource_version: str, timeout_seconds: int) -> Iterable[dict]:
        import kubernetes  # type: ignore[import-not-found]

        w = kubernetes.watch.Watch()
        kwargs: dict[str, Any] = {"timeout_seconds": timeout_seconds}
        if resource_version:
            kwargs["resource_version"] = resource_version
        return w.stream(
            api.list_namespaced_custom_object,
            GROUP,
            VERSION,
            namespace,
            PLURAL,
            **kwargs,
        )

    return stream


def _rv_num(rv) -> int:
    """resourceVersion as an int when parseable (the reference compares
    numerically); unparseable versions sort as 0 so they are never skipped."""
    try:
        return int(rv)
    except (TypeError, ValueError):
        return 0


class KubernetesWatcher:
    """Watch loop feeding DeploymentManager — the k8s twin of
    DirectoryWatcher; both drive the identical reconciler, so dir-mode and
    k8s-mode cannot drift."""

    def __init__(
        self,
        manager: DeploymentManager,
        *,
        namespace: str = "default",
        api: Any | None = None,
        stream_fn: Callable[[str, int], Iterable[dict]] | None = None,
    ) -> None:
        self.manager = manager
        self.namespace = namespace
        self.api = api if api is not None else _real_api()
        if stream_fn is None:
            from seldon_core_tpu_torch.operator.k8s_http import HttpK8sApi

            if isinstance(self.api, HttpK8sApi):
                # stdlib HTTP path: the api object provides its own chunked
                # watch stream (no kubernetes.watch import)
                stream_fn = self.api.watch_stream_fn(namespace)
        self._stream = stream_fn or _real_stream(self.api, namespace)
        # resourceVersion high-water mark (reference resourceVersionProcessed)
        self.resource_version_processed = 0

    # ------------------------------------------------------------- one cycle
    def watch_once(self, timeout_seconds: int = 30) -> int:
        """One list+watch cycle; returns the new high-water mark. Mirrors
        watchSeldonMLDeployments: skip already-processed versions, reset on
        stale-version Status events, swallow socket timeouts."""
        max_rv = self.resource_version_processed
        rv_arg = str(max_rv) if max_rv > 0 else ""
        try:
            for event in self._stream(rv_arg, timeout_seconds):
                obj = event.get("object") or {}
                if event.get("type") == "ERROR" or obj.get("kind") == "Status":
                    log.warning("stale resourceVersion - resetting watch")
                    self.resource_version_processed = 0
                    return 0
                rv = _rv_num((obj.get("metadata") or {}).get("resourceVersion"))
                if rv and rv <= self.resource_version_processed:
                    log.debug("already processed rv %s - skipping", rv)
                    continue
                max_rv = max(max_rv, rv)
                self._process(event.get("type", ""), obj)
        except Exception as e:  # noqa: BLE001
            if _is_timeout(e):
                return max_rv  # normal end of a watch window
            raise
        return max_rv

    def run_cycle(self, timeout_seconds: int = 30) -> None:
        rv = self.watch_once(timeout_seconds)
        if rv > self.resource_version_processed:
            self.resource_version_processed = rv

    async def run(
        self,
        interval_s: float = 5.0,
        stop_event: asyncio.Event | None = None,
        timeout_seconds: int = 30,
    ) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # reconcile (a model build) must not block the serving event loop
            try:
                await loop.run_in_executor(None, self.run_cycle, timeout_seconds)
            except Exception:  # noqa: BLE001 - watch must survive API hiccups
                log.exception("k8s watch cycle failed; retrying")
            if stop_event is not None and stop_event.is_set():
                return
            await asyncio.sleep(interval_s)

    # ------------------------------------------------------------- handlers
    def _process(self, etype: str, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name") or ""
        if etype in ("ADDED", "MODIFIED"):
            result = self.manager.apply(obj)
            if result.name:
                self._write_status(result.name)
        elif etype == "DELETED":
            if name:
                self.manager.delete(name)
        else:
            log.debug("ignoring watch event type %r for %s", etype, name)

    def _write_status(self, name: str) -> None:
        """CRD status writeback (reference SeldonDeploymentStatusUpdateImpl
        + KubeCRDHandler). Failures must not kill the watch loop."""
        st = self.manager.status(name)
        if st is None:
            return
        body = {"status": to_json(st, exclude_none=True)}
        try:
            self.api.patch_namespaced_custom_object_status(
                GROUP, VERSION, self.namespace, PLURAL, name, body
            )
        except Exception as e:  # noqa: BLE001
            log.warning("status writeback for %s failed: %s", name, e)


def _is_timeout(e: Exception) -> bool:
    import socket

    if isinstance(e, (socket.timeout, TimeoutError)):
        return True
    cause = getattr(e, "__cause__", None) or getattr(e, "__context__", None)
    return isinstance(cause, (socket.timeout, TimeoutError))


async def watch_kubernetes(
    manager: DeploymentManager,
    namespace: str = "default",
    interval_s: float = 5.0,
    stop_event: asyncio.Event | None = None,
    api: Any | None = None,
    stream_fn: Callable[[str, int], Iterable[dict]] | None = None,
) -> None:
    await KubernetesWatcher(
        manager, namespace=namespace, api=api, stream_fn=stream_fn
    ).run(interval_s, stop_event)
