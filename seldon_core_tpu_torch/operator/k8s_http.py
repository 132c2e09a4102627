"""Dependency-free Kubernetes REST client for the CR watch loop.

Port of ``seldon_core_tpu/operator/k8s_http.py``, unchanged but for its
imports. The reference talks to the API server through the official Java client
(cluster-manager KubeCRDHandlerImpl / SeldonDeploymentWatcher); the Python
``kubernetes`` package is the obvious twin but is NOT a baked-in
dependency of this framework. This module speaks the three wire calls
KubernetesWatcher needs with the stdlib only:

- ``GET  .../namespaces/{ns}/seldondeployments?watch=true&resourceVersion=N
  &timeoutSeconds=T`` — a chunked stream of JSON-lines watch events
  (`{"type": "ADDED", "object": {...}}`), exactly what
  ``kubernetes.watch.Watch.stream`` yields;
- ``PATCH .../seldondeployments/{name}/status`` — the status subresource
  writeback (merge-patch);
- ``GET`` list (non-watch) for an initial resourceVersion when needed.

In-cluster auth is the plain serviceaccount contract: base URL from
``KUBERNETES_SERVICE_HOST``/``_PORT_HTTPS``, bearer token and CA from
``/var/run/secrets/kubernetes.io/serviceaccount/``. Out of cluster, point
``base_url`` at a kubectl proxy (``kubectl proxy`` serves exactly this
API unauthenticated on localhost) or any conformant emulator (the tests
run the watcher against a fake API server over real HTTP, chunked watch
stream and all).
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Iterable

from seldon_core_tpu_torch.utils.env import SELDON_TPU_K8S_API

GROUP = "machinelearning.seldon.io"
VERSION = "v1alpha1"
PLURAL = "seldondeployments"

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class HttpK8sApi:
    """Minimal CustomObjectsApi twin: just the calls the watcher makes,
    duck-typed to match the ``kubernetes`` client's method names so
    KubernetesWatcher cannot tell the difference."""

    def __init__(
        self,
        base_url: str,
        token: str = "",
        ca_file: str | None = None,
        insecure: bool = False,
        token_path: str | None = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        # in-cluster tokens are BOUND tokens (~1h expiry) that the kubelet
        # refreshes in place — re-read per request like official clients,
        # or a long-running operator 401s forever after the first hour
        self.token_path = token_path
        if self.base_url.startswith("https"):
            if insecure:
                self._ctx: ssl.SSLContext | None = ssl._create_unverified_context()
            else:
                self._ctx = ssl.create_default_context(cafile=ca_file)
        else:
            self._ctx = None

    @classmethod
    def from_env(cls) -> "HttpK8sApi":
        """In-cluster serviceaccount config, or SELDON_TPU_K8S_API (e.g.
        http://127.0.0.1:8001 from ``kubectl proxy``)."""
        url = os.environ.get(SELDON_TPU_K8S_API, "")
        if url:
            return cls(url)
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        if not host:
            raise RuntimeError(
                "no Kubernetes API configured: set SELDON_TPU_K8S_API or run "
                "in-cluster (KUBERNETES_SERVICE_HOST)"
            )
        port = os.environ.get("KUBERNETES_SERVICE_PORT_HTTPS", "443")
        token_path = os.path.join(_SA_DIR, "token")
        ca = os.path.join(_SA_DIR, "ca.crt")
        return cls(
            f"https://{host}:{port}",
            ca_file=ca if os.path.exists(ca) else None,
            token_path=token_path if os.path.exists(token_path) else None,
        )

    # ------------------------------------------------------------- plumbing
    def _request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        content_type: str = "application/json",
        timeout: float | None = 30.0,
    ):
        req = urllib.request.Request(
            self.base_url + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        if body is not None:
            req.add_header("Content-Type", content_type)
        token = self.token
        if self.token_path:
            try:
                with open(self.token_path) as f:
                    token = f.read().strip()
            except OSError:
                pass  # keep the last-known token; the request may still work
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        return urllib.request.urlopen(req, timeout=timeout, context=self._ctx)

    def _crd_path(self, namespace: str, name: str = "", sub: str = "") -> str:
        p = f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}"
        if name:
            p += f"/{name}"
        if sub:
            p += f"/{sub}"
        return p

    # ------------------------------------------------- watcher-facing calls
    def list_namespaced_custom_object(
        self, group: str, version: str, namespace: str, plural: str
    ) -> dict:
        with self._request("GET", self._crd_path(namespace)) as resp:
            return json.load(resp)

    def patch_namespaced_custom_object_status(
        self, group: str, version: str, namespace: str, plural: str,
        name: str, body: dict,
    ) -> dict:
        with self._request(
            "PATCH",
            self._crd_path(namespace, name, "status"),
            body=body,
            content_type="application/merge-patch+json",
        ) as resp:
            return json.load(resp)

    def watch_stream_fn(self, namespace: str):
        """A ``stream_fn(resource_version, timeout_seconds)`` for
        KubernetesWatcher: opens the chunked watch and yields decoded
        events. A quiet-socket timeout propagates (socket.timeout) — the
        watcher treats it as the normal end of a watch window; a server-
        closed stream simply ends the iterator."""

        def stream(resource_version: str, timeout_seconds: int) -> Iterable[dict]:
            qs = f"?watch=true&timeoutSeconds={int(timeout_seconds)}"
            if resource_version:
                qs += f"&resourceVersion={resource_version}"
            try:
                resp = self._request(
                    "GET",
                    self._crd_path(namespace) + qs,
                    # allow the server's own window plus slack before the
                    # client-side socket timeout ends the cycle
                    timeout=timeout_seconds + 5,
                )
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    # a real apiserver may reject a below-compaction-floor
                    # watch with HTTP 410 instead of a 200 stream carrying
                    # the Status event (clients handle both) — surface it
                    # as the in-stream form so the watcher resets its mark
                    return iter(
                        [
                            {
                                "type": "ERROR",
                                "object": {
                                    "kind": "Status",
                                    "code": 410,
                                    "reason": "Expired",
                                },
                            }
                        ]
                    )
                raise

            def gen():
                try:
                    for line in resp:
                        line = line.strip()
                        if line:
                            yield json.loads(line)
                finally:
                    resp.close()

            return gen()

        return stream
