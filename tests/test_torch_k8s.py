"""The port's Kubernetes watcher (``seldon_core_tpu_torch/operator/
k8s_watcher.py``) and its stdlib client (``operator/k8s_http.py``): every
case of the JAX package's ``tests/test_k8s_watcher.py`` (a fake
CustomObjectsApi: resourceVersion dedupe, the stale-version reset, socket
timeouts, status writeback) and ``tests/test_k8s_e2e.py`` (a wire-level
fake API server over real HTTP: apply, chunked watch, reconcile, predict,
status PATCH, update, delete, the 410 forms, bound-token re-reads) on the
port's manager on the CPU, plus one watch cycle through both packages'
watchers against one fake server with equal status bodies."""

import asyncio
import socket

import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from seldon_core_tpu_torch.operator import DeploymentManager, KubernetesWatcher
from seldon_core_tpu_torch.operator.k8s_http import HttpK8sApi

from tests.fake_kube_apiserver import FakeKubeApiServer


def _cr(name: str, rv: str, model: str = "iris_logistic") -> dict:
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "resourceVersion": rv},
        "spec": {
            "name": name,
            "predictors": [
                {
                    "name": "main",
                    "graph": {
                        "name": "clf",
                        "type": "MODEL",
                        "implementation": "JAX_MODEL",
                        "parameters": [
                            {"name": "model", "value": model, "type": "STRING"}
                        ],
                    },
                    "tpu": {"max_batch": 4},
                }
            ],
        },
    }


class FakeApi:
    """The two CustomObjectsApi methods the watcher touches."""

    def __init__(self):
        self.status_patches: list[tuple[str, dict]] = []
        self.fail_status = False

    def list_namespaced_custom_object(self, group, version, namespace, plural):
        return {"items": [], "metadata": {"resourceVersion": "0"}}

    def patch_namespaced_custom_object_status(
        self, group, version, namespace, plural, name, body
    ):
        if self.fail_status:
            raise RuntimeError("api server unavailable")
        self.status_patches.append((name, body))


def _watcher(events_per_cycle):
    """Watcher whose stream yields one canned event list per cycle."""
    api = FakeApi()
    cycles = iter(events_per_cycle)

    def stream(resource_version, timeout_seconds):
        return iter(next(cycles, []))

    manager = DeploymentManager(device="cpu")
    w = KubernetesWatcher(manager, api=api, stream_fn=stream)
    return w, manager, api


def test_added_event_deploys_and_writes_status():
    w, manager, api = _watcher([[{"type": "ADDED", "object": _cr("d1", "5")}]])
    w.run_cycle()
    assert w.resource_version_processed == 5
    dep = manager.get("d1")
    assert dep is not None
    assert api.status_patches and api.status_patches[-1][0] == "d1"
    body = api.status_patches[-1][1]
    assert body["status"]["state"] == "Available"


def test_resource_version_dedupe_skips_processed_events():
    applied = []
    w, manager, api = _watcher(
        [
            [{"type": "ADDED", "object": _cr("d1", "5")}],
            # replayed event at the processed version + one genuinely new
            [
                {"type": "MODIFIED", "object": _cr("d1", "5")},
                {"type": "MODIFIED", "object": _cr("d1", "9", model="iris_mlp")},
            ],
        ]
    )
    orig_apply = manager.apply
    manager.apply = lambda obj: applied.append(obj) or orig_apply(obj)
    w.run_cycle()
    w.run_cycle()
    assert w.resource_version_processed == 9
    # rv=5 replay was skipped: one apply in cycle 1, one (rv=9) in cycle 2
    assert len(applied) == 2


def test_stale_version_status_event_resets_watch():
    w, manager, api = _watcher(
        [
            [{"type": "ADDED", "object": _cr("d1", "7")}],
            [{"type": "ERROR", "object": {"kind": "Status", "code": 410}}],
        ]
    )
    w.run_cycle()
    assert w.resource_version_processed == 7
    w.run_cycle()
    assert w.resource_version_processed == 0  # re-list from scratch


def test_socket_timeout_ends_cycle_quietly():
    def stream(resource_version, timeout_seconds):
        yield {"type": "ADDED", "object": _cr("d1", "3")}
        raise socket.timeout("watch window closed")

    manager = DeploymentManager(device="cpu")
    w = KubernetesWatcher(manager, api=FakeApi(), stream_fn=stream)
    w.run_cycle()  # must not raise
    assert w.resource_version_processed == 3
    assert manager.get("d1") is not None


def test_deleted_event_removes_deployment():
    w, manager, api = _watcher(
        [
            [{"type": "ADDED", "object": _cr("d1", "2")}],
            [{"type": "DELETED", "object": _cr("d1", "4")}],
        ]
    )
    w.run_cycle()
    assert manager.get("d1") is not None
    w.run_cycle()
    assert manager.get("d1") is None


def test_invalid_cr_writes_failed_status_not_crash():
    bad = _cr("broken", "6")
    bad["spec"]["predictors"][0]["graph"] = {"name": "x", "type": "MODEL"}
    w, manager, api = _watcher([[{"type": "ADDED", "object": bad}]])
    w.run_cycle()  # reconcile fails; watch survives
    st = manager.status("broken")
    assert st is not None and st.state == "FAILED"
    assert api.status_patches[-1][1]["status"]["state"] == "FAILED"


def test_status_writeback_failure_does_not_kill_loop():
    w, manager, api = _watcher(
        [
            [{"type": "ADDED", "object": _cr("d1", "2")}],
        ]
    )
    api.fail_status = True
    w.run_cycle()  # must not raise
    assert manager.get("d1") is not None


async def test_same_reconciler_serves_dir_and_k8s_modes(tmp_path):
    """One DeploymentManager, both watch frontends: a CR applied via the
    k8s watcher serves predictions exactly like a dir-watched one."""
    import json

    from seldon_core_tpu_torch.core.codec_json import message_from_dict
    from seldon_core_tpu_torch.operator.reconciler import DirectoryWatcher

    manager = DeploymentManager(device="cpu")
    # dir mode
    (tmp_path / "a.json").write_text(json.dumps(_cr("from-dir", "1")))
    DirectoryWatcher(manager, str(tmp_path)).scan_once()
    # k8s mode on the SAME manager
    w = KubernetesWatcher(
        manager,
        api=FakeApi(),
        stream_fn=lambda rv, t: iter([{"type": "ADDED", "object": _cr("from-k8s", "2")}]),
    )
    w.run_cycle()

    for name in ("from-dir", "from-k8s"):
        out = await manager.get(name).predict(
            message_from_dict({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}})
        )
        assert np.asarray(out.array).shape == (1, 3)


def test_real_api_path_is_gated():
    with pytest.raises(RuntimeError, match="kubernetes"):
        KubernetesWatcher(DeploymentManager(device="cpu"))



def _wire_cr(name: str, model: str = "iris_logistic") -> dict:
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name},
        "spec": {
            "name": name,
            "predictors": [
                {
                    "name": "p",
                    "graph": {
                        "name": "m",
                        "type": "MODEL",
                        "implementation": "JAX_MODEL",
                        "parameters": [
                            {"name": "model", "value": model, "type": "STRING"}
                        ],
                    },
                }
            ],
        },
    }


async def _http(api: HttpK8sApi, method: str, path: str, body: dict | None = None):
    """Blocking stdlib client call off-loop (the fake API server runs ON
    this test's loop; calling urllib from the loop would deadlock)."""

    def do():
        with api._request(method, path, body=body) as r:
            return r.read()

    return await asyncio.get_running_loop().run_in_executor(None, do)


async def test_crd_apply_watch_reconcile_status_over_http():
    fake = FakeKubeApiServer()
    server = TestServer(fake.build_app())
    await server.start_server()
    loop = asyncio.get_running_loop()
    try:
        base = f"http://127.0.0.1:{server.port}"
        api = HttpK8sApi(base)
        manager = DeploymentManager(device="cpu")
        watcher = KubernetesWatcher(manager, namespace="default", api=api)

        # kubectl-create equivalent, straight at the API server
        await _http(api, "POST", api._crd_path("default"), _wire_cr("wiredep"))

        # one watch cycle in a worker thread (the real run() topology)
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert watcher.resource_version_processed == 1

        # reconciled and SERVING: predict through the reconciled deployment
        running = manager.get("wiredep")
        assert running is not None
        from seldon_core_tpu_torch.core.codec_json import message_from_dict

        out = await running.predict(
            message_from_dict({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}})
        )
        assert np.asarray(out.array).shape == (1, 3)

        # status writeback arrived AT THE SERVER over HTTP PATCH
        assert fake.status_patches, "no status PATCH reached the API server"
        name, body = fake.status_patches[-1]
        assert name == "wiredep"
        assert body["status"]["state"] == "Available"
        assert fake.objects["wiredep"]["status"]["state"] == "Available"

        # MODIFIED: update the CR (different model), watcher picks it up
        await _http(
            api, "PUT", api._crd_path("default", "wiredep"), _wire_cr("wiredep", "iris_mlp")
        )
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        probs = await manager.get("wiredep").predict(
            message_from_dict({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}})
        )
        assert np.asarray(probs.array).shape == (1, 3)

        # DELETED: the deployment is torn down
        await _http(api, "DELETE", api._crd_path("default", "wiredep"))
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert manager.get("wiredep") is None
    finally:
        await server.close()


async def test_stale_resource_version_resets_and_relists():
    """The 410/Status path (reference SeldonDeploymentWatcher.java:103-108):
    after compaction, a watch from the old high-water mark gets a Status
    event; the watcher resets to 0 and the NEXT cycle re-lists everything."""
    fake = FakeKubeApiServer()
    server = TestServer(fake.build_app())
    await server.start_server()
    loop = asyncio.get_running_loop()
    try:
        api = HttpK8sApi(f"http://127.0.0.1:{server.port}")
        manager = DeploymentManager(device="cpu")
        watcher = KubernetesWatcher(manager, namespace="default", api=api)

        await _http(api, "POST", api._crd_path("default"), _wire_cr("a"))
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert watcher.resource_version_processed == 1

        # compaction: the server forgets history; then more writes happen
        fake.compact()
        await _http(api, "POST", api._crd_path("default"), _wire_cr("b"))

        # stale watch -> Status event -> reset
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert watcher.resource_version_processed == 0

        # drop 'a' behind the watcher's back: only a genuine relist (k8s
        # "Get State and Start at Most Recent" synthetic ADDED events for
        # every current object) can bring it back — replaying post-
        # compaction history alone would not
        manager.delete("a")

        # fresh cycle relists from current state and catches up on both
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert manager.get("a") is not None, "relist did not restore pre-compaction object"
        assert manager.get("b") is not None
    finally:
        await server.close()


async def test_http_410_watch_rejection_resets_like_status_event():
    """The OTHER stale form a real apiserver uses: HTTP 410 on the watch
    request itself (no stream). The stdlib client maps it to a synthetic
    Status event so the watcher resets instead of retrying forever."""
    fake = FakeKubeApiServer()
    fake.http_410_mode = True
    server = TestServer(fake.build_app())
    await server.start_server()
    loop = asyncio.get_running_loop()
    try:
        api = HttpK8sApi(f"http://127.0.0.1:{server.port}")
        manager = DeploymentManager(device="cpu")
        watcher = KubernetesWatcher(manager, namespace="default", api=api)

        await _http(api, "POST", api._crd_path("default"), _wire_cr("a"))
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert watcher.resource_version_processed == 1

        fake.compact()
        await _http(api, "POST", api._crd_path("default"), _wire_cr("b"))
        await loop.run_in_executor(None, watcher.run_cycle, 1)  # HTTP 410
        assert watcher.resource_version_processed == 0
        await loop.run_in_executor(None, watcher.run_cycle, 1)  # relist
        assert manager.get("b") is not None
    finally:
        await server.close()


async def test_quiet_watch_window_times_out_cleanly():
    """An empty watch window ends without events or errors — the normal
    idle cycle (socket timeout / server EOF are both clean ends)."""
    fake = FakeKubeApiServer()
    server = TestServer(fake.build_app())
    await server.start_server()
    loop = asyncio.get_running_loop()
    try:
        api = HttpK8sApi(f"http://127.0.0.1:{server.port}")
        watcher = KubernetesWatcher(
            DeploymentManager(device="cpu"), namespace="default", api=api
        )
        await loop.run_in_executor(None, watcher.run_cycle, 1)
        assert watcher.resource_version_processed == 0
    finally:
        await server.close()


async def test_bound_token_reread_per_request(tmp_path):
    """In-cluster bound tokens (~1h expiry) are refreshed in place by the
    kubelet; the client must re-read the file per request or the watch
    loop 401s forever after the first hour (code-review r5)."""
    from aiohttp import web

    fake = FakeKubeApiServer()
    seen_auth: list[str] = []

    async def record_auth(request: web.Request) -> web.StreamResponse:
        seen_auth.append(request.headers.get("Authorization", ""))
        return await fake.list_or_watch(request)

    # wrap the list route to capture auth headers
    from tests.fake_kube_apiserver import BASE

    app2 = web.Application()
    app2.router.add_get(BASE, record_auth)
    server = TestServer(app2)
    await server.start_server()
    loop = asyncio.get_running_loop()
    try:
        token_file = tmp_path / "token"
        token_file.write_text("tok-v1")
        api = HttpK8sApi(
            f"http://127.0.0.1:{server.port}", token_path=str(token_file)
        )

        def list_once():
            return api.list_namespaced_custom_object(
                "machinelearning.seldon.io", "v1alpha1", "default", "seldondeployments"
            )

        await loop.run_in_executor(None, list_once)
        token_file.write_text("tok-v2")  # kubelet rotates the bound token
        await loop.run_in_executor(None, list_once)
        assert seen_auth == ["Bearer tok-v1", "Bearer tok-v2"]
    finally:
        await server.close()


def test_http_api_list_roundtrip_shape():
    """The stdlib client's list call matches the kubernetes-client method
    signature the watcher would use."""
    api = HttpK8sApi("http://example.invalid")
    # signature-compatibility only (no network): the watcher duck-types
    assert callable(api.list_namespaced_custom_object)
    assert callable(api.patch_namespaced_custom_object_status)
    fn = api.watch_stream_fn("default")
    assert callable(fn)


async def test_status_body_equals_the_jax_watchers():
    """One ADDED event through the JAX watcher and the port's, each on its
    own fake API server: the PATCHed status bodies are equal."""
    from seldon_core_tpu.operator.k8s_http import HttpK8sApi as JaxHttpK8sApi
    from seldon_core_tpu.operator.k8s_watcher import KubernetesWatcher as JaxWatcher
    from seldon_core_tpu.operator.reconciler import DeploymentManager as JaxManager

    loop = asyncio.get_running_loop()
    bodies = []
    for api_cls, watcher_cls, manager in ((HttpK8sApi, KubernetesWatcher, DeploymentManager(device="cpu")),
                                          (JaxHttpK8sApi, JaxWatcher, JaxManager())):
        fake = FakeKubeApiServer()
        server = TestServer(fake.build_app())
        await server.start_server()
        try:
            api = api_cls(f"http://127.0.0.1:{server.port}")
            watcher = watcher_cls(manager, namespace="default", api=api)
            await _http(api, "POST", api._crd_path("default"), _wire_cr("twin"))
            await loop.run_in_executor(None, watcher.run_cycle, 1)
            bodies.append(fake.status_patches[-1])
        finally:
            await server.close()
    assert bodies[0] == bodies[1]
