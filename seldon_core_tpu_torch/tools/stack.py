"""The gated serving stack, built one way.

Port of ``seldon_core_tpu/tools/stack.py``: tools and ``chip_smoke.py``
boot the stack a user boots (a warmed PredictorServer behind the OAuth
gateway with the in-process backend, the serving GC policy applied)
through this one function, so a measurement cannot drift from what
serves.
"""

from __future__ import annotations


def build_gateway_stack(
    predictor,
    *,
    deployment_name: str = "bench",
    oauth_key: str = "bench-key",
    oauth_secret: str = "bench-secret",
    audit=None,
    device=None,
    mesh_devices=None,
):
    """Returns (server, gw, oauth, token): a warmed PredictorServer on
    ``device`` (the card by default; a mesh, ``tpu.mesh`` or
    ``tpu.decode_mesh_axes``, over ``mesh_devices`` when given) registered
    behind a Gateway under
    ``deployment_name``, whose OAuth client is (``oauth_key``,
    ``oauth_secret``), with a token already issued. ``audit`` is the
    gateway's sink (default none). Serve the gateway with
    ``serving/fast_http.py::gateway_routes(gw)``."""
    from seldon_core_tpu_torch.gateway.app import Gateway, InProcessBackend
    from seldon_core_tpu_torch.gateway.oauth import OAuthProvider
    from seldon_core_tpu_torch.gateway.store import DeploymentStore
    from seldon_core_tpu_torch.graph.spec import DeploymentSpec
    from seldon_core_tpu_torch.serving.gc_policy import apply_serving_gc_policy
    from seldon_core_tpu_torch.serving.server import PredictorServer

    server = PredictorServer(predictor, deployment_name=deployment_name, device=device, mesh_devices=mesh_devices)
    server.warmup()
    apply_serving_gc_policy()
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    backend = InProcessBackend()
    gw = Gateway(store=store, oauth=oauth, backend=backend, audit=audit)
    store.deployment_added(
        DeploymentSpec(name=deployment_name, oauth_key=oauth_key, oauth_secret=oauth_secret, predictors=(predictor,))
    )
    backend.register(deployment_name, server.service)
    token = oauth.issue_token(oauth_key, oauth_secret)["access_token"]
    return server, gw, oauth, token
