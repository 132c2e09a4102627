"""Pure Kubernetes manifest construction from a SeldonDeployment.

Port of ``seldon_core_tpu/operator/resources.py`` (the reference's
SeldonDeploymentOperatorImpl.createResources, createEngineContainer and
createService as dict-building functions, testable without a cluster):

- one Deployment per predictor, the engine container given the predictor
  graph as base64 JSON in ``ENGINE_PREDICTOR``;
- prometheus scrape annotations;
- rolling update, 10% max unavailable;
- readiness and liveness probes on ``/ready`` and ``/ping``, a preStop
  ``/pause`` drain;
- one ClusterIP Service: http 8000, grpc 5000.

The accelerator fields are the port's counterpart of the JAX package's TPU
slice: a predictor with a ``tpu.mesh`` requests ``nvidia.com/gpu`` for the
mesh's device count on an H100 node pool, and a mesh larger than the 8
cards of one node is refused by name (the engine serves one process on one
node).
"""

from __future__ import annotations

import math

from seldon_core_tpu_torch.graph.spec import PredictorSpec, SeldonDeployment, to_json
from seldon_core_tpu_torch.utils.env import encode_b64_json

ENGINE_IMAGE = "seldon-core-tpu-torch/engine:latest"
HTTP_PORT = 8000
GRPC_PORT = 5000
ADMIN_PORT = 8082
GPU_RESOURCE = "nvidia.com/gpu"
GPU_NODE_SELECTOR = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
CARDS_PER_NODE = 8


def _mesh_devices(pred: PredictorSpec) -> int:
    return math.prod(int(size) for size in (pred.tpu.mesh or {}).values())


def gpu_request(n_devices: int) -> int:
    """Cards to request for a mesh of ``n_devices``: all on one node."""
    if n_devices > CARDS_PER_NODE:
        raise ValueError(f"mesh needs {n_devices} cards; one node holds at most {CARDS_PER_NODE}")
    return max(1, n_devices)


def engine_container(dep: SeldonDeployment, pred: PredictorSpec) -> dict:
    return {
        "name": "seldon-engine-tpu",
        "image": ENGINE_IMAGE,
        "env": [
            # the reference's config hand-off
            {"name": "ENGINE_PREDICTOR", "value": encode_b64_json(to_json(pred, exclude_none=True))},
            {"name": "SELDON_DEPLOYMENT_ID", "value": dep.spec.name or dep.metadata.name},
            {"name": "ENGINE_SERVER_PORT", "value": str(HTTP_PORT)},
            {"name": "ENGINE_SERVER_GRPC_PORT", "value": str(GRPC_PORT)},
        ],
        "ports": [
            {"containerPort": HTTP_PORT, "name": "http"},
            {"containerPort": GRPC_PORT, "name": "grpc"},
            {"containerPort": ADMIN_PORT, "name": "admin"},
        ],
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": "admin"},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
            "failureThreshold": 3,
        },
        "livenessProbe": {
            "httpGet": {"path": "/ping", "port": "admin"},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
        },
        "lifecycle": {
            # drain as the reference does: flip readiness, then wait
            "preStop": {
                "exec": {
                    "command": [
                        "/bin/sh",
                        "-c",
                        f"curl -s localhost:{ADMIN_PORT}/pause && sleep 5",
                    ]
                }
            }
        },
        "resources": {
            "requests": {"cpu": "0.1"},  # the reference's default
        },
    }


def predictor_deployment(dep: SeldonDeployment, pred: PredictorSpec) -> dict:
    name = dep.spec.name or dep.metadata.name
    dname = f"{name}-{pred.name}"
    container = engine_container(dep, pred)
    pod_spec: dict = {"containers": [container], "terminationGracePeriodSeconds": 20}
    if pred.tpu.mesh:
        # an explicit mesh, even {"data": 1}, means accelerator execution:
        # the node selector picks the H100 pool, the container the cards
        cards = gpu_request(_mesh_devices(pred))
        pod_spec["nodeSelector"] = dict(GPU_NODE_SELECTOR)
        container["resources"].setdefault("limits", {})[GPU_RESOURCE] = str(cards)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": dname,
            "labels": {
                "seldon-deployment-id": name,
                "seldon-type": "deployment",  # the status watch's selector
                "app": dname,
            },
        },
        "spec": {
            "replicas": pred.replicas,
            "selector": {"matchLabels": {"app": dname}},
            "strategy": {
                "type": "RollingUpdate",
                "rollingUpdate": {"maxUnavailable": "10%"},
            },
            "template": {
                "metadata": {
                    "labels": {"app": dname, "seldon-deployment-id": name},
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": "/prometheus",
                        "prometheus.io/port": str(ADMIN_PORT),
                    },
                },
                "spec": pod_spec,
            },
        },
    }


def deployment_service(dep: SeldonDeployment) -> dict:
    name = dep.spec.name or dep.metadata.name
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": {"seldon-deployment-id": name}},
        "spec": {
            "type": "ClusterIP",
            "selector": {"seldon-deployment-id": name},
            "ports": [
                {"name": "http", "port": HTTP_PORT, "targetPort": HTTP_PORT},
                {"name": "grpc", "port": GRPC_PORT, "targetPort": GRPC_PORT},
            ],
        },
    }


def create_resources(dep: SeldonDeployment) -> list[dict]:
    """Every manifest of one SeldonDeployment: a Deployment per predictor
    and one Service."""
    out = [predictor_deployment(dep, p) for p in dep.spec.predictors]
    out.append(deployment_service(dep))
    return out
