"""The control plane (port of ``seldon_core_tpu/operator/``): the
reconciler, its REST route table (``operator_routes``, the JAX package's
``add_operator_routes``), the directory and Kubernetes watchers and the
manifest builder. ``crd_schema.py`` is not ported yet."""

from seldon_core_tpu_torch.operator.api import operator_routes
from seldon_core_tpu_torch.operator.reconciler import (
    DeploymentManager,
    ReconcileResult,
    RunningDeployment,
    watch_directory,
)
from seldon_core_tpu_torch.operator.k8s_watcher import (
    KubernetesWatcher,
    watch_kubernetes,
)
from seldon_core_tpu_torch.operator.resources import (
    create_resources,
    deployment_service,
    engine_container,
    predictor_deployment,
)

__all__ = [
    "DeploymentManager",
    "KubernetesWatcher",
    "watch_kubernetes",
    "ReconcileResult",
    "RunningDeployment",
    "operator_routes",
    "create_resources",
    "deployment_service",
    "engine_container",
    "predictor_deployment",
    "watch_directory",
]
