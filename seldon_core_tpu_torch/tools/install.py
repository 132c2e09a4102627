"""Install-bundle generator: the helm-chart equivalent.

Port of ``seldon_core_tpu/tools/install.py``, the same manifests and values
layer. Parity: reference helm-charts/seldon-core/templates — CRD with
openAPIV3 validation (seldon-deployment-crd.json), RBAC (rbac.yaml), the
operator + gateway Deployments and the platform Service. Here one CLI
renders the whole bundle as Kubernetes YAML for GKE with H100 node pools,
with the platform running as ONE deployment (control plane + gateway +
engines in-process, see platform.py) instead of the reference's three Java
services:

    python -m seldon_core_tpu_torch.tools.install [--namespace seldon] \
        [--image IMAGE] [--with-redis] [--with-monitoring] [-o DIR]

prints to stdout (kubectl apply -f -) or writes one file per manifest.

Where the bundle differs from the JAX package's: the platform pod asks for
cards (``nvidia.com/gpu`` on the H100 node selector of
``operator/resources.py``) instead of a TPU slice, the values key
``platform.tpu_chips`` (and ``--tpu-chips``) is read as the card count, the
containers run the port's modules, and the default image is the port's own
(``Dockerfile.torch``, ``tools/release.py::IMAGE_BASENAME``).
"""

from __future__ import annotations

import argparse
import os
import sys

_CRD_TEMPLATE = {
    "apiVersion": "apiextensions.k8s.io/v1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": "seldondeployments.machinelearning.seldon.io"},
    "spec": {
        "group": "machinelearning.seldon.io",
        "names": {
            "kind": "SeldonDeployment",
            "listKind": "SeldonDeploymentList",
            "plural": "seldondeployments",
            "singular": "seldondeployment",
            "shortNames": ["sdep"],  # reference CRD short name
        },
        "scope": "Namespaced",
        "versions": [
            {
                "name": "v1alpha1",
                "served": True,
                "storage": True,
                "schema": {
                    "openAPIV3Schema": {
                        "type": "object",
                        "properties": {
                            # generated from the pydantic contract with the
                            # recursive graph expanded to finite depth —
                            # the reference's expand-validation.py flow,
                            # single-sourced (operator/crd_schema.py); full
                            # graph validation still happens in the
                            # operator (graph/validation.py)
                            "spec": "__GENERATED__",
                            "status": {
                                "type": "object",
                                "x-kubernetes-preserve-unknown-fields": True,
                            },
                        },
                    }
                },
                "subresources": {"status": {}},
                # `kubectl get sdep` shows rollout state at a glance — the
                # columns mirror the operator's status writeback fields
                "additionalPrinterColumns": [
                    {
                        "name": "State",
                        "type": "string",
                        "jsonPath": ".status.state",
                    },
                    {
                        "name": "Description",
                        "type": "string",
                        "priority": 1,
                        "jsonPath": ".status.description",
                    },
                    {
                        "name": "Age",
                        "type": "date",
                        "jsonPath": ".metadata.creationTimestamp",
                    },
                ],
            }
        ],
    },
}


def crd() -> dict:
    """CRD manifest with the generated validation schema filled in."""
    import copy

    from seldon_core_tpu_torch.operator.crd_schema import deployment_validation_schema

    out = copy.deepcopy(_CRD_TEMPLATE)
    props = out["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]
    props["spec"] = deployment_validation_schema()
    return out


def service_account(namespace: str) -> dict:
    """Always rendered — the platform pod names it in serviceAccountName, so
    it must exist even with rbac: false (only the cluster-wide grants are
    optional)."""
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {"name": "seldon-core-tpu", "namespace": namespace},
    }


def rbac(namespace: str) -> list[dict]:
    return [
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": "seldon-core-tpu"},
            "rules": [
                {
                    "apiGroups": ["machinelearning.seldon.io"],
                    "resources": ["seldondeployments", "seldondeployments/status"],
                    "verbs": ["get", "list", "watch", "update", "patch"],
                },
                {
                    "apiGroups": ["apps"],
                    "resources": ["deployments"],
                    "verbs": ["get", "list", "watch", "create", "update", "delete"],
                },
                {
                    "apiGroups": [""],
                    "resources": ["services"],
                    "verbs": ["get", "list", "watch", "create", "update", "delete"],
                },
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": "seldon-core-tpu"},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": "seldon-core-tpu",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": "seldon-core-tpu",
                    "namespace": namespace,
                }
            ],
        },
    ]


def platform_deployment(
    namespace: str,
    image: str,
    tpu_chips: int = 1,
    pull_policy: str = "IfNotPresent",
    service_type: str = "",
    storage: dict | None = None,
    autoscaling: dict | None = None,
) -> list[dict]:
    """The platform pod hosts the engines, so IT is the pod that needs the
    cards: with ``tpu_chips`` (the card count) > 0 it gets the H100 node
    selector + an ``nvidia.com/gpu`` request (all on one node, at most 8:
    ``operator/resources.py::gpu_request``). ``storage``
    (when enabled) mounts the seldon-models PVC (storage_manifests) at its
    mount_path so file:// checkpoint URIs resolve to durable volume paths."""
    pod_spec: dict = {"serviceAccountName": "seldon-core-tpu"}
    autoscaled = bool(autoscaling and autoscaling.get("enabled"))
    volumes: list[dict] = []
    volume_mounts: list[dict] = []
    if storage and storage.get("enabled"):
        volumes.append(
            {
                "name": "models",
                "persistentVolumeClaim": {"claimName": "seldon-models"},
            }
        )
        volume_mounts.append(
            {
                "name": "models",
                "mountPath": storage.get("mount_path", "/var/seldon/models"),
            }
        )
    if volumes:
        pod_spec["volumes"] = volumes
    resources: dict = {}
    if tpu_chips > 0:
        from seldon_core_tpu_torch.operator.resources import (
            GPU_NODE_SELECTOR,
            GPU_RESOURCE,
            gpu_request,
        )

        pod_spec["nodeSelector"] = dict(GPU_NODE_SELECTOR)
        resources = {"limits": {GPU_RESOURCE: str(gpu_request(tpu_chips))}}
    if autoscaled:
        # the HPA's cpu Utilization target is usage/REQUEST — without a cpu
        # request the controller reports FailedGetResourceMetric and never
        # scales
        resources.setdefault("requests", {})["cpu"] = str(
            autoscaling.get("cpu_request", "1")
        )
    return [
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "seldon-core-tpu-platform", "namespace": namespace},
            "spec": {
                # under an HPA, spec.replicas must be OMITTED: a bundle
                # re-apply would otherwise snap a scaled-up platform back
                # to 1 replica, killing serving pods mid-traffic
                **({} if autoscaled else {"replicas": 1}),
                "selector": {"matchLabels": {"app": "seldon-core-tpu-platform"}},
                "template": {
                    "metadata": {
                        "labels": {"app": "seldon-core-tpu-platform"},
                        "annotations": {
                            "prometheus.io/scrape": "true",
                            "prometheus.io/path": "/prometheus",
                            "prometheus.io/port": "8080",
                        },
                    },
                    "spec": {
                        **pod_spec,
                        "containers": [
                            {
                                "name": "platform",
                                "image": image,
                                "imagePullPolicy": pull_policy,
                                "command": [
                                    "python",
                                    "-m",
                                    "seldon_core_tpu_torch.platform",
                                    "--port",
                                    "8080",
                                    "--grpc-port",
                                    "5000",
                                    # data plane on the fast ingress, full
                                    # REST app (control API) on the admin
                                    # port — the reference engine's
                                    # admin-8082 topology
                                    "--fast-ingress",
                                    "--admin-port",
                                    "8082",
                                    # reconcile SeldonDeployment CRs on the
                                    # API server — the reason the RBAC watch
                                    # verbs and CRD status subresource exist
                                    "--watch-k8s",
                                    "--k8s-namespace",
                                    namespace,
                                ],
                                "ports": [
                                    {"containerPort": 8080, "name": "http"},
                                    {"containerPort": 5000, "name": "grpc"},
                                    {"containerPort": 8082, "name": "admin"},
                                ],
                                "readinessProbe": {
                                    "httpGet": {"path": "/ready", "port": "http"},
                                    "initialDelaySeconds": 15,
                                },
                                **({"resources": resources} if resources else {}),
                                **(
                                    {"volumeMounts": volume_mounts}
                                    if volume_mounts
                                    else {}
                                ),
                            }
                        ],
                    },
                },
            },
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "seldon-core-tpu", "namespace": namespace},
            "spec": {
                "selector": {"app": "seldon-core-tpu-platform"},
                "ports": [
                    {"name": "http", "port": 8080, "targetPort": 8080},
                    {"name": "grpc", "port": 5000, "targetPort": 5000},
                    # control-plane REST (CR apply/list/delete) — the fast
                    # ingress serves only the data plane on 8080
                    {"name": "admin", "port": 8082, "targetPort": 8082},
                ],
                # reference knob apife_service_type (values.yaml:5)
                **({"type": service_type} if service_type else {}),
            },
        },
    ]


def autoscaling_manifests(namespace: str, autoscaling: dict) -> list[dict]:
    """HorizontalPodAutoscaler for the platform Deployment (the reference
    scales by hand-set `replicas`; this is the modern automatic variant).
    Multi-replica platform is coherent when shared state is externalized:
    tokens in redis (`oauth.token_store: redis://...`), audit in kafka, and
    every replica reconciles the same CRs from its own watch. Each replica
    schedules onto its own cards via the node selector."""
    out: list[dict] = []
    if int(autoscaling.get("max_replicas", 4)) > 1:
        # the multi-replica envelope is max_replicas (the HPA can be scaled
        # up from min=1): the PDB keeps voluntary evictions (node drain,
        # cluster upgrade) from taking every serving pod at once
        out.append(
            {
                "apiVersion": "policy/v1",
                "kind": "PodDisruptionBudget",
                "metadata": {
                    "name": "seldon-core-tpu-platform",
                    "namespace": namespace,
                },
                "spec": {
                    "minAvailable": 1,
                    "selector": {
                        "matchLabels": {"app": "seldon-core-tpu-platform"}
                    },
                },
            }
        )
    return out + [
        {
            "apiVersion": "autoscaling/v2",
            "kind": "HorizontalPodAutoscaler",
            "metadata": {
                "name": "seldon-core-tpu-platform",
                "namespace": namespace,
            },
            "spec": {
                "scaleTargetRef": {
                    "apiVersion": "apps/v1",
                    "kind": "Deployment",
                    "name": "seldon-core-tpu-platform",
                },
                "minReplicas": int(autoscaling.get("min_replicas", 1)),
                "maxReplicas": int(autoscaling.get("max_replicas", 4)),
                "metrics": [
                    {
                        "type": "Resource",
                        "resource": {
                            "name": "cpu",
                            "target": {
                                "type": "Utilization",
                                "averageUtilization": int(
                                    autoscaling.get("target_cpu_percent", 80)
                                ),
                            },
                        },
                    }
                ],
            },
        }
    ]


def storage_manifests(namespace: str, storage: dict) -> list[dict]:
    """Model-artifact volume (reference `persistence/` host-volume /
    glusterfs create scripts, modernized): a PersistentVolumeClaim the
    platform and model microservices mount for checkpoints and model
    artifacts (persistence/checkpoint.py file:// URIs resolve under
    ``mount_path``). ``host_path`` set -> also emit a hostPath
    PersistentVolume bound to the claim (single-node / dev clusters, the
    reference's host-volume case); unset -> the cluster's default
    StorageClass provisions (the modern glusterfs-create equivalent)."""
    claim: dict = {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {"name": "seldon-models", "namespace": namespace},
        "spec": {
            "accessModes": [storage.get("access_mode", "ReadWriteOnce")],
            "resources": {"requests": {"storage": storage.get("size", "10Gi")}},
        },
    }
    out: list[dict] = []
    host_path = storage.get("host_path", "")
    if host_path:
        out.append(
            {
                "apiVersion": "v1",
                "kind": "PersistentVolume",
                "metadata": {"name": f"seldon-models-{namespace}"},
                "spec": {
                    "capacity": {"storage": storage.get("size", "10Gi")},
                    "accessModes": [storage.get("access_mode", "ReadWriteOnce")],
                    "hostPath": {"path": host_path},
                    "persistentVolumeReclaimPolicy": "Retain",
                    "claimRef": {
                        "name": "seldon-models",
                        "namespace": namespace,
                    },
                },
            }
        )
        claim["spec"]["storageClassName"] = ""  # bind the static PV only
    out.append(claim)
    return out


def redis_manifests(namespace: str) -> list[dict]:
    """In-memory redis (reference redis-memonly/) for token + state stores."""
    return [
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "redis", "namespace": namespace},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": "redis"}},
                "template": {
                    "metadata": {"labels": {"app": "redis"}},
                    "spec": {
                        "containers": [
                            {
                                "name": "redis",
                                "image": "redis:7-alpine",
                                "args": ["--save", "", "--appendonly", "no"],
                                "ports": [{"containerPort": 6379}],
                            }
                        ]
                    },
                },
            },
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "redis", "namespace": namespace},
            "spec": {"selector": {"app": "redis"}, "ports": [{"port": 6379}]},
        },
    ]


def zookeeper_manifests(namespace: str, image: str) -> list[dict]:
    """Zookeeper for the kafka broker (reference zookeeper-k8s/ — a 3-node
    ensemble of per-server Services; rendered single-node here, the dev
    shape, with the same client/follower/election port layout)."""
    return [
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "zookeeper", "namespace": namespace},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": "zookeeper"}},
                "template": {
                    "metadata": {"labels": {"app": "zookeeper"}},
                    "spec": {
                        "containers": [
                            {
                                "name": "zookeeper",
                                "image": image,
                                "env": [
                                    {"name": "ALLOW_ANONYMOUS_LOGIN", "value": "yes"}
                                ],
                                "ports": [
                                    {"containerPort": 2181, "name": "client"},
                                    {"containerPort": 2888, "name": "followers"},
                                    {"containerPort": 3888, "name": "election"},
                                ],
                            }
                        ]
                    },
                },
            },
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "zookeeper", "namespace": namespace},
            "spec": {
                "selector": {"app": "zookeeper"},
                "ports": [
                    {"name": "client", "port": 2181},
                    {"name": "followers", "port": 2888},
                    {"name": "election", "port": 3888},
                ],
            },
        },
    ]


def kafka_manifests(namespace: str, image: str, zookeeper_image: str) -> list[dict]:
    """Kafka broker + zookeeper (reference kafka/kafka.json:1-130 +
    zookeeper-k8s/) so the gateway audit sink's kafka:// mode
    (gateway/audit.py) has a deployable broker. Single broker on port 9092
    advertising its pod IP, like the reference's one-replica deployment."""
    return zookeeper_manifests(namespace, zookeeper_image) + [
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "kafka", "namespace": namespace},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": "kafka"}},
                "template": {
                    "metadata": {"labels": {"app": "kafka"}},
                    "spec": {
                        "containers": [
                            {
                                "name": "kafka",
                                "image": image,
                                "env": [
                                    # bitnami/kafka 3.x defaults to KRaft;
                                    # zookeeper mode (the reference topology)
                                    # must be selected explicitly or the
                                    # broker aborts at config validation
                                    {"name": "KAFKA_ENABLE_KRAFT", "value": "no"},
                                    {"name": "KAFKA_CFG_BROKER_ID", "value": "1"},
                                    {
                                        "name": "KAFKA_CFG_ZOOKEEPER_CONNECT",
                                        "value": "zookeeper:2181",
                                    },
                                    {
                                        "name": "KAFKA_CFG_LISTENERS",
                                        "value": "PLAINTEXT://:9092",
                                    },
                                    # reference advertises the pod host
                                    # (kafka.json KAFKA_ADVERTISED_HOST_NAME
                                    # from fieldRef)
                                    {
                                        "name": "KAFKA_CFG_ADVERTISED_LISTENERS",
                                        "value": "PLAINTEXT://kafka:9092",
                                    },
                                    {"name": "ALLOW_PLAINTEXT_LISTENER", "value": "yes"},
                                ],
                                "ports": [{"containerPort": 9092, "name": "kafka"}],
                            }
                        ]
                    },
                },
            },
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "kafka", "namespace": namespace},
            "spec": {
                "selector": {"app": "kafka"},
                "ports": [{"name": "kafka", "port": 9092}],
            },
        },
    ]


def loadtest_job(
    namespace: str,
    image: str,
    host: str = "http://seldon-core-tpu:8080",
    users: int = 10,
    duration_s: int = 60,
    oauth_key: str = "",
    oauth_secret: str = "",
) -> list[dict]:
    """Load-test Job (reference helm-charts/seldon-core-loadtesting — a
    locust master + slave pair with clients/hatchRate/oauth knobs,
    values.yaml:1-20). The asyncio loadtester (tools/loadtest.py) needs no
    master/slave split: one Job pod drives the configured user count."""
    if bool(oauth_key) != bool(oauth_secret):
        raise ValueError(
            "loadtest oauth credentials must be given together "
            f"(oauth_key {'set' if oauth_key else 'empty'}, oauth_secret "
            f"{'set' if oauth_secret else 'empty'}); a half-configured Job "
            "would fail every request with 401 at runtime"
        )
    cmd = [
        "python",
        "-m",
        "seldon_core_tpu_torch.tools.loadtest",
        host,
        "--users",
        str(users),
        "--duration",
        str(duration_s),
        "--json",
    ]
    container: dict = {"name": "loadtest", "image": image, "command": cmd}
    out: list[dict] = []
    if oauth_key:
        # credentials ride a Secret -> env (LOADTEST_OAUTH_* fallbacks in
        # tools/loadtest.py), never the pod spec's command args, which any
        # Job/Pod reader could see via `kubectl get -o yaml`
        out.append(
            {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": "seldon-loadtest-oauth",
                    "namespace": namespace,
                },
                "type": "Opaque",
                "stringData": {"key": oauth_key, "secret": oauth_secret},
            }
        )
        container["env"] = [
            {
                "name": "LOADTEST_OAUTH_KEY",
                "valueFrom": {
                    "secretKeyRef": {"name": "seldon-loadtest-oauth", "key": "key"}
                },
            },
            {
                "name": "LOADTEST_OAUTH_SECRET",
                "valueFrom": {
                    "secretKeyRef": {
                        "name": "seldon-loadtest-oauth",
                        "key": "secret",
                    }
                },
            },
        ]
    out.append(
        {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {"name": "seldon-loadtest", "namespace": namespace},
            "spec": {
                "backoffLimit": 0,
                "template": {
                    "metadata": {"labels": {"app": "seldon-loadtest"}},
                    "spec": {
                        "restartPolicy": "Never",
                        "containers": [container],
                    },
                },
            },
        }
    )
    return out


# --------------------------------------------------------------- monitoring
def _monitoring_asset(name: str) -> str | None:
    """Load a monitoring asset (rules / dashboard) from deploy/monitoring
    next to the repo root (the JAX package's files, shared); returns None
    when not shipped (installed wheel)."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "..", "..", "deploy", "monitoring", name)
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return None


# Alertmanager route skeleton (reference monitoring/alertmanager/
# config.yml.example): group by alertname, webhook receiver the operator
# points at their paging system. Kept minimal and valid out of the box.
_ALERTMANAGER_CONFIG = """\
route:
  receiver: default
  group_by: ['alertname']
  group_wait: 30s
  group_interval: 5m
  repeat_interval: 3h
receivers:
  - name: default
    webhook_configs:
      - url: http://alert-webhook.example/hook   # point at slack-bridge/pagerduty
        send_resolved: true
"""


def monitoring_manifests(namespace: str, monitoring: dict) -> list[dict]:
    """Prometheus + Alertmanager + Grafana (reference monitoring/ +
    helm-charts/seldon-core-analytics): prometheus scrapes pods by the
    operator's prometheus.io annotations (own ServiceAccount with pod
    list/watch RBAC), loads the serving alert rules, and fires into
    alertmanager; grafana ships the predictions dashboard provisioned with
    a prometheus datasource. ``monitoring`` is the values section."""
    rules = _monitoring_asset("prometheus-rules.yaml")
    dashboard = _monitoring_asset("grafana-predictions-dashboard.json")
    if rules is None or dashboard is None:
        # silently rendering empty rules / no grafana would look deployed
        # while every documented alert is permanently absent
        raise RuntimeError(
            "--with-monitoring needs the deploy/monitoring assets "
            "(prometheus-rules.yaml, grafana-predictions-dashboard.json) — "
            "run from a repo checkout, or vendor them next to the package"
        )
    prom_config = f"""\
global:
  scrape_interval: 15s
  evaluation_interval: 15s
rule_files:
  - /etc/prometheus/rules/seldon-rules.yaml
alerting:
  alertmanagers:
    - static_configs:
        - targets: ['alertmanager.{namespace}.svc:9093']
scrape_configs:
  - job_name: seldon-pods
    kubernetes_sd_configs:
      - role: pod
        namespaces:
          own_namespace: true
    relabel_configs:
      - source_labels: [__meta_kubernetes_pod_annotation_prometheus_io_scrape]
        action: keep
        regex: 'true'
      - source_labels: [__meta_kubernetes_pod_annotation_prometheus_io_path]
        action: replace
        target_label: __metrics_path__
        regex: (.+)
      - source_labels: [__address__, __meta_kubernetes_pod_annotation_prometheus_io_port]
        action: replace
        regex: ([^:]+)(?::\\d+)?;(\\d+)
        replacement: $1:$2
        target_label: __address__
"""

    def deploy(name, image, port, args=None, mounts=None, vols=None, sa=None):
        container = {
            "name": name,
            "image": image,
            "ports": [{"containerPort": port}],
        }
        if args:
            container["args"] = args
        if mounts:
            container["volumeMounts"] = mounts
        spec = {"containers": [container]}
        if vols:
            spec["volumes"] = vols
        if sa:
            spec["serviceAccountName"] = sa
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": spec,
                },
            },
        }

    def svc(name, port):
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {
                "selector": {"app": name},
                "ports": [{"port": port, "targetPort": port}],
            },
        }

    m = monitoring
    # grafana provisioning: a dashboard PROVIDER pointing at the mounted
    # dir plus a prometheus datasource — without both, grafana boots empty
    grafana_provider = """\
apiVersion: 1
providers:
  - name: seldon
    type: file
    options:
      path: /var/lib/grafana/dashboards
"""
    grafana_datasource = f"""\
apiVersion: 1
datasources:
  - name: Prometheus
    type: prometheus
    access: proxy
    url: http://prometheus.{namespace}.svc:9090
    isDefault: true
"""
    out: list[dict] = [
        # prometheus pod service-discovery needs its own RBAC: the platform
        # SA's grants don't cover pods, and the namespace default SA cannot
        # list/watch them — without this the seldon-pods job has zero
        # targets and every alert rule is permanently silent
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": "prometheus", "namespace": namespace},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "Role",
            "metadata": {"name": "prometheus", "namespace": namespace},
            "rules": [
                {
                    "apiGroups": [""],
                    "resources": ["pods"],
                    "verbs": ["get", "list", "watch"],
                }
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": "prometheus", "namespace": namespace},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "Role",
                "name": "prometheus",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": "prometheus",
                    "namespace": namespace,
                }
            ],
        },
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": "prometheus-config", "namespace": namespace},
            "data": {"prometheus.yml": prom_config},
        },
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": "prometheus-rules", "namespace": namespace},
            "data": {"seldon-rules.yaml": rules},
        },
        deploy(
            "prometheus",
            m.get("prometheus_image", "prom/prometheus:v2.53.0"),
            9090,
            args=["--config.file=/etc/prometheus/prometheus.yml"],
            mounts=[
                {"name": "config", "mountPath": "/etc/prometheus/prometheus.yml", "subPath": "prometheus.yml"},
                {"name": "rules", "mountPath": "/etc/prometheus/rules"},
            ],
            vols=[
                {"name": "config", "configMap": {"name": "prometheus-config"}},
                {"name": "rules", "configMap": {"name": "prometheus-rules"}},
            ],
            sa="prometheus",
        ),
        svc("prometheus", 9090),
        # alertmanager: where the rules above actually go (reference
        # monitoring/alertmanager-deployment.json.in)
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": "alertmanager-config", "namespace": namespace},
            "data": {
                "config.yml": m.get("alertmanager_config") or _ALERTMANAGER_CONFIG
            },
        },
        deploy(
            "alertmanager",
            m.get("alertmanager_image", "prom/alertmanager:v0.27.0"),
            9093,
            args=["--config.file=/etc/alertmanager/config.yml"],
            mounts=[
                {"name": "config", "mountPath": "/etc/alertmanager/config.yml", "subPath": "config.yml"},
            ],
            vols=[{"name": "config", "configMap": {"name": "alertmanager-config"}}],
        ),
        svc("alertmanager", 9093),
    ]
    if dashboard:
        out += [
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {"name": "grafana-dashboards", "namespace": namespace},
                "data": {"predictions-dashboard.json": dashboard},
            },
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {"name": "grafana-provisioning", "namespace": namespace},
                "data": {
                    "dashboards.yaml": grafana_provider,
                    "datasources.yaml": grafana_datasource,
                },
            },
            deploy(
                "grafana",
                m.get("grafana_image", "grafana/grafana:11.1.0"),
                3000,
                mounts=[
                    {"name": "dashboards", "mountPath": "/var/lib/grafana/dashboards"},
                    {
                        "name": "provisioning",
                        "mountPath": "/etc/grafana/provisioning/dashboards/dashboards.yaml",
                        "subPath": "dashboards.yaml",
                    },
                    {
                        "name": "provisioning",
                        "mountPath": "/etc/grafana/provisioning/datasources/datasources.yaml",
                        "subPath": "datasources.yaml",
                    },
                ],
                vols=[
                    {"name": "dashboards", "configMap": {"name": "grafana-dashboards"}},
                    {"name": "provisioning", "configMap": {"name": "grafana-provisioning"}},
                ],
            ),
            svc("grafana", 3000),
        ]
    return out


# -------------------------------------------------------------- values layer

# The reference's helm values.yaml knobs (helm-charts/seldon-core/values.yaml:
# 1-20) mapped onto this platform. apife + cluster_manager + engine collapse
# into the single platform image (platform.py runs all three in-process);
# their shared knobs live under "platform".
DEFAULT_VALUES: dict = {
    "namespace": "seldon",
    "rbac": True,  # reference cluster_manager.rbac
    "platform": {
        "image": "seldon-core-tpu-torch/platform:latest",  # apife/cluster_manager/engine image+tag
        "pull_policy": "IfNotPresent",  # apife.image.pull_policy
        "service_type": "NodePort",  # apife_service_type
        "tpu_chips": 1,  # cards for the platform pod (0 = CPU-only)
    },
    "redis": {"enabled": False, "image": "redis:7-alpine"},  # redis.image.tag
    # reference persistence/ (host-volume / glusterfs scripts) modernized:
    # a PVC for model artifacts + checkpoints; host_path emits a static PV
    "storage": {
        "enabled": False,
        "size": "10Gi",
        "access_mode": "ReadWriteOnce",
        "host_path": "",
        "mount_path": "/var/seldon/models",
    },
    # reference goal "scale up/down" (docs/challenges.md): replicas by hand
    # there; automatic here. Requires externalized shared state for >1
    # replica (redis token store, kafka audit) — see autoscaling_manifests.
    "autoscaling": {
        "enabled": False,
        "min_replicas": 1,
        "max_replicas": 4,
        "target_cpu_percent": 80,
    },
    # reference monitoring/ + seldon-core-analytics chart: prometheus +
    # alertmanager + grafana with the serving rules/dashboard wired in
    "monitoring": {
        "enabled": False,
        "prometheus_image": "prom/prometheus:v2.53.0",
        "alertmanager_image": "prom/alertmanager:v0.27.0",
        "grafana_image": "grafana/grafana:11.1.0",
        "alertmanager_config": "",  # "" -> the shipped webhook skeleton
    },
    "kafka": {
        "enabled": False,
        "image": "bitnami/kafka:3.6",
        "zookeeper_image": "bitnami/zookeeper:3.9",
    },
    # reference helm-charts/seldon-core-loadtesting values (locust.clients ->
    # users, locust.host -> host, oauth.key/secret)
    "loadtest": {
        "enabled": False,
        "image": "",  # "" -> the platform image
        "host": "http://seldon-core-tpu:8080",
        "users": 10,
        "duration_s": 60,
        "oauth_key": "",
        "oauth_secret": "",
    },
}


def merge_values(overrides: dict | None) -> dict:
    """Deep-merge user values over DEFAULT_VALUES (dicts merge, scalars and
    lists replace) — helm's values semantics."""

    def merge(base, over):
        if over is None:
            # an empty section in a values file ("kafka:" with children
            # commented out) parses as None — keep the defaults
            return base
        if isinstance(base, dict) and isinstance(over, dict):
            out = dict(base)
            for k, v in over.items():
                out[k] = merge(base.get(k), v) if k in base else v
            return out
        return over

    return merge(DEFAULT_VALUES, overrides or {})


def build_bundle_from_values(values: dict | None = None) -> list[dict]:
    """Values-file equivalent of the CLI flags: one dict parameterizes the
    whole bundle, so installs are reproducible from a single artifact."""
    v = merge_values(values)
    namespace = v["namespace"]
    bundle: list[dict] = [
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": namespace}},
        crd(),
        service_account(namespace),
    ]
    if v["rbac"]:
        bundle += rbac(namespace)
    p = v["platform"]
    if v["autoscaling"]["enabled"] and int(v["autoscaling"]["max_replicas"]) > 1:
        # multi-replica platform needs externalized token state: replica B
        # must accept tokens issued by replica A (same precedent as
        # loadtest_job's half-configured-oauth rejection)
        if not v["redis"]["enabled"]:
            raise ValueError(
                "autoscaling with max_replicas > 1 requires redis.enabled "
                "(shared OAuth token store); in-memory tokens would be "
                "rejected across replicas"
            )
    bundle += platform_deployment(
        namespace,
        p["image"],
        tpu_chips=p["tpu_chips"],
        pull_policy=p["pull_policy"],
        service_type=p["service_type"],
        storage=v["storage"],
        autoscaling=v["autoscaling"],
    )
    if v["storage"]["enabled"]:
        bundle += storage_manifests(namespace, v["storage"])
    if v["autoscaling"]["enabled"]:
        bundle += autoscaling_manifests(namespace, v["autoscaling"])
    if v["redis"]["enabled"]:
        bundle += redis_manifests(namespace)
    if v["monitoring"]["enabled"]:
        bundle += monitoring_manifests(namespace, v["monitoring"])
    if v["kafka"]["enabled"]:
        bundle += kafka_manifests(
            namespace, v["kafka"]["image"], v["kafka"]["zookeeper_image"]
        )
    lt = v["loadtest"]
    if lt["enabled"]:
        bundle += loadtest_job(
            namespace,
            lt["image"] or p["image"],
            host=lt["host"],
            users=lt["users"],
            duration_s=lt["duration_s"],
            oauth_key=lt["oauth_key"],
            oauth_secret=lt["oauth_secret"],
        )
    return bundle


def build_bundle(
    namespace: str = "seldon",
    image: str = "seldon-core-tpu-torch/platform:latest",
    with_redis: bool = False,
    tpu_chips: int = 1,
    with_kafka: bool = False,
    with_monitoring: bool = False,
) -> list[dict]:
    # service_type "" keeps the legacy CLI's ClusterIP default — only the
    # values path defaults to NodePort (the reference apife_service_type)
    return build_bundle_from_values(
        {
            "namespace": namespace,
            "platform": {"image": image, "tpu_chips": tpu_chips, "service_type": ""},
            "redis": {"enabled": with_redis},
            "kafka": {"enabled": with_kafka},
            "monitoring": {"enabled": with_monitoring},
        }
    )


def to_yaml(manifests: list[dict]) -> str:
    import yaml

    return "---\n".join(yaml.safe_dump(m, sort_keys=False) for m in manifests)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--namespace", default="seldon")
    p.add_argument("--image", default="seldon-core-tpu-torch/platform:latest")
    p.add_argument("--with-redis", action="store_true")
    p.add_argument(
        "--with-kafka",
        action="store_true",
        help="render kafka + zookeeper (audit-stream broker, reference kafka/ + zookeeper-k8s/)",
    )
    p.add_argument(
        "--with-monitoring",
        action="store_true",
        help="render prometheus + alertmanager + grafana with the serving "
        "rules/dashboard (reference monitoring/ + seldon-core-analytics)",
    )
    p.add_argument(
        "--tpu-chips",
        type=int,
        default=1,
        help="cards (H100) for the platform pod, at most 8 (0 = CPU-only, for "
        "dev clusters)",
    )
    p.add_argument(
        "--values",
        default=None,
        help="values file (YAML or JSON) deep-merged over the defaults — the "
        "helm values.yaml equivalent; other flags are ignored when set",
    )
    p.add_argument("-o", "--out-dir", default=None)
    args = p.parse_args()
    if args.values:
        import yaml

        with open(args.values) as f:
            overrides = yaml.safe_load(f) or {}
        bundle = build_bundle_from_values(overrides)
    else:
        bundle = build_bundle(
            args.namespace,
            args.image,
            args.with_redis,
            args.tpu_chips,
            with_kafka=args.with_kafka,
            with_monitoring=args.with_monitoring,
        )
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for m in bundle:
            name = f"{m['kind'].lower()}-{m['metadata']['name']}.yaml"
            with open(os.path.join(args.out_dir, name), "w") as f:
                f.write(to_yaml([m]))
        print(args.out_dir)
    else:
        sys.stdout.write(to_yaml(bundle))


if __name__ == "__main__":
    main()
