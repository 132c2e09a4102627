"""The port's CRD schema (``operator/crd_schema.py``) and install bundle
(``tools/install.py``) against the JAX package's.

- The CRD schema derived from the port's dataclasses equals the one JAX
  compiles from pydantic at depths 8, 1 and 0, up to ``CRD_DIFFERENCES``
  (each logged under Deliberate differences in ``ROADMAP.md``); a spec
  field left out of the derivation fails the comparison.
- ``build_bundle_from_values`` for the defaults, ``deploy/values.yaml`` and
  ``deploy/values-production.yaml`` equals the JAX package's manifest by
  manifest, up to the port's module names, its GPU scheduling and its
  image.
- Twins of the JAX package's install and CRD tests, the TPU-scheduling
  one held to ``nvidia.com/gpu`` on the H100 selector.
"""

from __future__ import annotations

import json
import os

import pytest
import yaml

from seldon_core_tpu.operator import crd_schema as jax_crd_schema
from seldon_core_tpu.tools import install as jax_install
from seldon_core_tpu_torch.operator import crd_schema
from seldon_core_tpu_torch.operator.resources import GPU_NODE_SELECTOR
from seldon_core_tpu_torch.tools import install
from seldon_core_tpu_torch.tools.install import build_bundle, build_bundle_from_values, to_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_PATH = "/properties/predictors/items/properties/tpu"
# the TpuSpec docstring: the port's own text, not the JAX package's TPU one
CRD_DIFFERENCES = [f"{TPU_PATH}/description"]
PLATFORM = ("Deployment", "seldon-core-tpu-platform")


def diff_paths(a, b, path: str = "") -> list[str]:
    """JSON paths where ``a`` and ``b`` differ (a key on one side only, or
    unequal leaves)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(f"{path}/{k}")
            else:
                out += diff_paths(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in diff_paths(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


@pytest.mark.parametrize("depth", [8, 1, 0])
def test_crd_schema_equals_jax(depth):
    ours = crd_schema.deployment_validation_schema(depth)
    theirs = jax_crd_schema.deployment_validation_schema(depth)
    assert diff_paths(ours, theirs) == CRD_DIFFERENCES
    # the JAX contract's 40 knobs, decode_mesh_axes (a served field) included
    assert len(ours["properties"]["predictors"]["items"]["properties"]["tpu"]["properties"]) == 40


def test_crd_schema_comparison_catches_a_missing_field(monkeypatch):
    monkeypatch.setattr(crd_schema, "_SKIP_FIELDS", crd_schema._SKIP_FIELDS | {("TpuSpec", "decode_slots"),
                                                                             ("Parameter", "type")})
    got = diff_paths(crd_schema.deployment_validation_schema(1), jax_crd_schema.deployment_validation_schema(1))
    assert f"{TPU_PATH}/properties/decode_slots" in got
    assert "/properties/predictors/items/properties/graph/properties/parameters/items/properties/type" in got


def test_crd_schema_keeps_the_refused_knob():
    """``decode_mesh_axes``, a port dataclass field since tensor-parallel
    decode was ported, has the JAX contract's type in the schema (the API
    server would prune it otherwise), and ``extra`` is no field there."""
    tpu = crd_schema.deployment_validation_schema()["properties"]["predictors"]["items"]["properties"]["tpu"]
    assert tpu["properties"]["decode_mesh_axes"] == {"additionalProperties": {"type": "integer"}, "type": "object"}
    assert "extra" not in tpu["properties"]


def test_model_json_schema_has_pydantic_shape():
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment

    schema = crd_schema.model_json_schema(SeldonDeployment)
    defs = schema["$defs"]
    assert defs["PredictiveUnit"]["properties"]["children"] == {
        "items": {"$ref": "#/$defs/PredictiveUnit"}, "type": "array"}
    assert defs["PredictiveUnit"]["properties"]["type"] == {
        "anyOf": [{"$ref": "#/$defs/PredictiveUnitType"}, {"type": "null"}]}
    assert defs["PredictiveUnit"]["required"] == ["name"]
    assert defs["EndpointType"]["enum"] == ["REST", "GRPC"]
    assert "description" not in defs["Endpoint"]


def test_crd_validation_schema_is_structural_and_depth_limited():
    schema = crd_schema.deployment_validation_schema(max_graph_depth=3)
    blob = json.dumps(schema)
    assert '"$ref"' not in blob and '"anyOf"' not in blob and '"$defs"' not in blob
    graph = schema["properties"]["predictors"]["items"]["properties"]["graph"]
    depth, node = 0, graph
    while "properties" in node:
        assert node["type"] == "object"
        assert "name" in node["properties"] and "implementation" in node["properties"]
        node = node["properties"]["children"]["items"]
        depth += 1
    assert depth == 3
    assert node["x-kubernetes-preserve-unknown-fields"] is True
    type_schema = graph["properties"]["type"]
    assert "MODEL" in type_schema["enum"] and "ROUTER" in type_schema["enum"]
    assert type_schema.get("nullable") is True
    spec_schema = install.crd()["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]
    assert spec_schema["properties"]["predictors"]["type"] == "array"
    assert "oauth_key" in spec_schema["properties"]


@pytest.mark.parametrize("knobs", [
    ("decode_replicas", "decode_router_policy", "decode_autoscale_replicas", "decode_autoscale_queue_depth"),
    ("decode_health_poll_ms", "decode_health_miss_threshold", "decode_drain_timeout_ms"),
], ids=["replica_knobs", "health_knobs"])
def test_crd_schema_carries_fleet_knobs(knobs):
    tpu = crd_schema.deployment_validation_schema()["properties"]["predictors"]["items"]["properties"]["tpu"]
    for k in knobs:
        assert k in tpu["properties"]


# ------------------------------------------------------------------ bundles
def _values(name: str):
    if name == "defaults":
        return None
    with open(os.path.join(REPO, "deploy", name)) as f:
        return yaml.safe_load(f)


def _key(m: dict) -> tuple:
    return m["kind"], m["metadata"]["name"]


@pytest.mark.parametrize("values", ["defaults", "values.yaml", "values-production.yaml"])
def test_bundle_equals_jax(values):
    v = _values(values)
    ours, theirs = build_bundle_from_values(v), jax_install.build_bundle_from_values(v)
    assert [_key(m) for m in ours] == [_key(m) for m in theirs]
    chips = jax_install.merge_values(v)["platform"]["tpu_chips"]
    image_given = bool(v and (v.get("platform") or {}).get("image"))
    c = "/spec/template/spec/containers/0"
    allowed = {
        # the platform's module and its GPU scheduling
        (PLATFORM, f"{c}/command/2"),
        (PLATFORM, "/spec/template/spec/nodeSelector/cloud.google.com/gke-tpu-accelerator"),
        (PLATFORM, "/spec/template/spec/nodeSelector/cloud.google.com/gke-tpu-topology"),
        (PLATFORM, f"/spec/template/spec/nodeSelector/{next(iter(GPU_NODE_SELECTOR))}"),
        (PLATFORM, f"{c}/resources/limits/google.com/tpu"),
        (PLATFORM, f"{c}/resources/limits/nvidia.com/gpu"),
        (("Job", "seldon-loadtest"), f"{c}/command/2"),
        # the CRD's one schema difference
        (("CustomResourceDefinition", "seldondeployments.machinelearning.seldon.io"),
         "/spec/versions/0/schema/openAPIV3Schema/properties/spec" + CRD_DIFFERENCES[0]),
    }
    if not image_given:
        allowed |= {(PLATFORM, f"{c}/image"), (("Job", "seldon-loadtest"), f"{c}/image")}
    found = {(_key(a), p) for a, b in zip(ours, theirs) for p in diff_paths(a, b)}
    assert found <= allowed, sorted(found - allowed)
    by_key = {_key(m): m for m in ours}
    pod = by_key[PLATFORM]["spec"]["template"]["spec"]
    container = pod["containers"][0]
    assert container["command"][:3] == ["python", "-m", "seldon_core_tpu_torch.platform"]
    assert pod["nodeSelector"] == GPU_NODE_SELECTOR
    assert container["resources"]["limits"] == {"nvidia.com/gpu": str(chips)}
    assert container["image"] == (v["platform"]["image"] if image_given else "seldon-core-tpu-torch/platform:latest")
    assert list(yaml.safe_load_all(to_yaml(ours)))


def test_install_bundle_gpu_scheduling():
    bundle = build_bundle(tpu_chips=6)
    pod = next(m for m in bundle if _key(m) == PLATFORM)["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert pod["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == "6"
    assert "google.com/tpu" not in json.dumps(bundle)
    cpu_bundle = build_bundle(tpu_chips=0)
    assert "nodeSelector" not in next(m for m in cpu_bundle if _key(m) == PLATFORM)["spec"]["template"]["spec"]
    # one node holds 8 cards: a larger platform pod cannot be scheduled
    with pytest.raises(ValueError, match="at most 8"):
        build_bundle(tpu_chips=9)


def test_install_bundle_manifests():
    bundle = build_bundle(namespace="ns1", with_redis=True)
    kinds = [m["kind"] for m in bundle]
    assert "CustomResourceDefinition" in kinds
    assert "ClusterRole" in kinds and "ClusterRoleBinding" in kinds
    assert kinds.count("Deployment") == 2
    crd = next(m for m in bundle if m["kind"] == "CustomResourceDefinition")
    assert crd["spec"]["names"]["shortNames"] == ["sdep"]
    cols = crd["spec"]["versions"][0]["additionalPrinterColumns"]
    assert [c["name"] for c in cols] == ["State", "Description", "Age"]
    assert cols[0]["jsonPath"] == ".status.state"
    docs = list(yaml.safe_load_all(to_yaml(bundle)))
    assert len(docs) == len(bundle)


def test_install_bundle_kafka_manifests():
    bundle = build_bundle(namespace="ns1", with_kafka=True)
    by_name = {_key(m): m for m in bundle}
    for key in (("Deployment", "kafka"), ("Service", "kafka"), ("Deployment", "zookeeper"),
                ("Service", "zookeeper")):
        assert key in by_name
    env = {e["name"]: e.get("value")
           for e in by_name[("Deployment", "kafka")]["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["KAFKA_CFG_ZOOKEEPER_CONNECT"] == "zookeeper:2181"
    assert env["KAFKA_ENABLE_KRAFT"] == "no" and env["KAFKA_CFG_BROKER_ID"] == "1"
    assert by_name[("Service", "kafka")]["spec"]["ports"][0]["port"] == 9092
    assert all(m["metadata"]["name"] not in ("kafka", "zookeeper") for m in build_bundle(namespace="ns1"))


def test_install_bundle_values_layer():
    from seldon_core_tpu_torch.tools.install import DEFAULT_VALUES, merge_values

    v = merge_values({"platform": {"image": "custom:1"}, "kafka": {"enabled": True}})
    assert v["platform"]["image"] == "custom:1"
    assert v["platform"]["service_type"] == DEFAULT_VALUES["platform"]["service_type"]
    assert v["kafka"]["image"] == DEFAULT_VALUES["kafka"]["image"]
    bundle = build_bundle_from_values({"namespace": "ns2", "rbac": False,
                                       "platform": {"image": "custom:1", "service_type": "LoadBalancer"},
                                       "kafka": {"enabled": True}})
    assert "ClusterRole" not in [m["kind"] for m in bundle]
    assert next(m for m in bundle if _key(m) == PLATFORM)["spec"]["template"]["spec"]["containers"][0][
        "image"] == "custom:1"
    svc = next(m for m in bundle if _key(m) == ("Service", "seldon-core-tpu"))
    assert svc["spec"]["type"] == "LoadBalancer"
    assert any(m["metadata"]["name"] == "kafka" for m in bundle)
    # an empty section ("kafka:" with its children commented out) keeps the defaults
    v = merge_values({"kafka": None, "platform": None})
    assert v["kafka"] == DEFAULT_VALUES["kafka"] and v["platform"] == DEFAULT_VALUES["platform"]
    build_bundle_from_values({"kafka": None})


def test_values_rbac_false_still_renders_service_account():
    bundle = build_bundle_from_values({"namespace": "ns3", "rbac": False})
    kinds = [m["kind"] for m in bundle]
    assert "ClusterRole" not in kinds and "ClusterRoleBinding" not in kinds
    assert "ServiceAccount" in kinds
    cmd = next(m for m in bundle if _key(m) == PLATFORM)["spec"]["template"]["spec"]["containers"][0]["command"]
    assert "--watch-k8s" in cmd and cmd[cmd.index("--k8s-namespace") + 1] == "ns3"
    assert "--fast-ingress" in cmd and cmd[cmd.index("--admin-port") + 1] == "8082"


def test_legacy_build_bundle_keeps_clusterip():
    svc = next(m for m in build_bundle() if _key(m) == ("Service", "seldon-core-tpu"))
    assert "type" not in svc["spec"]


def test_values_loadtest_job_renders():
    bundle = build_bundle_from_values({"loadtest": {"enabled": True, "users": 25, "oauth_key": "k",
                                                    "oauth_secret": "s"}})
    job = next(m for m in bundle if m["kind"] == "Job")
    container = job["spec"]["template"]["spec"]["containers"][0]
    cmd = container["command"]
    assert "seldon_core_tpu_torch.tools.loadtest" in cmd
    assert cmd[cmd.index("--users") + 1] == "25"
    assert "s" not in cmd and "--oauth-secret" not in cmd
    secret = next(m for m in bundle if _key(m) == ("Secret", "seldon-loadtest-oauth"))
    assert secret["stringData"] == {"key": "k", "secret": "s"}
    env = {e["name"]: e["valueFrom"]["secretKeyRef"] for e in container["env"]}
    assert env["LOADTEST_OAUTH_KEY"]["name"] == "seldon-loadtest-oauth"
    assert env["LOADTEST_OAUTH_SECRET"]["key"] == "secret"
    with pytest.raises(ValueError, match="oauth_key"):
        build_bundle_from_values({"loadtest": {"enabled": True, "oauth_secret": "s"}})
    assert not any(m["kind"] == "Job" for m in build_bundle_from_values({}))


def test_install_bundle_monitoring():
    bundle = build_bundle(with_monitoring=True)
    by_key = {_key(m): m for m in bundle}
    for key in (("Deployment", "prometheus"), ("Deployment", "alertmanager"), ("Deployment", "grafana"),
                ("ConfigMap", "alertmanager-config"), ("ServiceAccount", "prometheus")):
        assert key in by_key
    assert "PredictionLatencyP99High" in by_key[("ConfigMap", "prometheus-rules")]["data"]["seldon-rules.yaml"]
    assert "alertmanager" in by_key[("ConfigMap", "prometheus-config")]["data"]["prometheus.yml"]
    cfg = yaml.safe_load(by_key[("ConfigMap", "alertmanager-config")]["data"]["config.yml"])
    assert cfg["route"]["receiver"] == "default"
    assert {"pods"} == set(by_key[("Role", "prometheus")]["rules"][0]["resources"])
    assert by_key[("Deployment", "prometheus")]["spec"]["template"]["spec"]["serviceAccountName"] == "prometheus"
    prov = by_key[("ConfigMap", "grafana-provisioning")]
    assert "path: /var/lib/grafana/dashboards" in prov["data"]["dashboards.yaml"]
    assert "type: prometheus" in prov["data"]["datasources.yaml"]
    mounts = by_key[("Deployment", "grafana")]["spec"]["template"]["spec"]["containers"][0]["volumeMounts"]
    assert any("/etc/grafana/provisioning/datasources" in m["mountPath"] for m in mounts)
    bundle2 = build_bundle_from_values({"monitoring": {"enabled": True, "alertmanager_config": ""}})
    am = next(m for m in bundle2 if m["metadata"]["name"] == "alertmanager-config")
    assert "receivers" in am["data"]["config.yml"]
    assert to_yaml(bundle)


def test_install_storage_pvc_and_hostpath_pv():
    by_kind = {_key(m): m for m in build_bundle_from_values({"storage": {"enabled": True, "size": "25Gi"}})}
    assert by_kind[("PersistentVolumeClaim", "seldon-models")]["spec"]["resources"]["requests"]["storage"] == "25Gi"
    assert ("PersistentVolume", "seldon-models-seldon") not in by_kind
    spec = by_kind[PLATFORM]["spec"]["template"]["spec"]
    assert spec["volumes"][0]["persistentVolumeClaim"]["claimName"] == "seldon-models"
    assert spec["containers"][0]["volumeMounts"][0]["mountPath"] == "/var/seldon/models"
    by_kind = {_key(m): m for m in build_bundle_from_values({"storage": {"enabled": True,
                                                                         "host_path": "/mnt/models"}})}
    pv = by_kind[("PersistentVolume", "seldon-models-seldon")]
    assert pv["spec"]["hostPath"]["path"] == "/mnt/models" and pv["spec"]["claimRef"]["name"] == "seldon-models"
    assert by_kind[("PersistentVolumeClaim", "seldon-models")]["spec"]["storageClassName"] == ""
    bundle = build_bundle_from_values({})
    assert "PersistentVolumeClaim" not in {m["kind"] for m in bundle}
    assert "volumes" not in next(m for m in bundle if _key(m) == PLATFORM)["spec"]["template"]["spec"]


def test_install_autoscaling_hpa():
    bundle = build_bundle_from_values({"autoscaling": {"enabled": True, "min_replicas": 2, "max_replicas": 6},
                                       "redis": {"enabled": True}})
    hpa = next(m for m in bundle if m["kind"] == "HorizontalPodAutoscaler")
    assert hpa["spec"]["scaleTargetRef"]["name"] == "seldon-core-tpu-platform"
    assert (hpa["spec"]["minReplicas"], hpa["spec"]["maxReplicas"]) == (2, 6)
    assert hpa["spec"]["metrics"][0]["resource"]["target"]["averageUtilization"] == 80
    platform = next(m for m in bundle if _key(m) == PLATFORM)
    assert "replicas" not in platform["spec"]
    resources = platform["spec"]["template"]["spec"]["containers"][0]["resources"]
    assert resources["requests"]["cpu"] == "1" and resources["limits"]["nvidia.com/gpu"] == "1"
    with pytest.raises(ValueError, match="redis.enabled"):
        build_bundle_from_values({"autoscaling": {"enabled": True}})
    assert any(m["kind"] == "PodDisruptionBudget" for m in bundle)
    single = build_bundle_from_values({"autoscaling": {"enabled": True, "max_replicas": 1}})
    assert not any(m["kind"] == "PodDisruptionBudget" for m in single)
    bundle = build_bundle_from_values({})
    assert not any(m["kind"] in ("HorizontalPodAutoscaler", "PodDisruptionBudget") for m in bundle)
    assert next(m for m in bundle if _key(m) == PLATFORM)["spec"]["replicas"] == 1


def test_install_cli_writes_one_file_per_manifest(tmp_path):
    import subprocess
    import sys

    out = tmp_path / "bundle"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.tools.install", "--values",
                        os.path.join(REPO, "deploy", "values-production.yaml"), "-o", str(out)],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    files = sorted(p.name for p in out.iterdir())
    assert len(files) == len(build_bundle_from_values(_values("values-production.yaml")))
    platform = yaml.safe_load((out / "deployment-seldon-core-tpu-platform.yaml").read_text())
    assert platform["spec"]["template"]["spec"]["containers"][0]["resources"]["limits"]["nvidia.com/gpu"] == "8"
