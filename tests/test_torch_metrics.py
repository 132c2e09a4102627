"""The port's metrics registry against the JAX package's.

The same hook calls go through ``seldon_core_tpu.metrics.registry.Metrics``
(prometheus_client, on its own registry) and the port's
``seldon_core_tpu_torch.metrics.registry.Metrics`` (its own counters and
expositions); both texts are parsed by prometheus_client's parsers and must
agree family for family, label set for label set and sample for sample
(``_created`` timestamps aside) to 1e-9, and the OpenMetrics exemplars must
carry the same trace ids. The port must also serve /metrics where
prometheus_client cannot be imported, as on the card's host.
"""

from __future__ import annotations

import ast
import asyncio
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

prom = pytest.importorskip("prometheus_client")
from prometheus_client.openmetrics.parser import text_string_to_metric_families as om_families  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families as text_families  # noqa: E402
from prometheus_client.utils import floatToGoString  # noqa: E402

from seldon_core_tpu.metrics.registry import Metrics as JaxMetrics  # noqa: E402
from seldon_core_tpu.metrics.registry import MetricsResilienceEvents as JaxEvents  # noqa: E402
from seldon_core_tpu_torch.metrics.registry import (  # noqa: E402
    Metrics,
    MetricsResilienceEvents,
    NullMetrics,
    _go_float,
    get_metrics,
    run_loop_lag_probe,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
TRACE_A = "0af7651916cd43dd8448eb211c80319c"
TRACE_B = "4bf92f3577b34da6a3ce929d0e0e4736"

# families of features the port does not serve yet: registered by the JAX
# package only, and never moved by the hooks below (none since
# tensor-parallel decode, the last, was ported)
WAITING_FAMILIES: set = set()


def drive(m) -> None:
    """One call of every hook the port serves, several with labels that
    repeat, latencies across the bucket ladder and a negative reward."""
    for dt, tid in ((0.0004, TRACE_A), (0.003, None), (0.7, TRACE_B), (7.5, None)):
        m.ingress_request("iris", "predict", dt, trace_id=tid)
    m.ingress_request("iris", "feedback", 0.002, trace_id=TRACE_A)
    m.ingress_request("iris", "predict", 0.01, trace_id="x" * 200)  # past the exemplar limit: no exemplar
    m.ingress_error("iris", "predict", 103)
    m.ingress_error("iris", "predict", 103)
    m.ingress_error("iris", "feedback", 101)
    m.unit_call("iris", "default", "iris-primary", "transform_input", 0.0021)
    m.unit_call("iris", "default", "router", "route", 0.00001)
    m.feedback("iris", "default", "router", 1.0)
    m.feedback("iris", "default", "router", -0.25)
    m.batch("iris", 3, [0.001, 0.0005, 0.004])
    m.batch("iris", 1, 0.002)
    m.decode_step("gpt", 3, 8)
    m.decode_step("gpt", 0, 0)
    m.decode_kv_per_device("gpt", 4, 2)
    m.decode_ttft("gpt", 0.02)
    m.decode_inter_token("gpt", 0.004)
    m.decode_spec("gpt", 8, 5, 7)
    m.decode_spec("gpt", 6, 2, 4, mode="tree")
    m.decode_spec_tree("gpt", 5, 2)
    m.decode_prefix("gpt", True, 12)
    m.decode_prefix("gpt", False, 0)
    m.decode_prefix_evicted("gpt")
    m.decode_ttft_split("gpt", 0.01, "warm")
    m.decode_kv_pool("gpt", 10, 4, 2)
    m.decode_kv_shared("gpt", 3)
    m.decode_kv_shared("gpt", 0)
    m.decode_kv_cow("gpt", 2)
    m.decode_kv_reclaimed("gpt", 1)
    m.decode_kv_tier_bytes("gpt", "host", 4096)
    m.decode_kv_tier_bytes("gpt", "store", 0)
    m.decode_kv_demotion("gpt", "host", 2)
    m.decode_kv_demotion("gpt", "store", 0)
    m.decode_kv_promotion("gpt", "store", 1)
    m.decode_kv_sibling_pull("gpt", "hit")
    m.decode_kv_sibling_pull("gpt", "miss")
    m.decode_kv_sibling_pull("gpt", "hit")
    m.decode_round("gpt", 0.0007, 0.0002)
    m.decode_bubble("gpt", 0.21)
    m.decode_goodput("gpt", 9, True)
    m.decode_goodput("gpt", 4, False)
    m.decode_slo("gpt", "ttft", True)
    m.decode_slo("gpt", "itl", False, trace_id=TRACE_B)
    m.compile("gpt", 8, 1.25)
    m.router_route("gpt", "affinity", "affinity")
    m.router_route("gpt", "affinity", "affinity")
    m.router_route("gpt", "affinity", "shed")
    m.router_queue_depth("gpt", 0, 3)
    m.router_queue_depth("gpt", 1, 0)
    m.router_arm("gpt", 0, 0.5)
    m.router_replicas("gpt", 2)
    m.router_replicas("gpt", 3)
    m.router_preseed("gpt", 4)
    for state in ("up", "evicted", "up", "draining", "down"):
        m.replica_state("gpt", 1, state)
    for fn in ("replica_eviction", "replica_recovery", "replica_drain", "replica_boot_failure",
               "replica_spill_failure"):
        getattr(m, fn)("gpt")
    m.replica_migration("gpt", 2)
    m.replica_migration("gpt", 0)
    m.loop_lag(2.5)
    m.loop_lag(1.0)
    m.retry("iris", "iris-primary")
    m.breaker("iris", "iris-primary", "open")
    m.breaker("iris", "iris-primary", "half_open")
    m.deadline_exceeded("iris", "ingress")
    m.degraded("iris", "router_fallback")
    m.fault_injected("iris", "iris-primary", "error")
    m.shadow_compare("iris-shadow", "main", "candidate", True)
    m.shadow_compare("iris-shadow", "main", "candidate", False)
    m.shadow_compare("iris-shadow", "main", "candidate", False)


def families(text: str, openmetrics: bool) -> dict:
    parse = om_families if openmetrics else text_families
    out = {}
    for fam in parse(text):
        samples = {}
        for s in fam.samples:
            key = (s.name, tuple(sorted(s.labels.items())))
            samples[key] = (s.value, s.exemplar)
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


def _equal_families(jax_text: str, port_text: str, openmetrics: bool) -> None:
    jax_f, port_f = families(jax_text, openmetrics), families(port_text, openmetrics)
    missing = set(jax_f) - set(port_f)
    # the text format lists a family's _created series as a family of its own
    assert {m.removesuffix("_created") for m in missing} == WAITING_FAMILIES
    for name in missing:
        assert not jax_f[name][2], f"{name} moved on the JAX side"
    assert set(port_f) <= set(jax_f)
    for name, (kind, doc, samples) in port_f.items():
        jkind, jdoc, jsamples = jax_f[name]
        assert (kind, doc) == (jkind, jdoc), name
        assert set(samples) == set(jsamples), name
        for key, (value, exemplar) in samples.items():
            jvalue, jexemplar = jsamples[key]
            if key[0].endswith("_created"):
                continue  # a creation timestamp
            assert math.isclose(value, jvalue, rel_tol=0, abs_tol=TOL), (key, value, jvalue)
            assert (exemplar is None) == (jexemplar is None), key
            if exemplar is not None:
                assert exemplar.labels == jexemplar.labels, key
                assert math.isclose(exemplar.value, jexemplar.value, abs_tol=TOL), key


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text_0_0_4", "openmetrics"])
def test_hooks_expose_what_the_jax_registry_exposes(openmetrics):
    jax_m, port_m = JaxMetrics(), Metrics()
    drive(jax_m)
    drive(port_m)
    export = "export_openmetrics" if openmetrics else "export"
    jax_text = getattr(jax_m, export)().decode()
    port_text = getattr(port_m, export)().decode()
    _equal_families(jax_text, port_text, openmetrics)
    if openmetrics:
        ids = {e.labels["trace_id"] for _, _, ss in families(port_text, True).values()
               for _, e in ss.values() if e is not None}
        assert ids == {TRACE_A, TRACE_B}


def test_expositions_match_prometheus_client_line_for_line():
    """Past the parsers: the texts themselves agree, once the creation and
    exemplar timestamps are masked and the waiting families dropped."""
    import re

    jax_m, port_m = JaxMetrics(), Metrics()
    drive(jax_m)
    drive(port_m)

    def lines(text: str) -> list[str]:
        text = re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)
        text = re.sub(r"(# \{[^}]*\} \S+) \S+$", r"\1 T", text, flags=re.M)
        return [ln for ln in text.splitlines() if not any(f in ln for f in WAITING_FAMILIES)]

    for export in ("export", "export_openmetrics"):
        assert lines(getattr(port_m, export)().decode()) == lines(getattr(jax_m, export)().decode())


@settings(max_examples=300, deadline=None)
@given(st.one_of(st.floats(allow_nan=True, allow_infinity=True), st.integers(-10**12, 10**12)))
def test_sample_values_print_as_prometheus_client_prints_them(x):
    assert _go_float(x) == floatToGoString(x)


def test_every_jax_hook_is_there_and_the_waiting_ones_record_nothing():
    from seldon_core_tpu.metrics.registry import NullMetrics as JaxNull

    hooks = {n for n in dir(JaxNull) if not n.startswith("_")}
    assert hooks <= {n for n in dir(Metrics) if not n.startswith("_")}
    m = Metrics()
    before = m.export()
    assert not WAITING_FAMILIES  # every hook is served: none records nothing
    m.decode_kv_per_device("gpt", 4, 1)  # tensor-parallel decode, served since it was ported
    assert b'seldon_tpu_decode_kv_pages_per_device{deployment_name="gpt",tp="1"} 4.0' in m.export()
    before = m.export()
    m.router_route("gpt", "affinity", "shed")  # the fleet's, served since it was ported
    assert m.export() != before


def test_resilience_events_reach_the_same_families():
    jax_m, port_m = JaxMetrics(), Metrics()
    for ev in (JaxEvents(jax_m, "dep"), MetricsResilienceEvents(port_m, "dep")):
        ev.retry("a", 1)
        ev.breaker_transition("a", "open")
        ev.breaker_transition("a", "closed")
        ev.deadline_exceeded("a")
        ev.degraded("r", "quorum")
        ev.fault_injected("a", "timeout")
    _equal_families(jax_m.export().decode(), port_m.export().decode(), False)


def test_metrics_off_and_loop_lag_probe():
    assert isinstance(get_metrics(False), NullMetrics) and get_metrics(False).export() == b""
    m = get_metrics(True)

    async def run():
        task = asyncio.ensure_future(run_loop_lag_probe(m, interval_s=0.0, sample_s=0.001))
        await asyncio.sleep(0.05)
        task.cancel()

    asyncio.run(run())
    fam = families(m.export().decode(), False)
    assert fam["seldon_tpu_event_loop_lag_max_ms"][2][("seldon_tpu_event_loop_lag_max_ms", ())][0] > 0


_BLOCKED_SERVER = r"""
import asyncio, json, sys
sys.modules["prometheus_client"] = None  # what the card's host lacks
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

async def main():
    pred, name = load_predictor(sys.argv[1])
    server = PredictorServer(pred, deployment_name=name, device="cpu")
    server.warmup()
    await server.start(host="127.0.0.1", port=0)
    async def get(path, body=None):
        r, w = await asyncio.open_connection("127.0.0.1", server.port)
        method = "POST" if body is not None else "GET"
        body = body or b""
        w.write(f"{method} {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        raw = await r.read()
        w.close()
        return raw.split(b"\r\n\r\n", 1)[1].decode()
    await get("/api/v0.1/predictions", json.dumps({"data": {"ndarray": [[1, 2, 3, 4]]}}).encode())
    out = {"text": await get("/metrics"), "om": await get("/prometheus?format=openmetrics"),
           "imported": sorted(m for m, mod in sys.modules.items()
                               if mod is not None and m.startswith(("prometheus_client", "jax", "seldon_core_tpu.")))}
    await server.stop()
    print(json.dumps(out))

asyncio.run(main())
"""


def test_metrics_served_without_prometheus_client():
    """The card's host has no prometheus_client: /metrics must be there all
    the same, and parse."""
    dep = ROOT / "seldon_core_tpu_torch" / "deployments" / "iris.json"
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SERVER, str(dep)], capture_output=True, text=True,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["imported"] == []
    text = families(out["text"], False)
    om = families(out["om"], True)
    key = ("seldon_api_ingress_server_requests_duration_seconds_count",
           (("deployment_name", "iris"), ("method", "predict")))
    assert text["seldon_api_ingress_server_requests_duration_seconds"][2][key][0] == 1.0
    assert om["seldon_api_ingress_server_requests_duration_seconds"][2][key][0] == 1.0
    assert out["om"].endswith("# EOF\n")


def test_port_never_imports_jax_or_prometheus_client():
    """No module of the port imports jax, the JAX package or
    prometheus_client (a parse of every import statement)."""
    bad = []
    for path in (ROOT / "seldon_core_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "prometheus_client", "seldon_core_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert bad == []
