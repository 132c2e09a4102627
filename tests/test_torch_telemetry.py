"""The port's request tracing against the JAX package's.

- W3C ``traceparent`` parse and format: a table of valid and malformed
  headers and a round-trip property, with both packages giving equal
  results;
- the same span sequence built through both packages' context API gives
  equal trees (names, parentage, attributes, events, error flags);
- with one seed, both stores keep and drop the same traces;
- served on the CPU: the JAX ``PredictorServer(fast_ingress=True)`` and the
  port's ``PredictorServer(device="cpu")`` answer the same requests on
  iris, the A/B router and the fallback/breaker deployment with a planted
  fault; each request's trace tree has the same span names and parent
  structure in both, its trace id continues the request's header, and the
  two ``/metrics`` carry equal counts; a malformed ``?n`` gets the same
  400 body as the JAX operator API.
"""

from __future__ import annotations

import asyncio
import json
import random
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import seldon_core_tpu.telemetry as jtel
from seldon_core_tpu.telemetry.store import SpanStore as JaxStore
from seldon_core_tpu_torch import telemetry as tel
from seldon_core_tpu_torch.telemetry.store import SpanStore

ROOT = Path(__file__).resolve().parents[1]
HEADER_TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
HEADER_PARENT = "00f067aa0ba902b7"
HEADER = f"00-{HEADER_TRACE}-{HEADER_PARENT}-01"

TRACEPARENTS = [
    HEADER,
    HEADER.upper(),
    f"  {HEADER}  ",
    f"ff-{HEADER_TRACE}-{HEADER_PARENT}-00",
    f"00-{'0' * 32}-{HEADER_PARENT}-01",  # zero trace id
    f"00-{HEADER_TRACE}-{'0' * 16}-01",  # zero parent
    f"00-{HEADER_TRACE[:-1]}-{HEADER_PARENT}-01",  # short trace id
    f"00-{HEADER_TRACE}-{HEADER_PARENT}",  # no flags
    f"00-{HEADER_TRACE}x-{HEADER_PARENT}-01",
    f"00_{HEADER_TRACE}_{HEADER_PARENT}_01",
    "",
    "garbage",
    None,
    42,
    b"00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
]


@pytest.mark.parametrize("header", TRACEPARENTS, ids=range(len(TRACEPARENTS)))
def test_traceparent_parse_like_jax(header):
    assert tel.parse_traceparent(header) == jtel.parse_traceparent(header)
    if header == HEADER:
        assert tel.parse_traceparent(header) == (HEADER_TRACE, HEADER_PARENT)


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="0123456789abcdef", min_size=32, max_size=32),
       st.text(alphabet="0123456789abcdef", min_size=16, max_size=16),
       st.text(max_size=60))
def test_traceparent_round_trip_like_jax(trace_id, span_id, noise):
    """A buf/span pair formats to a header that parses back to its ids (or
    to None for the all-zero ids W3C reserves), in both packages; arbitrary
    text parses the same in both."""
    for mod, spans in ((tel, tel.spans), (jtel, jtel.spans)):
        buf = spans.TraceBuf(trace_id)
        root = buf.begin("ingress")
        root.span_id = span_id
        token = mod.TRACE.set((mod.TraceContext(buf, root),))
        try:
            header = mod.traceparent()
        finally:
            mod.TRACE.reset(token)
        want = None if trace_id == "0" * 32 or span_id == "0" * 16 else (trace_id, span_id)
        assert mod.parse_traceparent(header) == want
    assert tel.parse_traceparent(noise) == jtel.parse_traceparent(noise)


def _build_tree(mod) -> list:
    """One request's span sequence: a root continuing a header, nested
    spans, a batcher-style child context, events, and a failing child."""
    tracer = mod.Tracer(store=(SpanStore if mod is tel else JaxStore)(sample_rate=1.0))
    buf, root, token = tracer.begin_request("ingress", puid="p1", parent=HEADER, attrs={"method": "predict"})
    with mod.span("router.route", {"unit": "router", "method": "route"}):
        mod.add_event("retry", {"unit": "router", "attempt": 1})
        h = mod.begin_spans("iris.transform_input", {"unit": "iris", "method": "transform_input", "attempt": 1})
        mod.end_spans(h)
    ctxs, spans = mod.child_contexts(mod.current_contexts(), "batcher", {"rows": 2, "mates": 1})
    t = mod.TRACE.set(ctxs)
    try:
        with pytest.raises(RuntimeError):
            with mod.span("fails"):
                mod.mark("degraded")
                raise RuntimeError("planted")
    finally:
        mod.TRACE.reset(t)
    for s in spans:
        s.end()
    tracer.finish_request(buf, root, token)
    rec = tracer.store.get("p1")
    assert rec is not None and rec.trace_id == HEADER_TRACE
    return _shape(rec.to_dict()["trace"]), sorted(rec.flags)


def _shape(spans: list[dict]) -> list:
    """Spans as (name, parent name, attrs, events, error), parent by name
    (ids are random), in start order; timings dropped."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    out = []
    for s in spans:
        events = [(e["name"], e.get("attrs")) for e in s.get("events", [])]
        out.append((s["name"], by_id.get(s["parent_id"], s["parent_id"]), s.get("attrs"), events,
                    s.get("error", False)))
    return sorted(out, key=repr)


def test_span_trees_equal_jax():
    ours, theirs = _build_tree(tel), _build_tree(jtel)
    assert ours == theirs
    names = [s[0] for s in ours[0]]
    assert sorted(names) == ["batcher", "fails", "ingress", "iris.transform_input", "router.route"]
    # the root continues the header's parent span
    assert ("ingress", HEADER_PARENT) in [(s[0], s[1]) for s in ours[0]]


def _offer_sequence(mod, store_cls) -> tuple:
    """A stream of traces: forced, errored, deadline, fast and slow ok
    ones; returns the store's decisions and what it retained."""
    store = store_cls(max_errors=4, slow_keep=3, max_sampled=5, sample_rate=0.3, seed=7)
    rng = random.Random(11)
    decisions = []
    for i in range(60):
        buf = mod.spans.TraceBuf(f"{i:032x}", puid=f"r{i}")
        root = buf.begin("ingress", start_ns=0)
        root.end(int(rng.uniform(0.1, 50) * 1e6))
        kind = i % 7
        if kind == 0:
            buf.flags.add("forced")
        elif kind == 3:
            buf.flags.add("error")
        elif kind == 5:
            buf.flags.add("deadline")
        decisions.append(store.offer(buf))
    kept = sorted(r.trace_id for r in store.list(n=100))
    return decisions, kept, store.stats()


def test_store_keeps_and_drops_like_jax():
    ours = _offer_sequence(tel, SpanStore)
    theirs = _offer_sequence(jtel, JaxStore)
    assert ours == theirs
    assert 0 < sum(ours[0]) < len(ours[0])


# --------------------------------------------------------- served on the CPU


async def _http(port: int, method: str, path: str, body: bytes = b"", headers: dict | None = None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n{extra}"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


class _Pair:
    """The JAX server and the port's, on one deployment file, each with a
    fresh global tracer that keeps every trace."""

    def __init__(self, name: str, faults: dict | None = None):
        self.name = name
        self.faults = faults or {}

    async def __aenter__(self):
        from seldon_core_tpu.graph.defaulting import default_deployment as jax_default
        from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
        from seldon_core_tpu.serving.server import PredictorServer as JaxServer
        from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

        jtel.configure(jtel.Tracer(store=JaxStore(sample_rate=1.0)))
        tel.configure(tel.Tracer(store=SpanStore(sample_rate=1.0)))
        dep = jax_default(JaxDeployment.from_dict(json.loads(
            (ROOT / "examples" / "deployments" / f"{self.name}.json").read_text())), n_devices=1)
        self.jax = JaxServer(dep.spec.predictors[0], deployment_name=dep.spec.name)
        pred, dep_name = load_predictor(str(ROOT / "seldon_core_tpu_torch" / "deployments" / f"{self.name}.json"))
        self.port = PredictorServer(pred, deployment_name=dep_name, device="cpu")
        if self.faults:
            from seldon_core_tpu.engine import faults as jax_faults
            from seldon_core_tpu_torch.engine import faults

            jax_faults.install_faults(self.jax.executor, {
                k: jax_faults.FaultSpec(**v) for k, v in self.faults.items()})
            faults.install_faults(self.port.executor, {k: faults.FaultSpec(**v) for k, v in self.faults.items()})
        await self.jax.start(host="127.0.0.1", port=0, grpc_port=None, fast_ingress=True)
        await self.port.start(host="127.0.0.1", port=0)
        self.ports = (self.jax._fast_server.sockets[0].getsockname()[1], self.port.port)
        return self

    async def __aexit__(self, *exc):
        await self.jax.stop()
        await self.port.stop()

    async def both(self, method, path, body=b"", headers=None):
        return [await _http(p, method, path, body, headers) for p in self.ports]


def _tree(rec: dict) -> list:
    """(name, parent name) of every span, parent by name, sorted."""
    spans = rec["trace"]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"], "<remote>" if s["parent_id"] else "")) for s in spans)


COUNTED = (
    "seldon_api_ingress_server_requests_duration_seconds_count",
    "seldon_api_engine_client_requests_duration_seconds_count",
    "seldon_tpu_batch_size_count",
    "seldon_tpu_batch_size_sum",
    "seldon_tpu_batch_queue_wait_seconds_count",
    "seldon_api_model_feedback_total",
    "seldon_api_model_feedback_reward",
    "seldon_api_ingress_server_errors_total",
    "seldon_tpu_retries_total",
    "seldon_tpu_breaker_transitions_total",
    "seldon_tpu_breaker_state",
    "seldon_tpu_degraded_responses_total",
    "seldon_tpu_faults_injected_total",
    "seldon_tpu_deadline_exceeded_total",
)


def counts(text: str) -> dict:
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name in COUNTED:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _rows(seed: int, n: int = 1):
    return np.random.default_rng(seed).uniform(0, 5, size=(n, 4)).round(3).tolist()


async def _serve_and_compare(pair: _Pair, requests: list, feedback: bool = False) -> dict:
    # a trace that continues a caller's header is a fragment whose keep
    # decision belongs to the caller: it pends in both stores unless the
    # request is flagged, so every header request here is tagged too
    (sj, _), (sp, _) = await pair.both(
        "POST", "/api/v0.1/predictions", json.dumps({"data": {"ndarray": _rows(99)}}).encode(),
        {"traceparent": HEADER})
    assert sj == sp
    assert tel.get_tracer().store.stats() == jtel.get_tracer().store.stats()
    if not pair.faults:  # a faulted request is flagged degraded, and kept
        assert tel.get_tracer().store.stats()["retained"] == 0
    puids = []
    for i, (rows, tags, with_header) in enumerate(requests):
        if with_header:
            tags = {**tags, "trace": 1}
        body = {"data": {"ndarray": rows}, "meta": {"puid": f"{pair.name}-{i}", "tags": tags}}
        # one trace id per request: fragments of one trace id merge
        trace_id = f"{0xabc0 + i:032x}"
        headers = {"traceparent": f"00-{trace_id}-{HEADER_PARENT}-01"} if with_header else None
        (sj, bj), (sp, bp) = await pair.both("POST", "/api/v0.1/predictions", json.dumps(body).encode(), headers)
        assert sj == sp, (bj, bp)
        oj, op = json.loads(bj), json.loads(bp)
        if sj == 200:
            assert oj["meta"].get("routing") == op["meta"].get("routing")
            assert oj["meta"].get("tags", {}).get("degraded") == op["meta"].get("tags", {}).get("degraded")
            # the zoo's random weights differ between the packages: shapes only
            assert np.shape(op["data"]["ndarray"]) == np.shape(oj["data"]["ndarray"])
            if "trace" in tags:
                # the opt-in tag: per-unit spans back in meta.tags.trace
                assert [(s["unit"], s["method"]) for s in op["meta"]["tags"]["trace"]] == \
                       [(s["unit"], s["method"]) for s in oj["meta"]["tags"]["trace"]]
            if feedback:
                fb = json.dumps({"response": {"meta": {"routing": op["meta"]["routing"]}}, "reward": 1.0 - i / 4})
                # under the request's header, the feedback's spans join its trace
                (fj, _), (fp, _) = await pair.both("POST", "/api/v0.1/feedback", fb.encode(), headers)
                assert fj == fp == 200
        puids.append((f"{pair.name}-{i}", trace_id if with_header else None, "trace" in tags))
    for puid, header_trace, tagged in puids:
        rec = tel.get_tracer().store.get(puid)
        jrec = jtel.get_tracer().store.get(puid)
        assert (rec is None) == (jrec is None), puid
        if rec is None:
            assert not tagged  # an untagged request may fall to the sampler
            continue
        status, body = await _http(pair.ports[1], "GET", f"/traces/{puid}")
        assert status == 200
        served = json.loads(body)
        assert served == json.loads(json.dumps(rec.to_dict()))
        assert _tree(served) == _tree(jrec.to_dict()), puid
        if header_trace is not None:
            assert served["trace_id"] == header_trace
            root = next(s for s in served["trace"] if s["name"] == "ingress")
            assert root["parent_id"] == HEADER_PARENT
        for s in served["trace"]:  # every child inside its parent's interval
            parent = next((p for p in served["trace"] if p["span_id"] == s["parent_id"]), None)
            if parent is not None:
                assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], s["name"]
    (sj, mj), (sp, mp) = await pair.both("GET", "/metrics")
    assert sj == sp == 200
    theirs, ours = counts(mj.decode()), counts(mp.decode())
    assert ours == theirs
    return ours


def test_iris_traces_and_metrics_like_jax():
    async def run():
        async with _Pair("iris") as pair:
            reqs = [(_rows(i, 1 + i % 2), {"trace": 1} if i % 2 else {}, i % 3 == 0) for i in range(6)]
            got = await _serve_and_compare(pair, reqs)
            key = ("seldon_api_ingress_server_requests_duration_seconds_count",
                   (("deployment_name", "iris"), ("method", "predict")))
            assert got[key] == len(reqs) + 1  # and the untagged header request
            # the list route and a miss
            status, body = await _http(pair.ports[1], "GET", "/traces?sort=slow&n=3")
            listed = json.loads(body)
            assert status == 200 and len(listed["traces"]) == 3 and listed["stats"]["retained"] >= 6
            assert (await _http(pair.ports[1], "GET", "/traces/nope"))[0] == 404

    asyncio.run(run())


def test_ab_router_traces_feedback_and_metrics_like_jax():
    async def run():
        async with _Pair("iris_abtest") as pair:
            reqs = [(_rows(10 + i), {"trace": 1} if i == 2 else {}, i % 2 == 0) for i in range(8)]
            got = await _serve_and_compare(pair, reqs, feedback=True)
            assert any(k[0] == "seldon_api_model_feedback_total" for k in got)

    asyncio.run(run())


def test_fallback_breaker_with_planted_fault_like_jax():
    async def run():
        async with _Pair("iris_fallback_breaker", {"iris-primary": {"error_rate": 1.0, "seed": 5}}) as pair:
            reqs = [(_rows(20 + i), {"trace": 1} if i in (0, 5) else {}, i % 2 == 1) for i in range(8)]
            got = await _serve_and_compare(pair, reqs)
            names = {k[0] for k in got}
            for fam in ("seldon_tpu_retries_total", "seldon_tpu_breaker_state", "seldon_tpu_degraded_responses_total",
                        "seldon_tpu_faults_injected_total"):
                assert fam in names, fam
            # the first request's trace shows what the resilience layer did
            rec = tel.get_tracer().store.get("iris_fallback_breaker-0").to_dict()
            events = {e["name"] for s in rec["trace"] for e in s.get("events", [])}
            assert {"retry", "fault_injected", "degraded"} <= events
            assert "degraded" in rec["flags"]

    asyncio.run(run())


@pytest.mark.parametrize("url", [
    "/decode/flight?n=0", "/decode/flight?n=abc", "/decode/flight?window=1.5", "/decode/profile?n=zero",
    "/decode/profile?hz=-5",
])
def test_malformed_query_gets_the_jax_operator_400(url):
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.operator.api import add_operator_routes
    from seldon_core_tpu.operator.reconciler import DeploymentManager
    from seldon_core_tpu_torch.serving import wire

    async def run():
        app = web.Application()
        add_operator_routes(app, DeploymentManager())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get(url)
            theirs = (r.status, await r.json())
        finally:
            await client.close()
        path, _, query = url.partition("?")
        handler = {"/decode/flight": wire.decode_flight, "/decode/profile": wire.decode_profile}[path]
        resp = handler(wire.WireRequest("GET", path, {}, b"", query))
        assert (resp.status, json.loads(resp.body)) == theirs
        assert theirs[0] == 400

    asyncio.run(run())
