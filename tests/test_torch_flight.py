"""The port's decode flight recorder, profiler and decode metrics against the
JAX package's.

``gpt_continuous_batching`` (cut to 4 slots and 12 new tokens) is served by
the JAX ``PredictorServer(fast_ingress=True)`` and the port's
``PredictorServer(device="cpu")`` with the same greedy requests: the ids
must be equal, and the flight frames' totals (tokens, admissions,
retirements) equal to each other and to what was served. SLO targets set
huge make every request meet its SLO, set tiny make every one breach, and
the attainment counters on ``/metrics`` then equal the request and token
counts. ``/decode/health`` carries the JAX package's keys,
``/decode/profile`` samples the decode loop's thread with ``?hz`` capped
at 200, and the recorder's and phase timer's costs stay within the JAX
guard test's budget.
"""

from __future__ import annotations

import asyncio
import json
import threading
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.telemetry import flight as jflight
from seldon_core_tpu_torch.telemetry import flight
from seldon_core_tpu_torch.telemetry.flight import FlightRecorder, PhaseTimer

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 4
MAX_NEW = 12
SEQ = 32
VOCAB = 256
BUDGETS = (12, 5, 9, 3, 12, 7)
OVERHEAD_BUDGET_US = 50.0  # tests/test_flight_recorder.py's guard


def _deployment(tmp_path: Path, name: str, **tpu) -> Path:
    dep = json.loads((ROOT / "seldon_core_tpu_torch" / "deployments" / "gpt_continuous_batching.json").read_text())
    dep["metadata"]["name"] = dep["spec"]["name"] = name
    pred = dep["spec"]["predictors"][0]
    pred["tpu"].update({"decode_slots": SLOTS, "max_batch": 4, "batch_buckets": [4], **tpu})
    for p in pred["graph"]["parameters"]:
        if p["name"] == "max_new_tokens":
            p["value"] = str(MAX_NEW)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(dep))
    return path


def _prompts():
    return np.random.default_rng(5).integers(0, VOCAB, (len(BUDGETS), SEQ)).astype(np.int32)


async def _post(port: int, path: str, body: bytes = b"", method: str = "POST"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nContent-Type: application/json\r\nContent-Length: {len(body)}\r\n"
                 f"Connection: close\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


async def _traffic(port: int) -> list:
    """Every prompt at once, each with its own budget: rows admit and retire
    at different rounds."""
    async def one(ids, n):
        body = {"meta": {"tags": {"max_new_tokens": n}}, "data": {"ndarray": [ids.tolist()]}}
        status, out = await _post(port, "/api/v0.1/predictions", json.dumps(body).encode())
        assert status == 200, out
        return json.loads(out)

    return await asyncio.gather(*(one(ids, n) for ids, n in zip(_prompts(), BUDGETS)))


def _metric(text: str, name: str, **labels) -> float:
    from prometheus_client.parser import text_string_to_metric_families

    total = 0.0
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name == name and all(s.labels.get(k) == v for k, v in labels.items()):
                total += s.value
    return total


class _Servers:
    def __init__(self, path: Path):
        self.path = path

    async def __aenter__(self):
        from seldon_core_tpu.graph.defaulting import default_deployment as jax_default
        from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
        from seldon_core_tpu.serving.server import PredictorServer as JaxServer
        from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

        dep = jax_default(JaxDeployment.from_dict(json.loads(self.path.read_text())), n_devices=1)
        self.jax = JaxServer(dep.spec.predictors[0], deployment_name=dep.spec.name)
        pred, name = load_predictor(str(self.path))
        self.port = PredictorServer(pred, deployment_name=name, device="cpu")
        self.name = name
        self.port.warmup()
        self.jax.decode_scheduler.warmup()
        await self.jax.start(host="127.0.0.1", port=0, grpc_port=None, fast_ingress=True)
        await self.port.start(host="127.0.0.1", port=0)
        self.ports = (self.jax._fast_server.sockets[0].getsockname()[1], self.port.port)
        return self

    async def __aexit__(self, *exc):
        await self.jax.stop()
        await self.port.stop()


def test_served_decode_flight_and_metrics_like_jax(tmp_path):
    async def run():
        async with _Servers(_deployment(tmp_path, "flight-cb")) as srv:
            jport, pport = srv.ports
            theirs, ours = await _traffic(jport), await _traffic(pport)
            ids = [o["data"]["ndarray"] for o in ours]
            assert ids == [o["data"]["ndarray"] for o in theirs]
            served_tokens = sum(sum(o["meta"]["tags"]["gen_lens"]) for o in ours)
            assert served_tokens == sum(BUDGETS)
            status, body = await _post(pport, "/decode/flight?n=4096", method="GET")
            assert status == 200
            agg = json.loads(body)["recorders"][srv.name]["aggregate"]
            jagg = jflight.recorders()[srv.name].aggregate()
            for key in ("tokens", "admitted", "retired"):
                assert agg[key] == jagg[key], key
            assert (agg["tokens"], agg["admitted"], agg["retired"]) == (served_tokens, len(BUDGETS), len(BUDGETS))
            frames = json.loads(body)["recorders"][srv.name]["frames"]
            assert sum(f["tokens"] for f in frames) == served_tokens
            assert sum(f.get("admitted", 0) for f in frames) == len(BUDGETS)
            # the phases split the gap; every family's readback is within its wall
            rec = flight.recorders()[srv.name]
            for f in rec.snapshot():
                assert sum(f.phase_ns) <= f.gap_ns
                assert all(0 <= r <= b for r, b in zip(f.rdb_ns, f.busy_ns))
            assert rec.busy_ns_total[flight.F_STEP] > 0 and rec.busy_ns_total[flight.F_CHUNK] > 0
            # /decode/health: the JAX package's keys
            status, body = await _post(pport, "/decode/health", method="GET")
            health = json.loads(body)[srv.name]
            assert set(health) == set(jflight.recorders()[srv.name].health())
            assert 0.0 < health["bubble_fraction"] < 1.0 and health["top_gap_phase"] in flight.PHASES
            # /metrics: steps, TTFT per row, ITL per later token, goodput
            _, text = await _post(pport, "/metrics", method="GET")
            text = text.decode()
            assert _metric(text, "seldon_tpu_decode_ttft_seconds_count") == len(BUDGETS)
            assert _metric(text, "seldon_tpu_decode_inter_token_seconds_count") == served_tokens - len(BUDGETS)
            assert _metric(text, "seldon_tpu_decode_goodput_tokens_total", outcome="met") == served_tokens
            assert _metric(text, "seldon_tpu_decode_round_device_seconds_count") == rec.rounds
            assert _metric(text, "seldon_tpu_xla_compile_seconds_count") == \
                sum(srv.port.decode_scheduler.compile_counts().values())
            assert srv.port.decode_scheduler.recompiles_since_warmup() == 0

    asyncio.run(run())


@pytest.mark.parametrize("slo_ms,outcome", [(1e9, "ok"), (1e-6, "breach")], ids=["huge", "tiny"])
def test_slo_attainment_all_met_or_all_breached(tmp_path, slo_ms, outcome):
    async def run():
        path = _deployment(tmp_path, f"flight-slo-{outcome}", decode_slo_ttft_ms=slo_ms, decode_slo_itl_ms=slo_ms)
        async with _Servers(path) as srv:
            for port in srv.ports:
                outs = await _traffic(port)
                verdict = "met" if outcome == "ok" else "breached"
                assert [o["meta"]["tags"]["slo"] for o in outs] == [[verdict]] * len(BUDGETS)
                _, text = await _post(port, "/metrics", method="GET")
                text = text.decode()
                n_itl = sum(BUDGETS) - len(BUDGETS)
                assert _metric(text, "seldon_tpu_decode_slo_attainment_total", kind="ttft",
                               outcome=outcome) == len(BUDGETS)
                assert _metric(text, "seldon_tpu_decode_slo_attainment_total", kind="itl", outcome=outcome) == n_itl
                other = "breach" if outcome == "ok" else "ok"
                assert _metric(text, "seldon_tpu_decode_slo_attainment_total", outcome=other) == 0
            rec = flight.recorders()[srv.name]
            good = rec.goodput()
            assert good["ttft_attainment"] == (1.0 if outcome == "ok" else 0.0)
            if outcome == "breach":
                # a breach dumps the recent ring into the span store
                assert rec.dumps >= 1

    asyncio.run(run())


def test_profiler_samples_the_decode_loop_and_caps_hz(tmp_path):
    from seldon_core_tpu_torch.telemetry import profile

    async def run():
        async with _Servers(_deployment(tmp_path, "flight-prof")) as srv:
            pport = srv.ports[1]
            status, body = await _post(pport, "/decode/profile?hz=1000", method="GET")
            assert status == 200 and json.loads(body)["hz"] == 200.0
            prof = profile.get_profiler()
            try:
                prof.clear()
                for _ in range(3):
                    await _traffic(pport)
                await asyncio.sleep(0.1)
                status, body = await _post(pport, "/decode/profile?n=5", method="GET")
                report = json.loads(body)
                assert report["running"] and report["samples"] > 0 and len(report["top"]) <= 5
                # the loop's thread is the one serving the event loop
                assert prof._target_ident == threading.get_ident()
            finally:
                prof.set_hz(profile._DEFAULT_HZ)  # the process-wide sampler

    asyncio.run(run())


def test_recorder_and_phase_timer_within_the_jax_guard_budget():
    assert FlightRecorder.measure_overhead(2000) < OVERHEAD_BUDGET_US
    assert PhaseTimer.measure_overhead(2000) < OVERHEAD_BUDGET_US


def test_kill_switch_keeps_ids_and_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("ENGINE_FLIGHT", "off")

    async def run():
        from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

        pred, name = load_predictor(str(_deployment(tmp_path, "flight-off")))
        server = PredictorServer(pred, deployment_name=name, device="cpu")
        server.warmup()
        await server.start(host="127.0.0.1", port=0)
        try:
            outs = await _traffic(server.port)
            assert [sum(o["meta"]["tags"]["gen_lens"]) for o in outs] == list(BUDGETS)
            rec = server.decode_scheduler.flight
            assert not rec.enabled and rec.rounds == 0
        finally:
            await server.stop()

    asyncio.run(run())


def test_speculative_rounds_commit_their_accepts(tmp_path):
    """Chain speculation: the frames' accepted/proposed totals are the
    scheduler's own counters and the spec metrics on /metrics."""
    async def run():
        from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

        pred, name = load_predictor(str(ROOT / "seldon_core_tpu_torch" / "deployments" / "tiny_gpt_speculative.json"))
        server = PredictorServer(pred, deployment_name=name, device="cpu")
        server.warmup()
        await server.start(host="127.0.0.1", port=0)
        try:
            seq = server.decode_scheduler.seq_len
            rng = np.random.default_rng(3)
            for _ in range(3):
                body = {"meta": {"tags": {"max_new_tokens": 8}},
                        "data": {"ndarray": rng.integers(0, 64, (2, seq)).tolist()}}
                status, out = await _post(server.port, "/api/v0.1/predictions", json.dumps(body).encode())
                assert status == 200, out
            sched = server.decode_scheduler
            rec = sched.flight
            assert rec.mode_rounds.get("chain", 0) == sched.stat_spec_dispatches > 0
            assert (rec.accepted_total, rec.proposed_total) == (sched.stat_spec_accepted, sched.stat_spec_proposed)
            assert rec.busy_ns_total[flight.F_DRAFT] > 0 and rec.busy_ns_total[flight.F_VERIFY] > 0
            _, text = await _post(server.port, "/metrics", method="GET")
            text = text.decode()
            assert _metric(text, "seldon_tpu_decode_spec_accepted_total") == sched.stat_spec_accepted
            assert _metric(text, "seldon_tpu_decode_spec_proposed_total") == sched.stat_spec_proposed
            assert "spec" in rec.health()
        finally:
            await server.stop()

    asyncio.run(run())
