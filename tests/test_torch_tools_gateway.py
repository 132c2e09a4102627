"""The tools that need the gateway, on the CPU:

- ``tools/contract.py``: ``generate_batch`` equal to the JAX package's for
  every contract under ``seldon_core_tpu_torch/examples/models/`` at two
  seeds; ``run`` against a served microservice, directly and through the
  gateway (a ``RemoteBackend`` in front of it) with ``--oauth-key``; and
  with ``--grpc`` against a gRPC-only microservice, directly and through
  the gRPC gateway in front of an engine whose unit reaches it over gRPC
  (the token as ``oauth_token`` metadata);
- ``tools/audit_tail.py`` reading back what the gateway's ``file://``
  sink wrote (``tests/test_tools.py``'s case on the port: client
  attribution, torn and corrupt lines, truncation under ``--follow``),
  the served pairs equal to what was sent and received; its ``kafka://``
  half against the JAX package's over a stub ``kafka`` client;
- ``tools/loadtest.py`` with ``oauth_key`` through the gateway, counting
  only 200s.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.tools import contract as jax_contract
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.gateway import (
    DeploymentStore,
    Gateway,
    JsonlAuditSink,
    OAuthProvider,
    RemoteBackend,
    make_audit_sink,
)
from seldon_core_tpu_torch.graph.spec import DeploymentSpec
from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
from seldon_core_tpu_torch.serving.http_client import HttpPool
from seldon_core_tpu_torch.serving.microservice import load_user_object, serve_microservice
from seldon_core_tpu_torch.serving.server import load_predictor
from seldon_core_tpu_torch.tools import audit_tail, contract, loadtest
from seldon_core_tpu_torch.tools.stack import build_gateway_stack

ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "seldon_core_tpu_torch" / "examples" / "models"
CONTRACTS = sorted(p.parent.name for p in MODELS.glob("*/contract.json"))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("model", CONTRACTS)
def test_generate_batch_matches_jax(model, seed):
    spec = json.loads((MODELS / model / "contract.json").read_text())
    names, batch = contract.generate_batch(spec, 3, np.random.default_rng(seed))
    jnames, jbatch = jax_contract.generate_batch(spec, 3, np.random.default_rng(seed))
    assert names == jnames
    if isinstance(jbatch, np.ndarray):
        assert batch.dtype == jbatch.dtype
        np.testing.assert_array_equal(batch, jbatch)
    else:
        assert batch == jbatch


async def test_contract_cli_refuses_grpc(capsys):
    """--grpc is served: each batch of the MeanClassifier contract answered
    over Seldon.Predict, directly by a gRPC-only microservice and through
    the gRPC gateway (token from the REST gateway's /oauth/token, sent as
    oauth_token metadata) in front of an engine whose GRPC unit reaches
    the microservice; equal answers both ways; refused credentials fail."""
    from urllib.error import HTTPError

    from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    spec = json.loads((MODELS / "mean_classifier" / "contract.json").read_text())
    user = load_user_object("MeanClassifier", str(MODELS / "mean_classifier"))
    ms = await serve_microservice(user, "MeanClassifier", "MODEL", host="127.0.0.1", grpc_port=0, enable_rest=False)
    mport = ms.grpc_server.bound_port
    predictor = PredictorSpec.from_dict({"name": "p", "graph": {"name": "mean", "type": "MODEL", "endpoint": {
        "service_host": "127.0.0.1", "service_port": mport, "type": "GRPC"}}})
    server, gw, _, _ = build_gateway_stack(predictor, deployment_name="mean", oauth_key="mk", oauth_secret="ms",
                                           device="cpu")
    ggrpc = await start_gateway_grpc(gw, "127.0.0.1", 0)
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    gport = gws.sockets[0].getsockname()[1]
    try:
        direct = await asyncio.to_thread(contract.run, spec, "127.0.0.1", mport, rounds=3, batch_size=4, seed=1,
                                         use_grpc=True)
        gated = await asyncio.to_thread(contract.run, spec, "127.0.0.1", ggrpc.bound_port, rounds=3, batch_size=4,
                                        seed=1, use_grpc=True, oauth_key="mk", oauth_secret="ms", oauth_port=gport)
        rng = np.random.default_rng(1)
        for d, g in zip(direct, gated):
            _, x = contract.generate_batch(spec, 4, rng)
            want = 1.0 / (1.0 + np.exp(-np.mean(x, axis=1, keepdims=True)))
            for out in (d, g):
                assert out["data"]["names"] == ["proba"]
                np.testing.assert_allclose(out["data"]["ndarray"], want, rtol=1e-6)
            assert d["data"] == g["data"]
        with pytest.raises(HTTPError, match="401"):
            await asyncio.to_thread(contract.run, spec, "127.0.0.1", ggrpc.bound_port, use_grpc=True,
                                    oauth_key="mk", oauth_secret="no", oauth_port=gport)
        await asyncio.to_thread(contract.main, [str(MODELS / "mean_classifier" / "contract.json"), "127.0.0.1",
                                                str(mport), "--grpc", "-n", "2", "--prnt"])
        assert capsys.readouterr().out.count("RECEIVED:") == 2
    finally:
        await ggrpc.stop(None)
        gws.close()
        await gws.wait_closed()
        await server.stop()  # closes its unit's gRPC channel
        await ms.grpc_server.stop(None)


async def test_contract_run_direct_and_through_the_gateway(tmp_path):
    """The MeanClassifier microservice answers each random batch of its
    contract with one probability a row, directly and through a gateway
    whose RemoteBackend reaches it, the token fetched with --oauth-key;
    the gateway's file:// audit holds each pair."""
    spec = json.loads((MODELS / "mean_classifier" / "contract.json").read_text())
    user = load_user_object("MeanClassifier", str(MODELS / "mean_classifier"))
    ms, _, _ = await serve_microservice(user, "MeanClassifier", "MODEL", host="127.0.0.1", http_port=0)
    mport = ms.sockets[0].getsockname()[1]
    oauth = OAuthProvider()
    store = DeploymentStore(oauth=oauth)
    backend = RemoteBackend(resolve=lambda d: f"http://127.0.0.1:{mport}")
    gw = Gateway(store=store, oauth=oauth, backend=backend, audit=make_audit_sink(f"file://{tmp_path / 'audit'}"))
    store.deployment_added(DeploymentSpec(name="mean", oauth_key="mk", oauth_secret="ms"))
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    gport = gws.sockets[0].getsockname()[1]
    try:
        direct = await asyncio.to_thread(contract.run, spec, "127.0.0.1", mport, rounds=3, batch_size=4, seed=1)
        gated = await asyncio.to_thread(contract.run, spec, "127.0.0.1", gport, rounds=3, batch_size=4, seed=1,
                                        oauth_key="mk", oauth_secret="ms")
        rng = np.random.default_rng(1)
        for d, g in zip(direct, gated):
            _, x = contract.generate_batch(spec, 4, rng)
            want = 1.0 / (1.0 + np.exp(-np.mean(x, axis=1, keepdims=True)))
            for out in (d, g):
                assert out["data"]["names"] == ["proba"]
                np.testing.assert_allclose(out["data"]["ndarray"], want, rtol=1e-6)
        records = list(audit_tail.iter_records(f"file://{tmp_path / 'audit'}", None, follow=False))
        assert [r["client"] for r in records] == ["mk"] * 3
        assert [r["response"]["data"] for r in records] == [g["data"] for g in gated]
        with pytest.raises(Exception, match="401"):
            await asyncio.to_thread(contract.run, spec, "127.0.0.1", gport, oauth_key="mk", oauth_secret="no")
    finally:
        await backend.close()
        gws.close()
        await gws.wait_closed()
        ms.close()
        await ms.wait_closed()


async def test_audit_tail_reads_back_served_traffic(tmp_path):
    sink = JsonlAuditSink(str(tmp_path))
    req = SeldonMessage.from_array(np.ones((1, 2), np.float32))
    resp = SeldonMessage.from_array(np.zeros((1, 3), np.float32))
    for client in ("client-a", "client-b", "client-a"):
        sink.send(client, req, resp)
    records = list(audit_tail.iter_records(f"file://{tmp_path}", None, follow=False))
    assert sorted(r["client"] for r in records) == ["client-a", "client-a", "client-b"]
    for r in records:
        assert r["request"]["data"]["tensor"]["values"] == [1.0, 1.0]
        assert r["response"]["data"]["tensor"]["shape"] == [1, 3]
    assert len(list(audit_tail.iter_records(f"file://{tmp_path}", "client-a", follow=False))) == 2
    # torn and corrupt lines leave the stream alive
    with (tmp_path / "client-a.jsonl").open("a") as f:
        f.write('{"corrupt": \n')
        f.write("{torn")
    assert len(list(audit_tail.iter_records(f"file://{tmp_path}", "client-a", False))) == 2
    # a truncated file under --follow restarts from its top
    gen = audit_tail.iter_records(f"file://{tmp_path}", "client-b", follow=True)
    assert next(gen)["client"] == "client-b"
    (tmp_path / "client-b.jsonl").write_text("")
    tiny = SeldonMessage.from_array(np.ones((1, 1), np.float32))
    sink.send("client-b", tiny, tiny)
    again = next(gen)
    assert again["client"] == "client-b" and again["request"]["data"]["tensor"]["shape"] == [1, 1]
    with pytest.raises(SystemExit, match="kafka:// needs --client"):
        audit_tail.iter_records("kafka://broker:9092", None, False)

    # the gateway's own sink, served: each record the pair sent and received
    predictor, name = load_predictor(str(ROOT / "seldon_core_tpu_torch" / "deployments" / "iris.json"))
    server, gw, _, token = build_gateway_stack(predictor, deployment_name=name, device="cpu",
                                               audit=make_audit_sink(f"file://{tmp_path / 'served'}"))
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    pool = HttpPool()
    sent, got = [], []
    try:
        for i in range(3):
            body = {"data": {"ndarray": [[5.0 + i, 3.0, 1.5, 0.2]]}}
            r = await pool.post(f"http://127.0.0.1:{gws.sockets[0].getsockname()[1]}/api/v0.1/predictions",
                                json.dumps(body).encode(), {"Authorization": f"Bearer {token}"})
            assert r.status == 200
            sent.append(body)
            got.append(r.json())
    finally:
        await pool.close()
        gws.close()
        await gws.wait_closed()
        await server.stop()
    records = list(audit_tail.iter_records(f"file://{tmp_path / 'served'}", "bench-key", follow=False))
    # the request as the gateway decoded it (float32), the response as sent
    assert [np.asarray(r["request"]["data"]["ndarray"], np.float32).tolist() for r in records] == \
        [np.asarray(s["data"]["ndarray"], np.float32).tolist() for s in sent]
    assert [r["response"] for r in records] == got


async def test_run_load_with_oauth_through_the_gateway_counts_only_200s():
    predictor, name = load_predictor(str(ROOT / "seldon_core_tpu_torch" / "deployments" / "iris_abtest.json"))
    server, gw, _, _ = build_gateway_stack(predictor, deployment_name=name, oauth_key="k", oauth_secret="s",
                                           device="cpu")
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    base = f"http://127.0.0.1:{gws.sockets[0].getsockname()[1]}"
    try:
        stats = await loadtest.run_load(base, users=2, duration_s=0.6, features=4, oauth_key="k", oauth_secret="s",
                                        route_rewards=[0.2, 0.9], seed=3)
        s = stats.summary()
        assert s["requests"] > 0 and s["errors"] == 0 and s["feedback_sent"] > 0
        # a stale token (the deployment removed under the run) answers 401:
        # errors, never counted requests
        gw.store.deployment_removed(name)
        gw.oauth.add_client("k", "s")
        stats = await loadtest.run_load(base, users=1, duration_s=0.3, features=4, oauth_key="k", oauth_secret="s")
        assert stats.summary()["requests"] == 0 and stats.errors > 0
    finally:
        gws.close()
        await gws.wait_closed()
        await server.stop()


@pytest.mark.parametrize("follow", [False, True])
def test_kafka_tail_matches_jax(monkeypatch, follow):
    """``kafka://``: with a stub ``kafka`` module in ``sys.modules``, the
    port's ``audit_tail.iter_records`` yields what the JAX package's does
    over the same planted records, and opens its consumer the same way."""
    import sys
    import types

    from seldon_core_tpu.tools import audit_tail as jax_audit_tail

    planted = [
        {"ts": 1.5, "request": {"data": {"ndarray": [[1.0, 2.0]]}},
         "response": {"meta": {"puid": "p1", "routing": {"r": 1}}, "data": {"ndarray": [[0.1, 0.9]]}}},
        {"ts": 2.5, "request": {"data": {"tensor": {"shape": [1, 1], "values": [3.0]}}},
         "response": {"meta": {"puid": "p2"}, "data": {"tensor": {"shape": [1, 1], "values": [0.5]}}}},
    ]
    opened = []

    class KafkaConsumer:
        def __init__(self, topic, **kwargs):
            opened.append((topic, {k: v for k, v in kwargs.items() if k != "value_deserializer"}))
            self._deserialize = kwargs["value_deserializer"]

        def __iter__(self):
            for record in planted:
                yield types.SimpleNamespace(value=self._deserialize(json.dumps(record).encode()))

    monkeypatch.setitem(sys.modules, "kafka", types.SimpleNamespace(KafkaConsumer=KafkaConsumer))
    ours = list(audit_tail.iter_records("kafka://broker:9092", "client-a", follow))
    theirs = list(jax_audit_tail.iter_records("kafka://broker:9092", "client-a", follow))
    assert ours == theirs == [{**r, "client": "client-a"} for r in planted]
    assert opened[0] == opened[1]
    assert opened[0][0] == "client-a" and opened[0][1]["bootstrap_servers"] == "broker:9092"
    assert [audit_tail._summarize(r) for r in ours] == [jax_audit_tail._summarize(r) for r in theirs]
