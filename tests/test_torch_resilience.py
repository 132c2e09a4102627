"""The port's resilience layer against the JAX package's.

Each scenario runs through the port's executor and the JAX package's on the
same graph, the same unit behaviour and the same ``FaultSpec`` seeds, and
must give the same error codes, ``degraded`` tags, routing, attempt counts
and breaker transitions: retry recovery and exhaustion, a non-retryable
failure that skips the retry, the breaker state machine (against an
injected clock), router fallback in the single and the batched walk,
combiner quorum, a deadline that cancels the walk (504, code 304), a tag
that tightens the deadline but never widens it, an expired deadline that
fails before dispatch, and 503 (code 305) with Retry-After through the
wire. Hangs are short ``asyncio.sleep``s that a budget of tens of
milliseconds cancels; no assertion reads the wall clock.

The example ``iris_fallback_breaker.json`` serves on the CPU with every
knob it names (retry, breaker, fallback, the deadline), and a deployment
with ``batch_across_requests`` false walks each request alone.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.core.errors import APIException as JaxAPIException
from seldon_core_tpu.core.errors import ErrorCode as JaxErrorCode
from seldon_core_tpu.core.message import Meta as JaxMeta
from seldon_core_tpu.core.message import SeldonMessage as JaxMessage
from seldon_core_tpu.engine import build_executor as jax_build_executor
from seldon_core_tpu.engine import faults as jax_faults
from seldon_core_tpu.engine import resilience as jax_res
from seldon_core_tpu.graph import SeldonDeployment as JaxDeployment
from seldon_core_tpu.graph import spec as jax_spec
from seldon_core_tpu.graph.defaulting import default_deployment as jax_default_deployment
from seldon_core_tpu.serving import wire as jax_wire
from seldon_core_tpu.serving.batcher import make_batcher as jax_make_batcher
from seldon_core_tpu.serving.service import PredictionService as JaxService
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.engine import faults, resilience
from seldon_core_tpu_torch.engine.executor import build_executor
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph import spec
from seldon_core_tpu_torch.graph.defaulting import default_deployment
from seldon_core_tpu_torch.graph.spec import PredictiveUnit, SeldonDeployment
from seldon_core_tpu_torch.serving import wire
from seldon_core_tpu_torch.serving.batcher import make_batcher
from seldon_core_tpu_torch.serving.server import PredictorServer
from seldon_core_tpu_torch.serving.service import PredictionService

REPO = Path(__file__).resolve().parents[1]
IRIS_FALLBACK = REPO / "examples" / "deployments" / "iris_fallback_breaker.json"
HANG_S = 0.5  # a hang; every budget below cancels it within tens of ms


class Recorder:
    """A resilience event sink for either package."""

    def __init__(self):
        self.retries, self.transitions, self.deadlines, self.degradations, self.faults = [], [], [], [], []

    def retry(self, unit, attempt):
        self.retries.append((unit, attempt))

    def breaker_transition(self, endpoint, state):
        self.transitions.append((endpoint, state))

    def deadline_exceeded(self, unit):
        self.deadlines.append(unit)

    def degraded(self, unit, mode):
        self.degradations.append((unit, mode))

    def fault_injected(self, unit, kind):
        self.faults.append((unit, kind))

    def record(self):
        return self.retries, self.transitions, self.deadlines, self.degradations


class JaxFlaky:
    """User-class model for the JAX package: fails transport-class (or with
    ``code``) for its first ``fail_first`` calls."""

    def __init__(self, fail_first, code="ENGINE_MICROSERVICE_ERROR"):
        self.fail_first, self.code, self.calls = fail_first, code, 0

    def predict(self, X, names):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise JaxAPIException(JaxErrorCode[self.code], "flaky")
        return np.full((np.atleast_2d(X).shape[0], 3), 0.5, np.float32)


class PortFlaky(Unit):
    """The same unit for the port."""

    def __init__(self, fail_first, code="ENGINE_MICROSERVICE_ERROR"):
        super().__init__(PredictiveUnit(name="flaky"))
        self.fail_first, self.code, self.calls = fail_first, code, 0

    async def transform_input(self, msg):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise APIException(ErrorCode[self.code], "flaky")
        return msg.with_array(np.full((np.atleast_2d(np.asarray(msg.array)).shape[0], 3), 0.5, np.float32))


def _cr(graph, tpu=None):
    pred = {"name": "p", "graph": graph}
    if tpu:
        pred["tpu"] = tpu
    return {"spec": {"name": "d", "predictors": [pred]}}


def _build(graph, *, flaky=None, tpu=None):
    """(port executor, JAX executor, port recorder, JAX recorder, port
    units, JAX units) for one graph; ``flaky``: {node: (fail_first, code)}."""
    flaky = flaky or {}
    ours_units = {n: PortFlaky(*args) for n, args in flaky.items()}
    theirs_units = {n: JaxFlaky(*args) for n, args in flaky.items()}
    rec, jrec = Recorder(), Recorder()
    ours = build_executor(SeldonDeployment.from_dict(_cr(graph, tpu)).spec.predictors[0],
                          context={"units": ours_units, "device": "cpu"}, resilience_events=rec)
    theirs = jax_build_executor(JaxDeployment.from_dict(_cr(graph, tpu)).spec.predictors[0],
                                context={"units": theirs_units}, resilience_events=jrec)
    return ours, theirs, rec, jrec, ours_units, theirs_units


def _msg(rows=1, tags=None):
    return SeldonMessage.from_array(np.ones((rows, 4), np.float32), meta=Meta(tags=dict(tags or {})))


def _jmsg(rows=1, tags=None):
    return JaxMessage.from_array(np.ones((rows, 4), np.float32), meta=JaxMeta(tags=dict(tags or {})))


async def _outcome(coro):
    """(error code or None, routing, degraded tag, array) of one call."""
    try:
        out = await coro
    except (APIException, JaxAPIException) as e:
        return (e.error.code, None, None, None)
    return (None, dict(out.meta.routing), out.meta.tags.get("degraded"), np.asarray(out.array).tolist())


def _param(name, value, typ):
    return {"name": name, "value": str(value), "type": typ}


# ----------------------------------------------------------------- primitives


def test_resilience_spec_parses_like_jax():
    params = {"retry_max_attempts": 3, "retry_backoff_ms": 10.0, "retry_seed": 4,
              "breaker_failure_threshold": 4, "breaker_reset_ms": 250.0, "breaker_window": 7,
              "fallback_child": 1, "quorum": 2}
    ours, theirs = spec.ResilienceSpec.from_parameters(params), jax_spec.ResilienceSpec.from_parameters(params)
    for f in ("max_attempts", "backoff_ms", "backoff_mult", "jitter", "seed"):
        assert getattr(ours.retry, f) == getattr(theirs.retry, f)
    for f in ("failure_threshold", "error_rate", "window", "reset_ms", "half_open_probes"):
        assert getattr(ours.breaker, f) == getattr(theirs.breaker, f)
    assert (ours.fallback_child, ours.quorum) == (theirs.fallback_child, theirs.quorum) == (1, 2)
    empty = spec.ResilienceSpec.from_parameters({})
    assert (empty.retry, empty.breaker, empty.fallback_child, empty.quorum) == (None, None, None, None)
    # every node of the example deployment parses to the JAX package's policy
    obj = json.loads(IRIS_FALLBACK.read_text())
    ours_g = SeldonDeployment.from_dict(obj).spec.predictors[0].graph
    theirs_g = JaxDeployment.from_dict(obj).spec.predictors[0].graph
    for u, ju in zip(ours_g.walk(), theirs_g.walk()):
        a, b = spec.ResilienceSpec.for_unit(u), jax_spec.ResilienceSpec.for_unit(ju)
        assert (a.fallback_child, a.quorum, a.retry is None, a.breaker is None) == (
            b.fallback_child, b.quorum, b.retry is None, b.breaker is None)
        if a.breaker is not None:
            assert (a.breaker.failure_threshold, a.breaker.reset_ms) == (b.breaker.failure_threshold, b.breaker.reset_ms)


def _drive_breaker(mod, spec_mod):
    """One scripted run of a breaker on an injected clock: the values each
    call returned and every transition."""
    now = [0.0]
    transitions = []
    cb = mod.CircuitBreaker(spec_mod.BreakerSpec(failure_threshold=3, reset_ms=1000.0, window=100),
                            clock=lambda: now[0], on_transition=transitions.append)
    log = [cb.allow()]
    for _ in range(3):
        cb.record_failure()
    log += [cb.state, cb.allow(), cb.retry_after_s()]
    now[0] = 0.5
    log += [cb.is_open(), cb.allow(), cb.retry_after_s()]
    now[0] = 1.1
    log += [cb.is_open(), cb.allow(), cb.state, cb.allow()]
    cb.release_probe()  # a probe with no verdict frees its slot
    log += [cb.allow()]
    cb.record_success()
    log += [cb.state]
    for _ in range(3):
        cb.record_failure()
    now[0] = 3.0
    log += [cb.allow()]
    cb.record_failure()
    log += [cb.state]
    rate = mod.CircuitBreaker(spec_mod.BreakerSpec(failure_threshold=100, error_rate=0.5, window=10))
    for _ in range(5):
        rate.record_success()
        rate.record_failure()
    return log + [rate.state], transitions


def test_breaker_state_machine_like_jax():
    ours, theirs = _drive_breaker(resilience, spec), _drive_breaker(jax_res, jax_spec)
    assert ours == theirs
    log, transitions = ours
    assert transitions == ["open", "half_open", "closed", "open", "half_open", "open"]
    assert log[-1] == "open"


def test_fault_schedule_sequences_equal_jax():
    kw = dict(error_rate=0.3, latency_ms=1.0, latency_jitter_ms=2.0, timeout_rate=0.1, seed=42)
    ours, theirs = faults.FaultSchedule(faults.FaultSpec(**kw)), jax_faults.FaultSchedule(jax_faults.FaultSpec(**kw))
    seq = [(d.action, d.delay_s) for d in (ours.next() for _ in range(200))]
    assert seq == [(d.action, d.delay_s) for d in (theirs.next() for _ in range(200))]
    assert {a for a, _ in seq} == {"ok", "error", "timeout"} and ours.injected == theirs.injected
    flap = faults.FaultSchedule(faults.FaultSpec(flap_period=5, flap_error_rate=1.0, seed=0))
    assert [flap.next().action for _ in range(20)] == (["error"] * 5 + ["ok"] * 5) * 2


def test_deadline_and_retry_state_like_jax():
    now = [10.0]
    d = resilience.Deadline(0.25, clock=lambda: now[0])
    jd = jax_res.Deadline(0.25, clock=lambda: now[0])
    now[0] = 10.2
    assert (d.expired(), round(d.remaining(), 6)) == (jd.expired(), round(jd.remaining(), 6)) == (False, 0.05)
    now[0] = 10.3
    assert d.expired() and jd.expired()
    rs = resilience.RetryState(spec.RetrySpec(max_attempts=4, backoff_ms=5.0, seed=9))
    jrs = jax_res.RetryState(jax_spec.RetrySpec(max_attempts=4, backoff_ms=5.0, seed=9))
    assert [rs.backoff(a) for a in (1, 2, 3)] == [jrs.backoff(a) for a in (1, 2, 3)]
    err = APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, "x")
    assert rs.should_retry("predict", 1, err, 0.0) and not rs.should_retry("send_feedback", 1, err, 0.0)
    assert not rs.should_retry("predict", 4, err, 0.0)
    assert not rs.should_retry("predict", 1, APIException(ErrorCode.ENGINE_INVALID_RESPONSE, "x"), 0.0)


# ------------------------------------------------------------------- retries


def _retry_graph(attempts=3):
    return {"name": "m", "type": "MODEL", "parameters": [
        _param("retry_max_attempts", attempts, "INT"), _param("retry_backoff_ms", 1, "FLOAT"),
        _param("retry_seed", 7, "INT")]}


async def test_retry_recovers_like_jax():
    ours, theirs, rec, jrec, units, junits = _build(_retry_graph(), flaky={"m": (2,)})
    got, want = await _outcome(ours.execute(_msg())), await _outcome(theirs.execute(_jmsg()))
    assert got == want and got[0] is None and np.asarray(got[3]).shape == (1, 3)
    assert units["m"].calls == junits["m"].calls == 3
    assert rec.record() == jrec.record() and rec.retries == [("m", 1), ("m", 2)]


@pytest.mark.parametrize("code,calls", [("ENGINE_MICROSERVICE_ERROR", 3), ("ENGINE_INVALID_RESPONSE", 1)],
                         ids=["exhausted", "not_retryable"])
async def test_retry_exhaustion_and_non_retryable_like_jax(code, calls):
    ours, theirs, rec, jrec, units, junits = _build(_retry_graph(), flaky={"m": (10, code)})
    got, want = await _outcome(ours.execute(_msg())), await _outcome(theirs.execute(_jmsg()))
    assert got == want and got[0] == ErrorCode[code].code
    assert units["m"].calls == junits["m"].calls == calls
    assert rec.record() == jrec.record()


# ------------------------------------------------------------------ deadlines


async def test_deadline_cancels_walk_with_504_like_jax():
    graph = {"name": "slow", "implementation": "SIMPLE_MODEL",
             "parameters": [_param("delay_ms", HANG_S * 1000, "FLOAT")]}
    ours, theirs, *_ = _build(graph)
    got = await _outcome(PredictionService(ours, deadline_ms=40.0).predict(_msg()))
    want = await _outcome(JaxService(theirs, deadline_ms=40.0).predict(_jmsg()))
    assert got == want == (304, None, None, None)
    assert ErrorCode.REQUEST_DEADLINE_EXCEEDED.http_status == 504


async def test_request_tag_tightens_but_never_widens_deadline_like_jax():
    graph = {"name": "fast", "implementation": "SIMPLE_MODEL"}
    ours, theirs, *_ = _build(graph)
    svc, jsvc = PredictionService(ours, deadline_ms=50.0), JaxService(theirs, deadline_ms=50.0)
    for tags, budget in (({"deadline_ms": 10_000}, 0.05), ({"deadline_ms": 20}, 0.02), ({}, 0.05),
                         ({"deadline_ms": "junk"}, 0.05)):
        d, jd = svc._request_deadline(_msg(tags=tags)), jsvc._request_deadline(_jmsg(tags=tags))
        assert round(d.remaining(), 2) == round(jd.remaining(), 2) == budget
    free, jfree = PredictionService(ours), JaxService(theirs)
    assert free._request_deadline(_msg()) is None and jfree._request_deadline(_jmsg()) is None
    assert round(free._request_deadline(_msg(tags={"deadline_ms": 30})).remaining(), 2) == 0.03


async def test_expired_deadline_fails_before_dispatch_like_jax():
    now = [0.0]
    ours, theirs, rec, jrec, units, junits = _build({"name": "m", "type": "MODEL"}, flaky={"m": (0,)})
    codes = []
    for mod, ex, msg in ((resilience, ours, _msg()), (jax_res, theirs, _jmsg())):
        token = mod.DEADLINE.set(mod.Deadline(0.01, clock=lambda: now[0]))
        now[0] = 1.0  # the budget is gone before the walk starts
        try:
            codes.append((await _outcome(ex.execute(msg)))[0])
        finally:
            mod.DEADLINE.reset(token)
            now[0] = 0.0
    assert codes == [304, 304]
    assert units["m"].calls == junits["m"].calls == 0
    assert rec.deadlines == jrec.deadlines == ["m"]


async def test_timeout_fault_is_reclaimed_by_the_deadline_like_jax():
    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}
    ours, theirs, *_ = _build(graph)
    sched = faults.install_faults(ours, {"m": faults.FaultSpec(timeout_rate=1.0, hang_s=HANG_S, seed=1)})
    jsched = jax_faults.install_faults(theirs, {"m": jax_faults.FaultSpec(timeout_rate=1.0, hang_s=HANG_S, seed=1)})
    got = await _outcome(PredictionService(ours, deadline_ms=40.0).predict(_msg()))
    want = await _outcome(JaxService(theirs, deadline_ms=40.0).predict(_jmsg()))
    assert got == want == (304, None, None, None)
    assert sched["m"].injected == jsched["m"].injected == 1


# --------------------------------------------------------------- degradation


def _fallback_graph():
    return {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
            "parameters": [_param("fallback_child", 1, "INT")],
            "children": [
                {"name": "a", "type": "MODEL", "parameters": [
                    _param("breaker_failure_threshold", 2, "INT"), _param("breaker_reset_ms", 60000, "FLOAT")]},
                {"name": "b", "implementation": "SIMPLE_MODEL"}]}


async def test_router_fallback_on_failure_and_open_breaker_like_jax():
    ours, theirs, rec, jrec, units, junits = _build(_fallback_graph(), flaky={"a": (10**9,)})
    got = [await _outcome(ours.execute(_msg())) for _ in range(5)]
    want = [await _outcome(theirs.execute(_jmsg())) for _ in range(5)]
    assert got == want
    assert all(o[:3] == (None, {"r": 1}, "router_fallback") for o in got)
    np.testing.assert_allclose(got[0][3], [[0.1, 0.9, 0.5]], rtol=1e-6)
    assert ours.breaker_for("a").state == theirs.breaker_for("a").state == "open"
    assert units["a"].calls == junits["a"].calls == 2  # later requests never dispatch to it
    assert rec.record() == jrec.record() and ("a", "open") in rec.transitions


async def test_router_fallback_in_the_batched_walk_like_jax():
    ours, theirs, rec, jrec, units, junits = _build(_fallback_graph(), flaky={"a": (10**9,)})
    rounds, jrounds = [], []
    for _ in range(3):
        outs = await ours.execute_many([_msg(), _msg(2), _msg()])
        jouts = await theirs.execute_many([_jmsg(), _jmsg(2), _jmsg()])
        rounds.append([(dict(o.meta.routing), o.meta.tags.get("degraded"), np.asarray(o.array).shape) for o in outs])
        jrounds.append([(dict(o.meta.routing), o.meta.tags.get("degraded"), np.asarray(o.array).shape)
                        for o in jouts])
    assert rounds == jrounds
    assert rounds[0] == [({"r": 1}, "router_fallback", (1, 3)), ({"r": 1}, "router_fallback", (2, 3)),
                         ({"r": 1}, "router_fallback", (1, 3))]
    assert units["a"].calls == junits["a"].calls == 2
    assert rec.record() == jrec.record()


def _quorum_graph(quorum):
    return {"name": "combo", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
            "parameters": [_param("quorum", quorum, "INT")],
            "children": [{"name": "m1", "implementation": "SIMPLE_MODEL"},
                         {"name": "m2", "implementation": "SIMPLE_MODEL"},
                         {"name": "dead", "type": "MODEL"}]}


@pytest.mark.parametrize("quorum", [2, 3])
@pytest.mark.parametrize("batched", [False, True])
async def test_combiner_quorum_like_jax(quorum, batched):
    ours, theirs, rec, jrec, *_ = _build(_quorum_graph(quorum), flaky={"dead": (10**9,)})
    if batched:
        got = await _outcome(_first(ours.execute_many([_msg(), _msg()])))
        want = await _outcome(_first(theirs.execute_many([_jmsg(), _jmsg()])))
    else:
        got, want = await _outcome(ours.execute(_msg())), await _outcome(theirs.execute(_jmsg()))
    assert got == want
    if quorum == 2:
        np.testing.assert_allclose(got[3], [[0.1, 0.9, 0.5]], rtol=1e-6)
        assert got[2] == "quorum" and rec.degradations == jrec.degradations == [("combo", "quorum")]
    else:
        assert got[0] == 103 and rec.degradations == jrec.degradations == []


async def _first(coro):
    return (await coro)[0]


def _breaker_only_graph():
    return {"name": "m", "type": "MODEL", "parameters": [
        _param("breaker_failure_threshold", 1, "INT"), _param("breaker_reset_ms", 60000, "FLOAT")]}


async def test_open_breaker_without_fallback_is_503_with_retry_after_like_jax():
    ours, theirs, rec, jrec, units, junits = _build(_breaker_only_graph(), flaky={"m": (10**9,)})
    codes = []
    for ex, msg in ((ours, _msg), (theirs, _jmsg)):
        first = await _outcome(ex.execute(msg()))
        try:
            await ex.execute(msg())
        except (APIException, JaxAPIException) as e:
            second = e
        codes.append((first[0], second.error.code, second.error.http_status, second.retry_after_s > 0,
                      second.retry_after_header()))
    assert codes[0] == codes[1] == (103, 305, 503, True, "60")
    assert units["m"].calls == junits["m"].calls == 1
    assert rec.transitions == jrec.transitions == [("m", "open")]


async def test_wire_sends_503_with_retry_after_like_jax():
    ours, theirs, *_ = _build(_breaker_only_graph(), flaky={"m": (10**9,)})
    body = b'{"data": {"ndarray": [[1.0, 1.0, 1.0, 1.0]]}}'
    req = dict(method="POST", path="/api/v0.1/predictions", headers={"content-type": "application/json"}, body=body)
    svc, jsvc = PredictionService(ours), JaxService(theirs)
    got = [await wire.engine_predictions(svc, wire.WireRequest(**req)) for _ in range(2)]
    want = [await jax_wire.engine_predictions(jsvc, jax_wire.WireRequest(**req)) for _ in range(2)]
    assert [r.status for r in got] == [r.status for r in want] == [500, 503]
    assert "Retry-After" not in got[0].headers
    assert got[1].headers["Retry-After"] == want[1].headers["Retry-After"] == "60"
    assert json.loads(got[1].body) == json.loads(want[1].body)
    assert json.loads(got[1].body)["code"] == 305


async def test_fault_injector_unit_fails_like_jax():
    graph = {"name": "chaos", "type": "TRANSFORMER", "implementation": "FAULT_INJECTOR",
             "parameters": [_param("fail_rate", 0.5, "FLOAT"), _param("seed", 3, "INT")],
             "children": [{"name": "m", "implementation": "SIMPLE_MODEL"}]}
    ours, theirs, *_ = _build(graph)
    got = [(await _outcome(ours.execute(_msg())))[0] for _ in range(20)]
    want = [(await _outcome(theirs.execute(_jmsg())))[0] for _ in range(20)]
    assert got == want and set(got) == {None, 103}


# --------------------------------------------------- the example deployment


def _iris_fallback(primary_as_root: bool = False, **tpu) -> dict:
    obj = json.loads(IRIS_FALLBACK.read_text())
    pred = obj["spec"]["predictors"][0]
    if primary_as_root:  # the breakered node with no router (so no fallback) above it
        pred["graph"] = pred["graph"]["children"][0]
    pred["tpu"].update(tpu)
    return obj


def _servers(obj):
    """The port's server on the CPU and the JAX package's executor and
    service for one deployment CR."""
    server = PredictorServer(default_deployment(SeldonDeployment.from_dict(obj), n_devices=1).spec.predictors[0],
                             device="cpu")
    jpred = jax_default_deployment(JaxDeployment.from_dict(obj)).spec.predictors[0]
    jex = jax_build_executor(jpred)
    return server, jex, JaxService(jex, deadline_ms=jpred.tpu.deadline_ms)


async def test_iris_fallback_breaker_serves_degraded_like_jax():
    """As the example stands: every tpu key and unit parameter it sets is
    read (none is left in TpuSpec.extra), and with the primary failing
    every call, retries, the breaker and the fallback give the JAX
    package's replies, attempt counts and breaker state."""
    obj = _iris_fallback()
    server, jex, jsvc = _servers(obj)
    assert server.service.deadline_ms == 500.0 and dict(server.predictor.tpu.extra) == {}
    sched = faults.install_faults(server.executor, {"iris-primary": faults.FaultSpec(error_rate=1.0, seed=5)})
    jsched = jax_faults.install_faults(jex, {"iris-primary": jax_faults.FaultSpec(error_rate=1.0, seed=5)})
    x = [[5.1, 3.5, 1.4, 0.2]]
    got, want = [], []
    for _ in range(4):
        out = await server.service.predict(SeldonMessage.from_array(np.asarray(x, np.float32)))
        jout = await jsvc.predict(JaxMessage.from_array(np.asarray(x, np.float32)))
        got.append((dict(out.meta.routing), out.meta.tags.get("degraded"), np.asarray(out.array).shape))
        want.append((dict(jout.meta.routing), jout.meta.tags.get("degraded"), np.asarray(jout.array).shape))
    assert got == want == [({"router": 1}, "router_fallback", (1, 3))] * 4
    # 3 attempts, then 2 more open the breaker (threshold 5); then no dispatch
    assert sched["iris-primary"].calls == jsched["iris-primary"].calls == 5
    assert server.executor.breaker_for("iris-primary").state == jex.breaker_for("iris-primary").state == "open"
    await server.stop()


async def test_iris_fallback_breaker_deadline_tag_is_504_like_jax():
    obj = _iris_fallback()
    server, jex, jsvc = _servers(obj)
    faults.install_faults(server.executor, {"iris-primary": faults.FaultSpec(timeout_rate=1.0, hang_s=HANG_S)})
    jax_faults.install_faults(jex, {"iris-primary": jax_faults.FaultSpec(timeout_rate=1.0, hang_s=HANG_S)})
    body = b'{"meta": {"tags": {"deadline_ms": 50}}, "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}'
    req = dict(method="POST", path="/api/v0.1/predictions", headers={"content-type": "application/json"}, body=body)
    got = await wire.engine_predictions(server.service, wire.WireRequest(**req))
    want = await jax_wire.engine_predictions(jsvc, jax_wire.WireRequest(**req))
    assert (got.status, json.loads(got.body)["code"]) == (want.status, json.loads(want.body)["code"]) == (504, 304)
    # a cancelled call is no verdict on the node's health
    assert server.executor.breaker_for("iris-primary").state == "closed"
    await server.stop()


async def test_breakered_node_without_fallback_is_500_then_503_like_jax():
    obj = _iris_fallback(primary_as_root=True)
    server, jex, jsvc = _servers(obj)
    faults.install_faults(server.executor, {"iris-primary": faults.FaultSpec(error_rate=1.0, seed=5)})
    jax_faults.install_faults(jex, {"iris-primary": jax_faults.FaultSpec(error_rate=1.0, seed=5)})
    req = dict(method="POST", path="/api/v0.1/predictions", headers={"content-type": "application/json"},
               body=b'{"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}')
    got = [await wire.engine_predictions(server.service, wire.WireRequest(**req)) for _ in range(2)]
    want = [await jax_wire.engine_predictions(jsvc, jax_wire.WireRequest(**req)) for _ in range(2)]
    assert [(r.status, json.loads(r.body)["code"]) for r in got] == [(500, 103), (503, 305)]
    assert [(r.status, json.loads(r.body)["code"]) for r in want] == [(500, 103), (503, 305)]
    assert int(got[1].headers["Retry-After"]) == int(want[1].headers["Retry-After"]) >= 1
    await server.stop()


@pytest.mark.parametrize("across", [True, False])
async def test_batch_across_requests_false_walks_each_request_alone(across):
    obj = _iris_fallback(batch_across_requests=across, batch_timeout_ms=20.0)
    server, *_ = _servers(obj)
    tpu = server.predictor.tpu
    jtpu = jax_default_deployment(JaxDeployment.from_dict(obj)).spec.predictors[0].tpu
    assert (server.batcher is None) == (not across)
    assert (make_batcher(tpu, None, execute_many=None) is None) == (
        jax_make_batcher(jtpu, None, execute_many=None) is None) == (not across)
    sched = faults.install_faults(server.executor, {"iris-primary": faults.FaultSpec()})
    outs = await asyncio.gather(*(
        server.service.predict(SeldonMessage.from_array(np.full((1, 4), float(i), np.float32))) for i in range(6)))
    assert all(np.asarray(o.array).shape == (1, 3) for o in outs)
    if across:
        assert sched["iris-primary"].calls < 6  # concurrent requests merged
    else:
        assert sched["iris-primary"].calls == 6  # one walk each
    await server.stop()


_SUBPROCESS = r"""
import asyncio, json, sys
import numpy as np
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

predictor, name = load_predictor(sys.argv[1])
server = PredictorServer(predictor, deployment_name=name, device="cpu")
install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
out = asyncio.run(server.service.predict(SeldonMessage.from_array(np.ones((1, 4), np.float32))))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seldon_core_tpu"))
print(json.dumps({"degraded": out.meta.tags.get("degraded"), "leaked": leaked}))
"""


def test_resilience_serves_without_jax_in_a_fresh_interpreter(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    path = REPO / "seldon_core_tpu_torch" / "deployments" / "iris_fallback_breaker.json"
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(path)], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"degraded": "router_fallback", "leaked": []}
