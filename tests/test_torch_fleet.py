"""The port's replicated decode fleet (seldon_core_tpu_torch/serving/
affinity_router.py ``ReplicatedDecodeScheduler``, the scheduler's replica
hooks, engine/faults.py's decode faults) held to the JAX package's on the
CPU, mirroring tests/test_replica_routing.py and
tests/test_fleet_resilience.py:

- the port's fleet and the JAX one, on the same prompts and seed, route
  every request to the same arm, serve the same greedy rows (and the fused
  ``generate``'s) and count the same prefix hits, misses and sibling pulls;
- a generation interrupted at every round boundary resumes on a survivor
  bit-identical to the uninterrupted run, nothing streamed twice or
  skipped, on the pipelined and the serial loop;
- eviction after the miss threshold, half-open readmission, tick
  stagnation, a hung replica aborted without holding the event loop (the
  abort repair), drain and scale-down pushing prefix pages to the
  rendezvous sibling, warm scale-up through the persistence store (the
  autoscale driven by a patched clock, no wall-clock race), a boot failure
  counted, int8 spills verbatim, a truncated spill skipped;
- the decode fault decisions, PREFIX_AFFINITY, the served example, the
  SLO rewards and the operator routes against the JAX package.
"""

import asyncio
import json
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.engine import faults as jax_faults
from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.serving.affinity_router import ReplicatedDecodeScheduler as JaxFleet
from seldon_core_tpu.serving.decode_scheduler import DecodeScheduler as JaxScheduler
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.engine.faults import DecodeFaultSpec, DecodeFaultState, install_decode_faults
from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.persistence.state import FileStateStore
from seldon_core_tpu_torch.serving import affinity_router as router
from seldon_core_tpu_torch.serving.affinity_router import (
    AffinityBalancer,
    ReplicatedDecodeScheduler,
    preseed_from_store,
    spill_to_store,
)
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler

SEQ = 12
MAX_NEW = 6
VOCAB = 96
SHARED = 8
BLOCK = 4
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    """(numpy params, the port's tensors, the JAX greedy oracle)."""
    p = jd.init_decoder(seed=5, vocab=VOCAB, hidden=32, layers=1, ffn=64, max_len=32)
    gen = jax.jit(jd.generate, static_argnums=2)
    return p, params_to_torch(p, CPU), lambda ids: np.asarray(gen(p, jnp.asarray(np.asarray(ids)), MAX_NEW))


def _group_prompts(n_groups, per_group, seed=2):
    """Consecutive-by-group prompts sharing their first SHARED tokens (the
    JAX tests' generator)."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n_groups):
        head = rng.integers(0, VOCAB, SHARED).astype(np.int32)
        for _ in range(per_group):
            prompts.append(np.concatenate([head, rng.integers(0, VOCAB, SEQ - SHARED)]).astype(np.int32))
    return prompts


def _replica(tp, name, i=0, n_slots=2, **kw):
    return DecodeScheduler(tp, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=n_slots, prefix_slots=8, kv_page_size=4,
                           deployment_name=f"{name}/r{i}", replica_id=i, **kw)


def _fleet(tp, n, name, policy="affinity", warm=True, **kw):
    rep = ReplicatedDecodeScheduler(lambda i: _replica(tp, name, i), n, policy=policy, affinity_block=BLOCK,
                                    deployment_name=name, seed=0, **kw)
    if warm:
        rep.warmup()
    return rep


def _jax_fleet(p, n, name, policy):
    rep = JaxFleet(
        lambda i: JaxScheduler(p, seq_len=SEQ, max_new_tokens=MAX_NEW, n_slots=2, prefix_slots=8, kv_page_size=4,
                               deployment_name=f"{name}/r{i}", replica_id=i),
        n, policy=policy, affinity_block=BLOCK, deployment_name=name, seed=0)
    rep.warmup()
    return rep


async def _submit_routed(fleet, prompts):
    """Sequential submits (capture timing deterministic), recording each
    request's arm."""
    arms, real = [], fleet.route

    def route(prompt):
        arm, reason = real(prompt)
        arms.append(arm)
        return arm, reason

    fleet.route = route
    outs = [await fleet.submit(p) for p in prompts]
    del fleet.route
    return np.stack(outs), arms


def _recording_metrics():
    class Rec(NullMetrics):
        def __init__(self):
            self.breaker_states, self.replica_states, self.routes = [], [], []
            self.evictions = self.recoveries = self.drains = self.migrations = self.boot_failures = 0
            self.ttft_paths, self.preseeded_pages = [], 0

        def breaker(self, deployment, endpoint, state):
            self.breaker_states.append((endpoint, state))

        def replica_state(self, deployment, replica, state):
            self.replica_states.append((replica, state))

        def replica_eviction(self, deployment):
            self.evictions += 1

        def replica_recovery(self, deployment):
            self.recoveries += 1

        def replica_drain(self, deployment):
            self.drains += 1

        def replica_migration(self, deployment, n):
            self.migrations += n

        def replica_boot_failure(self, deployment):
            self.boot_failures += 1

        def router_route(self, deployment, policy, reason):
            self.routes.append(reason)

        def decode_ttft_split(self, deployment, duration_s, path):
            self.ttft_paths.append(path)

        def router_preseed(self, deployment, pages):
            self.preseeded_pages += pages

    return Rec()


def _prompt_for_arm(fleet, arm, seed0=0):
    """A random prompt whose affinity home is ``arm``."""
    for s in range(seed0, seed0 + 200):
        p = np.random.default_rng(s).integers(0, VOCAB, SEQ).astype(np.int32)
        if fleet.route(p)[0] == arm:
            return p
    raise AssertionError(f"no prompt routed to arm {arm} in 200 seeds")


async def _readmit(fleet, arm):
    """Drive the half-open readmission of an evicted arm (its breaker resets
    after one poll interval, 1 ms with the poller off)."""
    fleet.replicas[arm]._faults = None
    for _ in range(50):
        await asyncio.sleep(0.003)
        fleet.poll_fleet_once()
        if fleet.replica_states()[arm] == "up":
            return
    raise AssertionError(f"arm {arm} never readmitted: {fleet.replica_states()}")


# ------------------------------------------------------ the fleets agree
@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
async def test_fleet_matches_the_jax_fleet(params, policy):
    """Same prompts, same seed: the same arm per request, the same greedy
    rows (the fused generate's, and one scheduler's), the same hits, misses
    and sibling pulls; affinity pays one cold capture per group, round robin
    more, rescued in part by sibling pulls."""
    p, tp, oracle = params
    prompts = _group_prompts(n_groups=3, per_group=4)
    single = _replica(tp, f"single-{policy}")
    single.warmup()
    out_single = np.stack([await single.submit(q) for q in prompts])
    await single.close()

    ours = _fleet(tp, 2, f"fleet-{policy}", policy)
    out, arms = await _submit_routed(ours, prompts)
    theirs = _jax_fleet(p, 2, f"jax-fleet-{policy}", policy)
    jout, jarms = await _submit_routed(theirs, prompts)

    assert arms == jarms
    np.testing.assert_array_equal(out, oracle(np.stack(prompts)))
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, out_single)
    counts = (ours.stat_prefix_hits, ours.stat_prefix_misses, ours.stat_sibling_pulls)
    assert counts == (theirs.stat_prefix_hits, theirs.stat_prefix_misses, theirs.stat_sibling_pulls)
    if policy == "affinity":
        assert counts == (9, 3, 0) and single.stat_prefix_misses == 3
    else:
        assert 3 < ours.stat_prefix_misses < 6 and ours.stat_sibling_pulls >= 1
        assert ours.stat_prefix_misses + ours.stat_prefix_hits == 12
    assert ours.recompiles_since_warmup() == 0
    assert set(ours.compile_counts()) == {f"r{i}.{k}" for i in (0, 1) for k in ("step", "chunk", "copy")}
    ours.allocator_audits()
    await ours.close()
    await theirs.close()


async def test_every_replica_shares_the_runtime_parameters(params):
    """No replica copies the parameters; each owns its pool, index, graph
    cache and worker."""
    _, tp, _ = params
    fleet = _fleet(tp, 2, "share", warm=False)
    a, b = fleet.replicas
    assert a.params is b.params is tp
    assert a.pool is not b.pool and a.graphs is not b.graphs and a._worker is not b._worker
    assert a._prefix_index is not b._prefix_index
    await fleet.close()


async def test_health_exposes_queue_depth_replica_id_and_state(params):
    from seldon_core_tpu_torch.telemetry import flight

    _, tp, _ = params
    fleet = _fleet(tp, 2, "health-fields")
    await _submit_routed(fleet, _group_prompts(1, 2))
    for i in range(2):
        row = flight.health_report()[f"health-fields/r{i}"]
        assert (row["replica_id"], row["queue_depth"], row["state"]) == (i, 0, "up")
    fleet.replicas[0]._waiting.append(object())
    assert flight.health_report()["health-fields/r0"]["queue_depth"] == 1
    fleet.replicas[0]._waiting.clear()
    fleet._set_replica_state(1, "evicted", "test")
    assert flight.health_report()["health-fields/r1"]["state"] == "evicted"
    await fleet.close()


# ------------------------------------------------- decode fault decisions
@pytest.mark.parametrize("spec", [
    dict(hang_at_round=2, hang_s=7.0, oom_at_round=4, readback_stall_ms=50.0, stall_from_round=3,
         drop_health_from=2, drop_health_count=2),
    dict(oom_at_round=1),
    dict(readback_stall_ms=5.0, stall_from_round=1, drop_health_from=1),
    dict(hang_at_round=3, oom_at_round=3, drop_health_from=4, drop_health_count=1),
])
def test_decode_fault_decisions_like_jax(spec):
    """The same pure function of (spec, ordinal) as the JAX package's, and
    replayable."""
    def run(state):
        out = []
        for i in range(8):
            out.append(("round", state.round_decision().action))
            out.append(("stall", state.readback_stall_s()))
            if i % 2:
                out.append(("probe", state.health_drop()))
        return out, (state.rounds, state.probes, state.injected)

    ours = run(DecodeFaultState(DecodeFaultSpec(**spec)))
    assert ours == run(jax_faults.DecodeFaultState(jax_faults.DecodeFaultSpec(**spec)))
    assert ours == run(DecodeFaultState(DecodeFaultSpec(**spec)))


def test_fault_decisions_by_ordinal():
    st = DecodeFaultState(DecodeFaultSpec(hang_at_round=2, hang_s=7.0, oom_at_round=4, readback_stall_ms=50.0,
                                          stall_from_round=3, drop_health_from=2, drop_health_count=2))
    assert [st.round_decision().action for _ in range(5)] == ["ok", "hang", "ok", "oom", "ok"]
    assert [st.readback_stall_s() for _ in range(2)] == [0.05, 0.05]
    assert [st.health_drop() for _ in range(5)] == [False, True, True, False, False]


def test_health_probe_drop_window(params):
    _, tp, _ = params
    sched = _replica(tp, "probe-drop")
    state = install_decode_faults(sched, DecodeFaultSpec(drop_health_from=2, drop_health_count=2))
    h = sched.health_probe()
    assert h == {"replica_id": 0, "queue_depth": 0, "active": 0, "ticks": 0, "closed": False}
    for _ in range(2):
        with pytest.raises(TimeoutError):
            sched.health_probe()
    assert sched.health_probe()["replica_id"] == 0
    assert (state.probes, state.injected) == (4, 2)


# --------------------------------------------------- poller evict / readmit
async def test_poller_evicts_after_threshold_and_halfopen_readmits(params):
    _, tp, _ = params
    rec = _recording_metrics()
    fleet = _fleet(tp, 2, "resil-poll", metrics=rec, health_miss_threshold=2)
    try:
        install_decode_faults(fleet.replicas[0], DecodeFaultSpec(drop_health_from=1))
        fleet.poll_fleet_once()
        assert fleet.replica_states() == ["up", "up"]
        assert fleet.replicas[0].flight.consecutive_misses == 1 and fleet.stat_health_misses == 1
        fleet.poll_fleet_once()
        assert fleet.replica_states() == ["evicted", "up"]
        assert fleet.stat_evictions == 1 == rec.evictions
        assert ("decode-replica-0", "open") in rec.breaker_states and (0, "evicted") in rec.replica_states
        assert fleet.balancer.eligible_arms() == [1]
        for s in range(16):
            assert fleet.route(np.random.default_rng(s).integers(0, VOCAB, SEQ).astype(np.int32))[0] == 1
        assert fleet.replicas[0].flight.replica_state == "evicted"
        await _readmit(fleet, 0)
        assert fleet.replica_states() == ["up", "up"]
        assert fleet.stat_recoveries == 1 == rec.recoveries
        assert ("decode-replica-0", "half_open") in rec.breaker_states
        assert ("decode-replica-0", "closed") in rec.breaker_states
        assert fleet.balancer.eligible_arms() == [0, 1] and fleet.replicas[0].flight.replica_state == "up"
    finally:
        await fleet.close()


async def test_tick_stagnation_reads_as_a_miss(params):
    """A hung round answers host-side probes: healthy only while ticks move
    with slots active."""
    _, tp, _ = params
    fleet = _fleet(tp, 2, "resil-ticks", warm=False)
    try:
        r0 = fleet.replicas[0]
        probe = {"replica_id": 0, "queue_depth": 3, "active": 1, "ticks": 7, "closed": False}
        r0.health_probe = lambda: dict(probe)
        assert fleet._probe_ok(0, r0) is True and fleet.balancer.depths[0] == 3
        assert fleet._probe_ok(0, r0) is False
        probe["ticks"] = 8
        assert fleet._probe_ok(0, r0) is True
        probe["active"] = 0
        assert fleet._probe_ok(0, r0) is True
    finally:
        await fleet.close()


@pytest.mark.parametrize("pipeline", ["off", "on"])
async def test_hung_replica_evicted_by_stagnation_and_aborted(params, monkeypatch, pipeline):
    from seldon_core_tpu_torch.telemetry import flight

    monkeypatch.setenv(flight.ENGINE_DECODE_PIPELINE, pipeline)
    _, tp, oracle = params
    fleet = _fleet(tp, 2, f"resil-hang-{pipeline}", health_miss_threshold=2)
    prompts = [_prompt_for_arm(fleet, a, seed0=40 * a) for a in (0, 1)]
    install_decode_faults(fleet.replicas[0], DecodeFaultSpec(hang_at_round=2, hang_s=30.0))
    tasks = [asyncio.ensure_future(fleet.submit(p)) for p in prompts]
    for _ in range(200):
        await asyncio.sleep(0.02)
        fleet.poll_fleet_once()
        if fleet.replica_states()[0] == "evicted":
            break
    assert fleet.replica_states() == ["evicted", "up"] and fleet.stat_migrations >= 1
    np.testing.assert_array_equal(np.stack(await asyncio.gather(*tasks)), oracle(np.stack(prompts)))
    t0 = time.perf_counter()
    await fleet.close()  # aborts the still-hung replica
    assert time.perf_counter() - t0 < 5.0
    fleet.allocator_audits()


# ------------------------------------------------- the abort repair (step 0)
@pytest.mark.parametrize("pipeline", ["off", "on"])
async def test_abort_of_a_stuck_replica_does_not_hold_the_loop(params, monkeypatch, pipeline):
    """A replica whose worker is stuck in a readback stall is aborted while a
    sibling serves: the sibling's request is answered within 1 s (an abort
    that waits for the worker on the loop's thread holds it for the whole
    stall), and the aborted allocator passes its audit."""
    from seldon_core_tpu_torch.telemetry import flight

    monkeypatch.setenv(flight.ENGINE_DECODE_PIPELINE, pipeline)
    _, tp, oracle = params
    fleet = _fleet(tp, 2, f"abort-{pipeline}")
    stuck, other = fleet.replicas
    state = install_decode_faults(stuck, DecodeFaultSpec(readback_stall_ms=3000.0, stall_from_round=1))
    victim = asyncio.ensure_future(stuck.submit(_prompt_for_arm(fleet, 0)))
    for _ in range(500):
        if state.injected:
            break
        await asyncio.sleep(0.002)
    assert state.injected == 1  # its worker sleeps in the stall now
    prompt = _prompt_for_arm(fleet, 1, seed0=300)
    t0 = time.perf_counter()
    aborting = asyncio.ensure_future(stuck.abort(timeout_s=5.0))
    out = await asyncio.wait_for(other.submit(prompt), timeout=10.0)
    answered = time.perf_counter() - t0
    assert answered < 1.0, f"the sibling waited {answered:.2f} s behind the abort"
    np.testing.assert_array_equal(out, oracle(prompt[None])[0])
    stuck.pool.alloc.check()  # consistent at once, before the rewrite ran
    await aborting
    assert victim.cancelled()
    stuck.pool.alloc.check()
    assert stuck.active == 0 and stuck.queue_depth == 0
    await other.close()


# ------------------------------------------- migration-correctness oracle
@pytest.mark.parametrize("pipeline", ["off", "on"])
async def test_migration_resumes_bit_identical_at_every_round_boundary(params, monkeypatch, pipeline):
    """Interrupt one generation after exactly k streamed tokens (k = 0 ..
    MAX_NEW - 1, k = 0 dying in the prefill), let the router evict the
    replica and resume on the survivor: the row and the client's stream
    are the uninterrupted run's, nothing streamed twice or skipped, and the
    survivor builds no new dispatch key for the replay."""
    from seldon_core_tpu_torch.telemetry import flight

    monkeypatch.setenv(flight.ENGINE_DECODE_PIPELINE, pipeline)
    _, tp, oracle = params
    rec = _recording_metrics()
    fleet = _fleet(tp, 2, f"resil-migrate-{pipeline}", metrics=rec, health_miss_threshold=2)
    assert fleet.replicas[0]._pipeline_on() is (pipeline == "on")
    try:
        rng = np.random.default_rng(3)
        for k in range(MAX_NEW):
            prompt = rng.integers(0, VOCAB, SEQ).astype(np.int32)
            want = oracle(prompt[None])[0]
            arm = fleet.route(prompt)[0]
            victim = fleet.replicas[arm]
            fired = [k == 0]
            if k == 0:
                install_decode_faults(victim, DecodeFaultSpec(oom_at_round=1))

            def on_token(tok, idx, k=k, victim=victim, fired=fired):
                if idx == k - 1 and not fired[0]:
                    fired[0] = True
                    install_decode_faults(victim, DecodeFaultSpec(oom_at_round=1))

            streamed = []
            out = await fleet.submit(prompt, on_token=lambda t, i, s=streamed, cb=on_token: (s.append((int(t), i)),
                                                                                            cb(t, i)))
            assert fired[0]
            np.testing.assert_array_equal(out, want)
            assert streamed == [(int(t), i) for i, t in enumerate(want[SEQ:])]
            assert fleet.replica_states()[arm] == "evicted"
            await _readmit(fleet, arm)
        assert fleet.stat_evictions == MAX_NEW == rec.evictions
        assert fleet.stat_recoveries == MAX_NEW == rec.recoveries
        assert fleet.stat_migrations == MAX_NEW == rec.migrations
        assert fleet.recompiles_since_warmup() == 0
        fleet.allocator_audits()
    finally:
        await fleet.close()


async def test_resume_teacher_forces_and_suppresses_the_replay(params):
    """``submit(_replay_tokens=)`` on one scheduler: the row is the
    uninterrupted row, only the fresh tokens are streamed, at their global
    indices, whatever the replay (here a wrong one is forced too)."""
    _, tp, oracle = params
    sched = _replica(tp, "replay")
    sched.warmup()
    prompt = np.random.default_rng(8).integers(0, VOCAB, SEQ).astype(np.int32)
    want = oracle(prompt[None])[0]
    for n in range(MAX_NEW):
        streamed = []
        out = await sched.submit(prompt, _replay_tokens=list(want[SEQ:SEQ + n]),
                                 on_token=lambda t, i, s=streamed: s.append((int(t), i)))
        np.testing.assert_array_equal(out, want)
        assert streamed == [(int(t), i + n) for i, t in enumerate(want[SEQ + n:])]
    # the recorded tokens win over the computed ones
    forced = [(int(want[SEQ]) + 1) % VOCAB]
    out = await sched.submit(prompt, _replay_tokens=forced)
    assert out[SEQ] == forced[0]
    assert sched.recompiles_since_warmup() == 0
    await sched.close()


@pytest.mark.parametrize("pipeline", ["off", "on"])
async def test_no_token_is_streamed_after_its_request_left(params, monkeypatch, pipeline):
    """A request cancelled while its round is in flight (here held by a
    readback stall) streams nothing from that round's readback: a migrated
    generation resumes elsewhere from what it had streamed, and a token the
    old replica emitted after the resubmit would reach the client twice."""
    from seldon_core_tpu_torch.telemetry import flight

    monkeypatch.setenv(flight.ENGINE_DECODE_PIPELINE, pipeline)
    _, tp, _ = params
    sched = _replica(tp, f"left-{pipeline}")
    sched.warmup()
    state = install_decode_faults(sched, DecodeFaultSpec(readback_stall_ms=50.0, stall_from_round=3))
    streamed = []
    task = asyncio.ensure_future(sched.submit(np.arange(SEQ).astype(np.int32) % VOCAB,
                                              on_token=lambda t, i: streamed.append(i)))
    for _ in range(500):
        if state.injected:
            break
        await asyncio.sleep(0.001)
    assert state.injected and not task.done()  # a round's readback is held
    n = len(streamed)
    task.cancel()
    await asyncio.sleep(0.3)  # the held readback lands, the slot retires
    assert len(streamed) == n and sched.active == 0
    sched.pool.alloc.check()
    await sched.close()


# --------------------------------------------------------- drain/scale-down
async def test_drain_pushes_prefix_pages_to_rendezvous_sibling(params):
    _, tp, _ = params
    rec = _recording_metrics()
    fleet = _fleet(tp, 2, "resil-drain", metrics=rec)
    heads = {a: _prompt_for_arm(fleet, a, seed0=60 * a) for a in (0, 1)}
    for head in heads.values():
        sharer = head.copy()
        sharer[-1] = (sharer[-1] + 1) % VOCAB
        await fleet.submit(head)
        await fleet.submit(sharer)
    sur_hits = fleet.replicas[1].stat_prefix_hits
    assert fleet.replicas[0]._prefix_index.entries
    res = await fleet.drain_replica(0)
    assert res["replica"] == 0 and res["spilled_entries"] >= 1
    assert fleet.replica_states() == ["down", "up"] and fleet.replicas[0] is None
    assert [i for i, _ in fleet.live_replicas] == [1]
    assert fleet.stat_drains == 1 == rec.drains and (0, "down") in rec.replica_states
    sharer2 = heads[0].copy()
    sharer2[-1] = (sharer2[-1] + 2) % VOCAB
    assert fleet.route(sharer2)[0] == 1
    await fleet.submit(sharer2)
    assert fleet.replicas[1].stat_prefix_hits == sur_hits + 1 and fleet.stat_preseeded_entries >= 1
    with pytest.raises(ValueError, match="last serving replica"):
        await fleet.drain_replica(1)
    with pytest.raises(ValueError, match="does not exist"):
        await fleet.drain_replica(0)
    with pytest.raises(ValueError, match="does not exist"):
        await fleet.drain_replica(5)
    fleet.allocator_audits()
    await fleet.close()


async def test_drain_migrates_stragglers_bit_identical(params):
    """A drain whose budget runs out migrates the generations still in
    flight, which resume on the sibling with their rows intact."""
    _, tp, oracle = params
    fleet = _fleet(tp, 2, "resil-drain-migrate", drain_timeout_ms=0.0)
    prompts = [_prompt_for_arm(fleet, 0, seed0=s) for s in (0, 400)]
    started = asyncio.Event()
    tasks = [asyncio.ensure_future(fleet.submit(p, on_token=lambda t, i: started.set())) for p in prompts]
    await started.wait()
    res = await fleet.drain_replica(0)
    assert res["migrated"] >= 1 and fleet.replica_states() == ["down", "up"]
    np.testing.assert_array_equal(np.stack(await asyncio.gather(*tasks)), oracle(np.stack(prompts)))
    fleet.allocator_audits()
    await fleet.close()


async def test_scale_down_drains_the_coldest_replica(params):
    _, tp, _ = params
    fleet = _fleet(tp, 2, "resil-scale-down")
    try:
        head = _prompt_for_arm(fleet, 1)
        for bump in (0, 1, 2):
            p = head.copy()
            p[-1] = (p[-1] + bump) % VOCAB
            await fleet.submit(p)
        assert fleet.replicas[1].stat_prefix_hits > fleet.replicas[0].stat_prefix_hits
        assert (await fleet.scale_down())["replica"] == 0
        assert fleet.replica_states() == ["down", "up"]
        with pytest.raises(ValueError, match="single-replica fleet"):
            await fleet.scale_down()
    finally:
        await fleet.close()


# ----------------------------------------------------- warm scale-up / spill
async def test_scale_up_boot_failure_is_counted_not_fatal(params):
    _, tp, _ = params
    rec = _recording_metrics()

    def factory(i):
        if i >= 2:
            raise RuntimeError("induced boot failure")
        return _replica(tp, "boot", i)

    fleet = ReplicatedDecodeScheduler(factory, 2, policy="affinity", affinity_block=BLOCK, deployment_name="boot",
                                      seed=0, metrics=rec, autoscale_replicas=3, autoscale_queue_depth=1)
    fleet.warmup()
    try:
        await fleet._scale_up()
        assert fleet.stat_boot_failures == 1 == rec.boot_failures
        assert len(fleet.replicas) == 2 and not fleet._scaling
        out = await fleet.submit(np.arange(SEQ).astype(np.int32) % VOCAB)
        assert len(out) == SEQ + MAX_NEW
    finally:
        await fleet.close()


async def test_warm_scale_up_through_persistence_store(params, tmp_path):
    _, tp, _ = params
    shared = np.arange(SEQ).astype(np.int32) % VOCAB
    a = _replica(tp, "spill-a")
    a.warmup()
    out_a = await a.submit(shared)
    await a.close()
    store = FileStateStore(str(tmp_path))
    assert spill_to_store(a, store, "dep") >= 1
    rec = _recording_metrics()
    b = _replica(tp, "spill-b", metrics=rec)
    seeded = preseed_from_store(b, store, "dep")
    assert seeded >= 1 and b.stat_prefix_preseeded == seeded and rec.preseeded_pages > 0
    b.warmup()
    out_b = await b.submit(shared)
    assert rec.ttft_paths[0] == "warm" and (b.stat_prefix_hits, b.stat_prefix_misses) == (1, 0)
    np.testing.assert_array_equal(out_a, out_b)
    b.pool.alloc.check()
    assert b.recompiles_since_warmup() == 0
    await b.close()


async def test_export_reads_only_the_chosen_pages(params):
    """The spill gathers the chosen entries' page columns, never the pool."""
    _, tp, _ = params
    sched = _replica(tp, "export-pages")
    sched.warmup()
    groups = _group_prompts(n_groups=2, per_group=1, seed=4)
    for q in groups:
        await sched.submit(q)
    reads = []
    real = sched.pool.read_pages
    sched.pool.read_pages = lambda pages: reads.append(list(pages)) or real(pages)
    payload = sched.export_prefix_state(top_n=1)
    entry = max(sched._prefix_index.entries.values(), key=lambda e: (e.hits, e.last_use))
    assert reads == [entry.pages] and len(payload["entries"]) == 1
    full = sched.export_prefix_state()
    assert len(reads[1]) == sum(len(e.pages) for e in sched._prefix_index.entries.values()) < sched.pool.n_pages
    got = {tuple(e["tokens"]) for e in full["entries"]}
    assert got == {tuple(e.tokens) for e in sched._prefix_index.entries.values()}
    await sched.close()


async def test_preseed_spills_int8_bytes_verbatim(params):
    _, tp, _ = params
    shared = (np.arange(SEQ) * 3).astype(np.int32) % VOCAB
    a = _replica(tp, "int8-a", kv_dtype="int8")
    a.warmup()
    await a.submit(shared)
    await a.close()
    payload = a.export_prefix_state()
    assert payload["kv_dtype"] == "int8" and payload["entries"][0]["components"][0].dtype == np.int8
    b = _replica(tp, "int8-b", kv_dtype="int8")
    assert b.preseed_prefix_state(payload) >= 1
    entry = next(iter(b._prefix_index.entries.values()))
    got = b.pool.read_pages(entry.pages)
    for comp, want in zip(got, payload["entries"][0]["components"]):
        np.testing.assert_array_equal(comp, want[:, : len(entry.pages)])
    b.pool.alloc.check()
    assert _replica(tp, "int8-c").preseed_prefix_state(payload) == 0  # geometry mismatch skipped


async def test_preseed_skips_truncated_spill_and_releases_pin(params):
    _, tp, _ = params
    a = _replica(tp, "trunc-a")
    a.warmup()
    await a.submit(np.arange(SEQ).astype(np.int32) % VOCAB)
    await a.close()
    payload = a.export_prefix_state()
    payload["entries"][0]["components"][1] = payload["entries"][0]["components"][1][:, :0]
    b = _replica(tp, "trunc-b")
    assert b.preseed_prefix_state(payload) == 0
    assert len(b._prefix_index.entries) == 0
    b.pool.alloc.check()


class FakeClock:
    """The router module's ``time``, with a monotonic clock the test moves."""

    def __init__(self, t: float = 1000.0):
        self.t = t
        self.perf_counter = time.perf_counter

    def monotonic(self) -> float:
        return self.t


async def test_autoscale_boots_preseeded_replica(params, monkeypatch):
    """Queue depth held at the threshold for AUTOSCALE_STREAK ticks and
    AUTOSCALE_HOLD_S seconds of the router's clock boots one replica,
    pre-seeded with the hottest replica's prefix pages. The clock is the
    module's, patched: no wall-clock window to lose under load."""
    _, tp, oracle = params
    clock = FakeClock()
    monkeypatch.setattr(router, "time", clock)
    built = []

    def factory(i):
        built.append(i)
        return _replica(tp, "auto", i, n_slots=1)

    fleet = ReplicatedDecodeScheduler(factory, 1, policy="affinity", affinity_block=BLOCK, autoscale_replicas=2,
                                      autoscale_queue_depth=1, deployment_name="auto", seed=0)
    fleet.warmup()
    prompts = _group_prompts(n_groups=2, per_group=4)
    await fleet.submit(prompts[0])  # the scale-up has pages to spill
    pending = [asyncio.ensure_future(fleet.submit(q)) for q in prompts[1:]]
    for _ in range(20):  # every submit queued: one admitted, the rest waiting
        await asyncio.sleep(0)
        if fleet.queue_depth >= 5:
            break
    assert fleet.queue_depth >= 5 and not fleet._scaling
    fleet._autoscale_tick()
    assert not fleet._scaling  # hot, but not held
    clock.t += fleet.AUTOSCALE_HOLD_S / 2
    fleet._autoscale_tick()
    assert not fleet._scaling
    clock.t += fleet.AUTOSCALE_HOLD_S / 2
    fleet._autoscale_tick()
    assert fleet._scaling
    await fleet._scale_task
    outs = await asyncio.gather(*pending)
    assert built == [0, 1] and len(fleet.replicas) == 2 and fleet.stat_scale_ups == 1
    assert fleet.stat_preseeded_entries >= 1 and len(fleet.replicas[1]._prefix_index.entries) >= 1
    np.testing.assert_array_equal(np.stack(outs), oracle(np.stack(prompts[1:])))
    assert fleet.replica_states() == ["up", "up"] and fleet.balancer.n_arms == 2
    assert fleet.recompiles_since_warmup() == 0
    fleet.allocator_audits()
    await fleet.close()


async def test_a_burst_below_the_hold_never_scales(params, monkeypatch):
    _, tp, _ = params
    clock = FakeClock()
    monkeypatch.setattr(router, "time", clock)
    fleet = ReplicatedDecodeScheduler(lambda i: _replica(tp, "burst", i, n_slots=1), 1, affinity_block=BLOCK,
                                      autoscale_replicas=2, autoscale_queue_depth=1, deployment_name="burst")
    fleet.warmup()
    pending = [asyncio.ensure_future(fleet.submit(q)) for q in _group_prompts(1, 6)]
    for _ in range(20):
        await asyncio.sleep(0)
        if fleet.queue_depth >= 4:
            break
    assert fleet.queue_depth >= 4
    for _ in range(10):
        fleet._autoscale_tick()
        clock.t += fleet.AUTOSCALE_HOLD_S / 20
    assert not fleet._scaling and len(fleet.replicas) == 1
    await asyncio.gather(*pending)
    await fleet.close()


async def test_depth_ttl_tied_to_poll_interval(params):
    _, tp, _ = params
    polled = _fleet(tp, 2, "ttl-polled", warm=False, health_poll_ms=40.0)
    unpolled = _fleet(tp, 2, "ttl-unpolled", warm=False)
    assert polled.balancer.depth_ttl_s == pytest.approx(0.12)
    assert unpolled.balancer.depth_ttl_s == AffinityBalancer.DEPTH_TTL_S
    await polled.close()
    await unpolled.close()


# ---------------------------------------------- serving wiring and feedback
def _gpt_tpu(**extra):
    return {"max_batch": 4, "batch_buckets": [4], "batch_timeout_ms": 2.0, "decode_slots": 2,
            "decode_prefix_slots": 8, "decode_kv_page_size": 4, **extra}


def _gpt_dep(name, tpu) -> dict:
    params = [("model", "tiny_gpt", "STRING"), ("seq", str(SEQ), "INT"), ("max_new_tokens", str(MAX_NEW), "INT"),
              ("vocab", str(VOCAB), "INT"), ("hidden", "32", "INT"), ("layers", "1", "INT"), ("ffn", "64", "INT"),
              ("max_len", "32", "INT")]
    return {"spec": {"name": name, "predictors": [{
        "name": "main", "tpu": tpu,
        "graph": {"name": "gpt", "type": "MODEL", "implementation": "JAX_MODEL",
                  "parameters": [{"name": n, "value": v, "type": t} for n, v, t in params]}}]}}


def _servers(obj: dict, name: str):
    """(JAX server, port server) of one deployment dict, both warmed."""
    from seldon_core_tpu.graph.defaulting import default_deployment as jax_default
    from seldon_core_tpu.graph.spec import SeldonDeployment as JaxDeployment
    from seldon_core_tpu.graph.validation import validate_deployment as jax_validate
    from seldon_core_tpu.serving.server import PredictorServer as JaxServer
    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.graph.validation import validate_deployment
    from seldon_core_tpu_torch.serving.server import PredictorServer

    jdep = jax_default(JaxDeployment.from_dict(json.loads(json.dumps(obj))))
    jax_validate(jdep)
    dep = default_deployment(SeldonDeployment.from_dict(obj), n_devices=1)
    validate_deployment(dep)
    theirs = JaxServer(jdep.spec.predictors[0], deployment_name=f"jax-{name}")
    ours = PredictorServer(dep.spec.predictors[0], deployment_name=name, device="cpu")
    theirs.warmup()
    ours.warmup()
    return theirs, ours


async def _stop(*servers):
    for s in servers:
        if s.batcher is not None:
            await s.batcher.close()
        if s.decode_scheduler is not None:
            await s.decode_scheduler.close()


async def test_serving_builds_the_fleet_and_slo_rewards_arms():
    """Served with SLO targets: a buffered reply carries each row's verdict
    and serving arm, the service rewards those arms with no client call,
    and a client's feedback moves them again, as in the JAX package."""
    obj = _gpt_dep("rep-slo", _gpt_tpu(decode_replicas=2, decode_router_policy="affinity",
                                       decode_slo_ttft_ms=60000.0))
    theirs, ours = _servers(obj, "rep-slo")
    for server in (theirs, ours):
        assert len(server.decode_scheduler.replicas) == 2
    assert isinstance(ours.decode_scheduler, ReplicatedDecodeScheduler)
    rows = np.stack(_group_prompts(n_groups=2, per_group=1))
    from seldon_core_tpu.core.message import SeldonMessage as JaxMessage

    jout = await theirs.service.predict(JaxMessage.from_array(rows))
    out = await ours.service.predict(SeldonMessage.from_array(rows))
    np.testing.assert_array_equal(np.asarray(out.array), np.asarray(jout.array))
    for key in ("slo", "replica", "gen_lens"):
        assert out.meta.tags[key] == jout.meta.tags[key], key
    sched = ours.decode_scheduler
    assert out.meta.tags["slo"] == ["met", "met"]
    assert sched.balancer.counts == theirs.decode_scheduler.balancer.counts and sum(sched.balancer.counts) == 2
    assert all(sched.balancer.arm_estimate(int(a)) == 1.0 for a in out.meta.tags["replica"])
    await ours.service.send_feedback(Feedback(response=out, reward=0.0))
    assert sum(sched.balancer.counts) == 4
    await _stop(theirs, ours)


async def test_example_replicated_deployment_serves_in_both_packages():
    """examples/deployments/tiny_gpt_replicated.json, its port copy the
    same file: the same verdict, the same replies, arms and SLO rewards."""
    obj = json.loads((ROOT / "examples" / "deployments" / "tiny_gpt_replicated.json").read_text())
    port_copy = json.loads((ROOT / "seldon_core_tpu_torch" / "deployments" / "tiny_gpt_replicated.json").read_text())
    assert port_copy == obj
    theirs, ours = _servers(obj, "ex-rep")
    sched = ours.decode_scheduler
    assert isinstance(sched, ReplicatedDecodeScheduler) and len(sched.replicas) == 2
    assert (sched.autoscale_replicas, sched.autoscale_queue_depth) == (3, 8)
    shared = np.random.default_rng(0).integers(0, 256, 64).astype(np.int32)
    rows = np.stack([shared, shared])
    from seldon_core_tpu.core.message import Meta as JaxMeta
    from seldon_core_tpu.core.message import SeldonMessage as JaxMessage

    tags = {"max_new_tokens": 4, "cache_prefix": 48}
    jout = await theirs.service.predict(JaxMessage.from_array(rows, meta=JaxMeta(tags=dict(tags))))
    out = await ours.service.predict(SeldonMessage.from_array(rows, meta=Meta(tags=dict(tags))))
    arr = np.asarray(out.array)
    assert arr.shape == (2, 68) and np.array_equal(arr[0], arr[1])
    np.testing.assert_array_equal(arr, np.asarray(jout.array))
    assert out.meta.tags["replica"] == jout.meta.tags["replica"] and len(set(out.meta.tags["replica"])) == 1
    assert out.meta.tags["slo"] == jout.meta.tags["slo"] == ["met", "met"]
    assert sum(sched.balancer.counts) == 2 and sched.recompiles_since_warmup() == 0
    sched.allocator_audits()
    await _stop(theirs, ours)


async def test_fleet_operator_routes_like_the_jax_rest_app(params):
    """GET /decode/fleet and POST /decode/drain[?replica=n]: the JAX REST
    app's bodies and codes, with a fleet and without one."""
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.serving.rest import build_app
    from tests.conftest import free_port

    async def port_call(server, method, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\nConnection: close\r\n\r\n"
                     .encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        return int(head.split(b" ", 2)[1]), json.loads(body)

    calls = [("GET", "/decode/fleet"), ("POST", "/decode/drain?replica=x"), ("POST", "/decode/drain?replica=1"),
             ("GET", "/decode/fleet"), ("POST", "/decode/drain?replica=1"), ("POST", "/decode/drain"),
             ("POST", "/decode/drain?replica=0")]
    for tpu, name in ((_gpt_tpu(decode_replicas=2), "ops-fleet"), (_gpt_tpu(), "ops-single")):
        theirs, ours = _servers(_gpt_dep(name, tpu), name)
        client = TestClient(TestServer(build_app(theirs.service)))
        await client.start_server()
        await ours.start("127.0.0.1", free_port())
        try:
            for method, path in calls:
                r = await client.request(method, path)
                want = (r.status, await r.json())
                got = await port_call(ours, method, path)
                assert got == want, (name, method, path)
        finally:
            await client.close()
            await ours.stop()
            await _stop(theirs)
        if name == "ops-fleet":
            assert ours.decode_scheduler.replica_states() == ["up", "down"]
        else:
            assert want[0] == 400


async def test_prefix_affinity_router_in_lockstep_with_jax():
    """The PREFIX_AFFINITY ROUTER as a graph node, in both packages on the
    same requests: the same branch per request, the same learning from
    feedback, depth ingestion and the pickled state."""
    from seldon_core_tpu.core.message import Feedback as JaxFeedback
    from seldon_core_tpu.core.message import Meta as JaxMeta
    from seldon_core_tpu.core.message import SeldonMessage as JaxMessage
    from seldon_core_tpu.engine import build_executor as jax_build
    from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictor
    from seldon_core_tpu_torch.engine.builtin import _NOT_PORTED, PrefixAffinityRouterUnit
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    assert _NOT_PORTED == ()
    pred = {"name": "p", "graph": {
        "name": "router", "type": "ROUTER", "implementation": "PREFIX_AFFINITY",
        "parameters": [{"name": "block", "value": str(BLOCK), "type": "INT"},
                       {"name": "seed", "value": "0", "type": "INT"},
                       {"name": "epsilon", "value": "0.2", "type": "FLOAT"}],
        "children": [{"name": f"m{i}", "type": "MODEL", "implementation": "SIMPLE_MODEL"} for i in range(3)]}}
    ours = build_executor(PredictorSpec.from_dict(pred), context={"device": CPU})
    theirs = jax_build(JaxPredictor.model_validate(pred))
    unit = ours.root.unit
    assert isinstance(unit, PrefixAffinityRouterUnit) and unit.consumes_slo_feedback
    rng = np.random.default_rng(5)
    prompts = _group_prompts(n_groups=4, per_group=3) + [rng.integers(0, VOCAB, 2).astype(np.int32)] * 6
    routes = []
    for i, p in enumerate(prompts):
        out = await ours.execute(SeldonMessage.from_array(p[None, :]))
        jout = await theirs.execute(JaxMessage.from_array(p[None, :]))
        assert out.meta.routing == jout.meta.routing
        routes.append(out.meta.routing["router"])
        reward = float(i % 3 == 0)
        resp = SeldonMessage(meta=Meta(puid=str(i), routing=dict(out.meta.routing)))
        await ours.send_feedback(Feedback(response=resp, reward=reward))
        await theirs.send_feedback(JaxFeedback(response=JaxMessage(meta=JaxMeta(puid=str(i),
                                                                               routing=dict(jout.meta.routing))),
                                               reward=reward))
    for g in range(4):
        assert len(set(routes[3 * g:3 * g + 3])) == 1
    jbal = theirs.root.unit.balancer
    assert (unit.balancer.counts, unit.balancer.rewards) == (jbal.counts, jbal.rewards)
    unit.observe_depth(0, 50)
    assert unit.balancer.depths[0] == 50
    state = pickle.loads(pickle.dumps(unit.__getstate__()))
    unit.__setstate__(state)
    assert unit.balancer.counts == jbal.counts
