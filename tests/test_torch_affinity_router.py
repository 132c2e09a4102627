"""The pure part of the port's replicated decode fleet
(seldon_core_tpu_torch/serving/affinity_router.py) held to the JAX
package's (seldon_core_tpu/serving/affinity_router.py) on the same inputs:

- the prefix-key helpers give what the JAX ones give, over lengths,
  windows, blocks and prompts;
- ``AffinityBalancer`` driven in lockstep with the JAX one over a seeded
  sequence of keys, depths, rewards and eligibility flips makes the same
  pick, for the same reason, for every policy and fallback;
- ``add_arm``, the pickle round trip and the bad-config messages
  (tests/test_replica_routing.py's balancer contracts).
"""

import pickle
import random

import numpy as np
import pytest

from seldon_core_tpu.serving import affinity_router as jax_router
from seldon_core_tpu_torch.serving import affinity_router as router
from seldon_core_tpu_torch.serving import decode_scheduler

SEQ = 12
BLOCK = 4


@pytest.mark.parametrize("length", [-3, 0, 1, 5, SEQ - 1, SEQ, SEQ + 10])
@pytest.mark.parametrize("seq_len", [0, 1, 4, SEQ])
def test_usable_prefix_len_like_jax(length, seq_len):
    assert router.usable_prefix_len(length, seq_len) == jax_router.usable_prefix_len(length, seq_len)


@pytest.mark.parametrize("length,ctx,seq_len", [(10, 6, SEQ), (10, 64, 8), (3, 6, SEQ), (0, 6, SEQ), (-1, 4, 4),
                                                (7, 0, SEQ), (SEQ, SEQ, SEQ)])
def test_capture_prefix_len_like_jax(length, ctx, seq_len):
    assert router.capture_prefix_len(length, ctx, seq_len) == jax_router.capture_prefix_len(length, ctx, seq_len)


def test_scheduler_takes_the_helpers_from_the_router():
    """One copy of the normalization, as in the JAX package."""
    assert decode_scheduler.usable_prefix_len is router.usable_prefix_len
    assert decode_scheduler.capture_prefix_len is router.capture_prefix_len


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("block", [0, 1, BLOCK, 16])
@pytest.mark.parametrize("seq_len", [0, BLOCK, SEQ])
def test_prefix_route_key_like_jax(seed, block, seq_len):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 96, int(rng.integers(0, 2 * SEQ))).astype(np.int32)
    got = router.prefix_route_key(prompt, block=block, seq_len=seq_len)
    assert got == jax_router.prefix_route_key(prompt, block=block, seq_len=seq_len)
    assert all(type(t) is int for t in got)


def test_prefix_route_key_normalization():
    prompt = np.arange(SEQ).astype(np.int32)
    assert router.prefix_route_key(prompt, block=BLOCK) == (0, 1, 2, 3)
    assert router.prefix_route_key(prompt[: BLOCK - 1], block=BLOCK) == ()
    assert router.prefix_route_key(prompt[:BLOCK], block=BLOCK, seq_len=BLOCK) == ()
    assert router.prefix_route_key(list(prompt), block=BLOCK, seq_len=SEQ) == (0, 1, 2, 3)


@pytest.mark.parametrize("seed", range(4))
def test_rendezvous_rank_like_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(32):
        key = tuple(int(x) for x in rng.integers(0, 50257, BLOCK))
        for arm in range(5):
            assert router._key_rank(key, arm) == jax_router._key_rank(key, arm)


def test_replica_state_values_like_jax():
    for state in ("up", "draining", "evicted", "down", "bogus"):
        assert router.replica_state_value(state) == jax_router.replica_state_value(state)
    assert (router.MAX_MIGRATIONS, router.DEFAULT_AFFINITY_BLOCK, router.ROUTER_POLICIES,
            router.FALLBACK_POLICIES) == (jax_router.MAX_MIGRATIONS, jax_router.DEFAULT_AFFINITY_BLOCK,
                                          jax_router.ROUTER_POLICIES, jax_router.FALLBACK_POLICIES)


def _lockstep(policy, fallback, epsilon, n_arms, seed, steps=300):
    """The same seeded script of picks (keyed, keyless, with depths or the
    observed ones), rewards, depth observations and eligibility flips on
    both balancers; every pick and reason must agree, and so must the end
    state."""
    kw = dict(policy=policy, fallback=fallback, epsilon=epsilon, seed=seed)
    ours, theirs = router.AffinityBalancer(n_arms, **kw), jax_router.AffinityBalancer(n_arms, **kw)
    rng = random.Random(1000 + seed)
    keys = [tuple(rng.randrange(97) for _ in range(BLOCK)) for _ in range(12)] + [()]
    picks = []
    for step in range(steps):
        op = rng.random()
        if op < 0.55:
            key = rng.choice(keys)
            depths = None if rng.random() < 0.3 else [rng.randrange(12) for _ in range(n_arms)]
            got = ours.pick(key, depths)
            assert got == theirs.pick(key, depths), step
            picks.append(got)
        elif op < 0.8:
            arm, r = rng.randrange(n_arms + 1), rng.choice([0.0, 0.25, 1.0, 1.7, -0.5])
            ours.reward(arm, r)
            theirs.reward(arm, r)
        elif op < 0.9:
            arm, d = rng.randrange(n_arms), rng.randrange(20)
            ours.observe_depth(arm, d)
            theirs.observe_depth(arm, d)
        else:
            arm, ok = rng.randrange(n_arms), rng.random() < 0.6
            ours.set_eligible(arm, ok)
            theirs.set_eligible(arm, ok)
        assert ours.eligible_arms() == theirs.eligible_arms()
    for field in ("counts", "rewards", "alpha", "beta", "depths", "stat_routes"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert [ours.arm_estimate(a) for a in range(n_arms)] == [theirs.arm_estimate(a) for a in range(n_arms)]
    return picks


@pytest.mark.parametrize("policy,fallback,epsilon", [
    ("affinity", "epsilon_greedy", 0.1),
    ("affinity", "epsilon_greedy", 0.0),
    ("affinity", "thompson", 0.1),
    ("round_robin", "epsilon_greedy", 0.1),
    ("bandit", "epsilon_greedy", 0.3),
    ("bandit", "thompson", 0.1),
])
@pytest.mark.parametrize("n_arms,seed", [(2, 0), (3, 7), (5, 11)])
def test_balancer_in_lockstep_with_jax(policy, fallback, epsilon, n_arms, seed):
    picks = _lockstep(policy, fallback, epsilon, n_arms, seed)
    reasons = {r for _, r in picks}
    if policy == "round_robin":
        assert reasons == {"round_robin"}
    elif policy == "bandit":
        assert reasons == {"fallback"}
    else:
        assert "affinity" in reasons and "fallback" in reasons


def test_bounded_load_sheds_to_second_rank():
    bal = router.AffinityBalancer(3, seed=0)
    key = (1, 2, 3, 4)
    home = bal.pick(key, [0, 0, 0])[0]
    depths = [0, 0, 0]
    depths[home] = 100
    shed_arm, reason = bal.pick(key, depths)
    assert reason == "shed" and shed_arm != home
    assert all(bal.pick(key, depths)[0] == shed_arm for _ in range(5))
    assert bal.pick(key, [1, 1, 1]) == (home, "affinity")


def test_add_arm_moves_minority_of_keyspace_like_jax():
    ours, theirs = router.AffinityBalancer(4, seed=0), jax_router.AffinityBalancer(4, seed=0)
    keys = [(i, i + 1, i + 2) for i in range(200)]
    before = {k: ours.pick(k, [0] * 4)[0] for k in keys}
    assert ours.add_arm() == theirs.add_arm() == 4
    after = {k: ours.pick(k, [0] * 5)[0] for k in keys}
    assert after == {k: theirs.pick(k, [0] * 5)[0] for k in keys}
    moved = sum(1 for k in keys if after[k] != before[k])
    assert 0 < moved < len(keys) // 2
    assert all(after[k] in (before[k], 4) for k in keys)
    assert ours.n_arms == 5 and ours.eligible_arms() == [0, 1, 2, 3, 4]


def test_balancer_pickles_and_restores_its_lock():
    bal = router.AffinityBalancer(2, seed=3)
    bal.reward(1, 1.0)
    bal.set_eligible(0, False)
    clone = pickle.loads(pickle.dumps(bal))
    assert clone.counts == bal.counts and clone.rewards == bal.rewards
    assert clone.eligible_arms() == [1]
    clone.reward(0, 0.5)  # the restored lock works
    # a checkpoint from before the fault-tolerance fields restores them
    state = bal.__getstate__()
    del state["_eligible"], state["depth_ttl_s"]
    old = object.__new__(router.AffinityBalancer)
    old.__setstate__(state)
    assert old.eligible_arms() == [0, 1] and old.depth_ttl_s == router.AffinityBalancer.DEPTH_TTL_S


@pytest.mark.parametrize("args,kw", [((0,), {}), ((2,), {"policy": "nope"}), ((2,), {"fallback": "nope"})])
def test_bad_config_messages_like_jax(args, kw):
    with pytest.raises(ValueError) as ours:
        router.AffinityBalancer(*args, **kw)
    with pytest.raises(ValueError) as theirs:
        jax_router.AffinityBalancer(*args, **kw)
    assert str(ours.value) == str(theirs.value)


class FakeClock:
    """The router module's ``time``, with a monotonic clock the test moves."""

    def __init__(self, t: float = 100.0):
        self.t = t
        self.perf_counter = __import__("time").perf_counter

    def monotonic(self) -> float:
        return self.t


def test_stale_depth_decays_after_its_ttl(monkeypatch):
    """A dead poller's last spike stops shedding after the TTL (the module's
    clock patched: no sleep)."""
    clock = FakeClock()
    monkeypatch.setattr(router, "time", clock)
    bal = router.AffinityBalancer(2, seed=0, depth_ttl_s=0.05)
    key = (1, 2, 3, 4)
    home = bal.pick(key)[0]
    bal.observe_depth(home, 100)
    shed_arm, reason = bal.pick(key)
    assert reason == "shed" and shed_arm != home
    clock.t += 0.06
    assert bal.pick(key) == (home, "affinity")


def test_spill_key_and_preseed_switch_like_jax(monkeypatch):
    assert router.spill_key("dep") == jax_router.spill_key("dep")
    assert router.spill_key("") == jax_router.spill_key("")
    for value, on in (("off", False), ("0", False), ("FALSE", False), ("on", True), ("1", True)):
        monkeypatch.setenv("ENGINE_DECODE_REPLICA_PRESEED", value)
        assert router.preseed_enabled() is on is jax_router.preseed_enabled()
    monkeypatch.delenv("ENGINE_DECODE_REPLICA_PRESEED")
    assert router.preseed_enabled() and jax_router.preseed_enabled()


class _Exporter:
    def __init__(self, payload):
        self.payload = payload
        self.seeded = None

    def export_prefix_state(self, top_n=0):
        return self.payload

    def preseed_prefix_state(self, payload):
        self.seeded = payload
        return len(payload["entries"])


def test_spill_and_preseed_through_a_store(tmp_path):
    from seldon_core_tpu_torch.persistence.state import FileStateStore

    store = FileStateStore(str(tmp_path))
    payload = {"page_size": 4, "kv_dtype": "", "entries": [
        {"tokens": np.arange(8, dtype=np.int32), "components": [np.ones((1, 2, 4), np.int16)]}]}
    assert router.spill_to_store(_Exporter(None), store, "dep") == 0
    assert router.spill_to_store(_Exporter({**payload, "entries": []}), store, "dep") == 0
    assert router.preseed_from_store(_Exporter(None), store, "dep") == 0  # nothing stored yet
    assert router.spill_to_store(_Exporter(payload), store, "dep") == 1
    target = _Exporter(None)
    assert router.preseed_from_store(target, store, "dep") == 1
    np.testing.assert_array_equal(target.seeded["entries"][0]["components"][0], payload["entries"][0]["components"][0])
    store.save(router.spill_key("dep"), b"not a pickle")
    assert router.preseed_from_store(_Exporter(None), store, "dep") == 0  # a corrupt spill is ignored
