"""The replicated decode fleet: prefix-affinity routing, reward-driven load
balancing, health eviction with migration, drain and warm scale-up.

Port of ``seldon_core_tpu/serving/affinity_router.py``. N continuous-batching
scheduler replicas (``serving/decode_scheduler.py``) serve one endpoint:

- **Prefix-affinity routing**: a prompt's key is its leading block (the
  normalization prefix admission applies, ``usable_prefix_len``), hashed
  rendezvous-style over the replicas, so every request sharing a system
  prompt lands on the replica whose prefix index already holds its pages,
  while distinct groups spread. ``round_robin`` and ``bandit`` are the
  other policies.
- **Bounded-load shed**: when the key's home runs past ``load_factor`` x
  the fleet mean (+1), the pick goes to the key's second rendezvous rank
  if that one is shallower, so an overflowing group stays warm on one
  deterministic overflow replica.
- **Reward-driven fallback**: a prompt with no key (shorter than one
  block) rides per-replica bandit arms, epsilon-greedy or Thompson, which
  the SLO verdicts of ``meta.tags.slo`` and client feedback reward
  (``serving/service.py``).
- **Sibling pull**: before a request prefills cold on a replica that holds
  its leading block in none of its tiers, the key's rendezvous home is
  asked for the entry (``export_prefix_entry``), which is pre-seeded into
  the replica's pool.
- **Health and migration**: a poller probes every replica each interval
  (``health_probe``), feeds its queue depth to the balancer and counts
  consecutive misses (a dropped probe, or active slots with no tick
  progress) into a per-replica circuit breaker. An open breaker evicts the
  replica from routing and migrates its tracked generations: each resubmits
  on a survivor with the tokens it already streamed as a teacher-forced
  replay (``DecodeScheduler.submit(_replay_tokens=)``), so the stream
  resumes at the next token, bit-identical to an uninterrupted greedy run.
  A half-open probe readmits the replica. ``drain_replica`` and
  ``scale_down`` stop admission, finish or migrate in-flight work, spill
  the prefix pages to the store and push each entry to its new rendezvous
  home, then close the replica. Every state write goes through
  ``_set_replica_state``.
- **Warm scale-up**: a queue depth held at ``autoscale_queue_depth`` boots
  one more replica off the event loop, pre-seeded with the hottest
  replica's prefix pages round-tripped through the persistence store.

On one card every replica shares the runtime's parameter tensors and owns
its page pool, prefix index, graph cache, stream and worker thread, so a
replica's dispatches run on its own stream only. The graph caches are per
replica: a capture on a serving replica after its warmup counts in
``recompiles_since_warmup`` whatever a sibling does.

The pure part (the helpers, ``AffinityBalancer``, the spill helpers) is
stdlib and numpy only, so it makes the JAX package's picks from the same
seed.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import pickle
import random
import threading
import time

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.engine.resilience import CLOSED, OPEN, CircuitBreaker, current_deadline
from seldon_core_tpu_torch.graph.spec import BreakerSpec
from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch.persistence.state import state_key
from seldon_core_tpu_torch.utils.env import ENGINE_DECODE_REPLICA_PRESEED

log = logging.getLogger(__name__)

# one KV page of tokens (the pool's default page size)
DEFAULT_AFFINITY_BLOCK = 16

ROUTER_POLICIES = ("affinity", "round_robin", "bandit")
FALLBACK_POLICIES = ("epsilon_greedy", "thompson")

# replica lifecycle:
#   up --(breaker opens)--> evicted --(half-open probe ok)--> up
#   up --(drain_replica)--> draining --(spill + close)--> down   (terminal)
REPLICA_UP = "up"
REPLICA_DRAINING = "draining"
REPLICA_EVICTED = "evicted"
REPLICA_DOWN = "down"

_REPLICA_STATE_VALUES = {REPLICA_UP: 0, REPLICA_DRAINING: 1, REPLICA_EVICTED: 2, REPLICA_DOWN: 3}

# a request may survive this many replica deaths; a prompt that kills every
# replica it lands on fails instead of cycling the fleet
MAX_MIGRATIONS = 3


def replica_state_value(state: str) -> int:
    """The seldon_tpu_replica_state gauge's encoding of a state."""
    return _REPLICA_STATE_VALUES.get(state, -1)


def usable_prefix_len(length: int, seq_len: int) -> int:
    """The longest reusable span of a matched prefix: at most seq_len - 1,
    since the last prompt position's logits give the first generated
    token and must be computed. Degenerate inputs give 0."""
    return max(0, min(int(length), int(seq_len) - 1))


def capture_prefix_len(length: int, prefix_ctx: int, seq_len: int) -> int:
    """The span a slot may capture into the prefix index: the request
    clamped to the prefix window and the prompt. 0: nothing capturable."""
    return max(0, min(int(length), int(prefix_ctx), int(seq_len)))


def prefix_route_key(prompt, *, block: int = DEFAULT_AFFINITY_BLOCK, seq_len: int = 0) -> tuple:
    """The prompt's affinity key: its leading ``block`` tokens as a tuple of
    ints, () when the usable span (``usable_prefix_len`` on a ``seq_len``
    bucket) is shorter than one block."""
    n = len(prompt)
    usable = usable_prefix_len(n, seq_len) if seq_len > 0 else n
    if block <= 0 or usable < block:
        return ()
    return tuple(int(t) for t in prompt[:block])


def _key_rank(key: tuple, arm: int) -> int:
    """Rendezvous score of ``arm`` for ``key`` (blake2b: the same in every
    process and in both packages)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(repr(key).encode())
    h.update(arm.to_bytes(4, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


class AffinityBalancer:
    """Host-side routing policy over N replica arms: ``pick(key, depths)``
    (rendezvous with the bounded-load shed, or the fallback arms for a
    keyless request) and ``reward(arm, r)`` with r in [0, 1]. The state is
    plain host data and pickles."""

    # polled depths older than this read as 0 in pick()
    DEPTH_TTL_S = 30.0

    def __init__(
        self,
        n_arms: int,
        *,
        policy: str = "affinity",
        fallback: str = "epsilon_greedy",
        epsilon: float = 0.1,
        load_factor: float = 1.25,
        depth_ttl_s: float | None = None,
        seed=None,
    ):
        if n_arms < 1:
            raise ValueError(f"balancer needs >= 1 arm, got {n_arms}")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"router policy {policy!r} unsupported (want one of {ROUTER_POLICIES})")
        if fallback not in FALLBACK_POLICIES:
            raise ValueError(f"fallback policy {fallback!r} unsupported (want one of {FALLBACK_POLICIES})")
        self.policy = policy
        self.fallback = fallback
        self.epsilon = float(epsilon)
        self.load_factor = float(load_factor)
        self._rng = random.Random(int(seed)) if seed is not None else random.Random()
        self.counts = [0] * n_arms
        self.rewards = [0.0] * n_arms
        # Thompson: a Beta posterior per arm, in fractional units
        self.alpha = [1.0] * n_arms
        self.beta = [1.0] * n_arms
        # polled queue depths (out-of-process replicas) with their times
        self.depths = [0] * n_arms
        self._depth_ts = [0.0] * n_arms
        # an ineligible arm (evicted, draining, down) keeps its position,
        # since rendezvous ranks are positional, but no pick reaches it
        self._eligible = [True] * n_arms
        self.depth_ttl_s = float(depth_ttl_s) if depth_ttl_s is not None else self.DEPTH_TTL_S
        self._rr = 0
        self._lock = threading.Lock()
        self.stat_routes = {"affinity": 0, "shed": 0, "fallback": 0, "round_robin": 0}

    @property
    def n_arms(self) -> int:
        return len(self.counts)

    def add_arm(self) -> int:
        """One more arm (scale-up): rendezvous moves about 1/N of the keys
        onto it and no key between the old arms."""
        with self._lock:
            self.counts.append(0)
            self.rewards.append(0.0)
            self.alpha.append(1.0)
            self.beta.append(1.0)
            self.depths.append(0)
            self._depth_ts.append(0.0)
            self._eligible.append(True)
            return len(self.counts) - 1

    def set_eligible(self, arm: int, ok: bool) -> None:
        with self._lock:
            if 0 <= arm < len(self._eligible):
                self._eligible[arm] = bool(ok)

    def eligible_arms(self) -> list[int]:
        with self._lock:
            return [i for i, ok in enumerate(self._eligible) if ok]

    def observe_depth(self, arm: int, depth: int) -> None:
        """Ingest a polled queue depth (``/decode/health`` ``queue_depth``)."""
        with self._lock:
            if 0 <= arm < len(self.depths):
                self.depths[arm] = max(0, int(depth))
                self._depth_ts[arm] = time.monotonic()

    def _observed_depths(self) -> list[int]:
        now = time.monotonic()
        return [d if now - t <= self.depth_ttl_s else 0 for d, t in zip(self.depths, self._depth_ts)]

    def pick(self, key, depths=None) -> tuple[int, str]:
        """Route one request: (arm, reason), reason one of affinity | shed |
        fallback | round_robin. A fleet with no eligible arm routes over
        every arm (the submit path's migration surfaces the failure)."""
        with self._lock:
            n = len(self.counts)
            d = [int(x) for x in (depths if depths is not None else self._observed_depths())]
            d += [0] * (n - len(d))
            live = [i for i in range(n) if self._eligible[i]] or list(range(n))
            if self.policy == "round_robin":
                arm = live[self._rr % len(live)]
                self._rr += 1
                self.stat_routes["round_robin"] += 1
                return arm, "round_robin"
            if self.policy == "affinity" and key:
                ranked = sorted(live, key=lambda a: _key_rank(tuple(key), a), reverse=True)
                primary = ranked[0]
                bound = self.load_factor * (sum(d[i] for i in live) / len(live)) + 1.0
                if len(ranked) > 1 and d[primary] > bound and d[ranked[1]] < d[primary]:
                    # a shed moves the key: an even deeper rank 2 keeps it home
                    self.stat_routes["shed"] += 1
                    return ranked[1], "shed"
                self.stat_routes["affinity"] += 1
                return primary, "affinity"
            self.stat_routes["fallback"] += 1
            return self._fallback_pick(d, live), "fallback"

    def _fallback_pick(self, depths, live) -> int:
        if self.fallback == "thompson":
            draws = {i: self._rng.betavariate(self.alpha[i], self.beta[i]) for i in live}
            return int(max(live, key=draws.__getitem__))
        if self._rng.random() < self.epsilon:
            return live[self._rng.randrange(len(live))]
        means = {i: self.rewards[i] / self.counts[i] if self.counts[i] else float("inf") for i in live}
        best = max(means.values())
        # ties (every arm before any reward) break by live load, then index
        tied = [i for i in live if means[i] == best]
        return int(min(tied, key=lambda i: (depths[i], i)))

    def reward(self, arm: int, r: float) -> None:
        """One served request's reward, clamped to [0, 1]; moves both
        estimators, so a policy flip needs no re-learning."""
        if not (0 <= int(arm) < len(self.counts)):
            return
        r = min(1.0, max(0.0, float(r)))
        with self._lock:
            self.counts[arm] += 1
            self.rewards[arm] += r
            self.alpha[arm] += r
            self.beta[arm] += 1.0 - r

    def arm_estimate(self, arm: int) -> float:
        c = self.counts[arm]
        return self.rewards[arm] / c if c else 0.0

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self.__dict__.setdefault("_eligible", [True] * len(self.counts))
        self.__dict__.setdefault("depth_ttl_s", self.DEPTH_TTL_S)


# the state-key unit id a prefix spill rides in the persistence store
SPILL_UNIT = "prefix_pages"


def spill_key(deployment_id: str) -> str:
    return state_key(deployment_id or "decode", SPILL_UNIT)


def spill_to_store(sched, store, deployment_id: str, top_n: int = 0) -> int:
    """Export ``sched``'s hottest prefix entries into a persistence store;
    returns the entries spilled."""
    payload = sched.export_prefix_state(top_n=top_n)
    if payload is None or not payload["entries"]:
        return 0
    store.save(spill_key(deployment_id), pickle.dumps(payload))
    return len(payload["entries"])


def preseed_from_store(sched, store, deployment_id: str) -> int:
    """Pre-seed ``sched``'s pool from a spilled payload; returns the entries
    seeded (0 when the store holds nothing usable)."""
    raw = store.load(spill_key(deployment_id))
    if raw is None:
        return 0
    try:
        payload = pickle.loads(raw)
    except Exception:  # noqa: BLE001 - a corrupt spill must not fail a boot
        log.warning("corrupt prefix spill for %r ignored", deployment_id)
        return 0
    return sched.preseed_prefix_state(payload)


def preseed_enabled() -> bool:
    """ENGINE_DECODE_REPLICA_PRESEED ("off" disables warm pre-seeding and
    the sibling pull; default on)."""
    return os.environ.get(ENGINE_DECODE_REPLICA_PRESEED, "on").lower() not in ("off", "0", "false")


class _TrackedRequest:
    """The router's record of one in-flight generation: the tokens it
    streamed (only fresh ones reach ``on_token``: a resumed leg suppresses
    its replay), its arm and the replica-side task a migration cancels."""

    __slots__ = ("prompt", "tokens", "caller_on_token", "arm", "task", "migrating")

    def __init__(self, prompt, caller_on_token):
        self.prompt = prompt
        self.tokens: list[int] = []
        self.caller_on_token = caller_on_token
        self.arm = -1
        self.task: asyncio.Task | None = None
        self.migrating = False

    def on_token(self, tok: int, idx: int) -> None:
        # a resumed leg's first fresh token comes at idx == len(self.tokens)
        self.tokens.append(int(tok))
        if self.caller_on_token is not None:
            self.caller_on_token(tok, idx)


class ReplicatedDecodeScheduler:
    """N decode scheduler replicas behind the affinity balancer, with the
    single scheduler's serving surface (``submit``, ``execute_message``,
    ``warmup``, ``close``, the stats), so the batcher and the streaming
    ingress drive it unchanged. ``factory(i)`` builds replica i. Greedy
    output is bit-identical to one scheduler under every policy: routing
    decides which pool serves a request, never what it decodes."""

    # a scale-up needs both: this many hot observations, and the queue held
    # hot this long
    AUTOSCALE_STREAK = 3
    AUTOSCALE_HOLD_S = 0.5

    def __init__(
        self,
        factory,
        n_replicas: int,
        *,
        policy: str = "",
        fallback: str = "epsilon_greedy",
        epsilon: float = 0.1,
        load_factor: float = 1.25,
        affinity_block: int = DEFAULT_AFFINITY_BLOCK,
        autoscale_replicas: int = 0,
        autoscale_queue_depth: int = 0,
        spill_store=None,
        spill_store_factory=None,
        health_poll_ms: float = 0.0,
        health_miss_threshold: int = 3,
        drain_timeout_ms: float = 5000.0,
        metrics: NullMetrics | None = None,
        deployment_name: str = "",
        seed: int = 0,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.factory = factory
        self.policy = policy or "affinity"
        self.replicas = [factory(i) for i in range(n_replicas)]
        self.affinity_block = int(affinity_block) or DEFAULT_AFFINITY_BLOCK
        self.autoscale_replicas = int(autoscale_replicas)
        self.autoscale_queue_depth = int(autoscale_queue_depth)
        self.spill_store = spill_store
        # resolved at the first spill: a file store's constructor makes its
        # directory, and most fleets never spill
        self._spill_store_factory = spill_store_factory
        self._metrics = metrics or NullMetrics()
        self._deployment = deployment_name
        self.health_poll_s = max(0.0, float(health_poll_ms)) / 1e3
        self.health_miss_threshold = max(1, int(health_miss_threshold))
        self.drain_timeout_s = max(0.0, float(drain_timeout_ms)) / 1e3
        self.balancer = AffinityBalancer(
            n_replicas,
            policy=self.policy,
            fallback=fallback,
            epsilon=epsilon,
            load_factor=load_factor,
            # a dead poller's last spike decays after about 3 missed polls
            depth_ttl_s=(3.0 * self.health_poll_s if self.health_poll_s > 0 else None),
            seed=seed,
        )
        self._hot_streak = 0
        self._hot_since: float | None = None
        self._scaling = False
        self._scale_task: asyncio.Task | None = None
        self._closed = False
        # per arm, tombstones included; written only by _set_replica_state
        self._replica_states = [REPLICA_UP] * n_replicas
        # threshold consecutive misses open a replica's breaker (eviction);
        # it half-opens after one poll interval and one good probe closes it
        self._breakers = [self._new_breaker(i) for i in range(n_replicas)]
        self._misses = [0] * n_replicas
        self._last_ticks = [-1] * n_replicas
        self._inflight: list[set[_TrackedRequest]] = [set() for _ in range(n_replicas)]
        self._poll_task: asyncio.Task | None = None
        self.stat_scale_ups = 0
        self.stat_preseeded_entries = 0
        self.stat_evictions = 0
        self.stat_recoveries = 0
        self.stat_drains = 0
        self.stat_migrations = 0
        self.stat_boot_failures = 0
        self.stat_spill_failures = 0
        self.stat_health_misses = 0
        # one sibling pull in flight per (target arm, route key): a herd of
        # same-prefix requests awaits one transfer
        self._pulls: dict[tuple, asyncio.Task] = {}
        self.stat_sibling_pulls = 0
        self.stat_sibling_pull_failures = 0
        self._metrics.router_replicas(self._deployment, len(self.replicas))

    def _new_breaker(self, arm: int) -> CircuitBreaker:
        spec = BreakerSpec(
            failure_threshold=self.health_miss_threshold,
            error_rate=1.0,
            window=self.health_miss_threshold,
            reset_ms=max(self.health_poll_s * 1e3, 1.0),
            half_open_probes=1,
        )
        return CircuitBreaker(spec, on_transition=lambda state, a=arm: self._on_breaker(a, state))

    # ------------------------------------------------------------ delegates
    @property
    def live_replicas(self):
        """(arm, replica) pairs that still exist: a drained replica leaves a
        None tombstone, since renumbering would reshuffle rendezvous homes."""
        return [(i, r) for i, r in enumerate(self.replicas) if r is not None]

    @property
    def _r0(self):
        for r in self.replicas:
            if r is not None:
                return r
        raise RuntimeError("decode fleet has no live replicas")

    @property
    def seq_len(self) -> int:
        return self._r0.seq_len

    @property
    def max_new_tokens(self) -> int:
        return self._r0.max_new_tokens

    @property
    def eos_id(self) -> int:
        return self._r0.eos_id

    @property
    def slo_ttft_s(self) -> float:
        return self._r0.slo_ttft_s

    @property
    def slo_itl_s(self) -> float:
        return self._r0.slo_itl_s

    @property
    def prefix_enabled(self) -> bool:
        return self._r0.prefix_enabled

    @property
    def active(self) -> int:
        return sum(r.active for _, r in self.live_replicas)

    @property
    def queue_depth(self) -> int:
        return sum(r.queue_depth for _, r in self.live_replicas)

    def __getattr__(self, name: str):
        # a scheduler counter the fleet does not keep itself sums over it
        if name.startswith("stat_"):
            return sum(getattr(r, name) for r in self.__dict__["replicas"] if r is not None)
        raise AttributeError(name)

    def request_params_from_meta(self, meta: Meta) -> dict:
        return self._r0.request_params_from_meta(meta)

    def warmup(self) -> None:
        """Warm every replica. Each builds its own graph cache, so no
        replica's baseline needs moving after a sibling's warmup."""
        for _, r in self.live_replicas:
            r.warmup()

    def compile_counts(self) -> dict[str, int]:
        return {f"r{i}.{k}": v for i, r in self.live_replicas for k, v in r.compile_counts().items()}

    def recompiles_since_warmup(self) -> int:
        return sum(r.recompiles_since_warmup() for _, r in self.live_replicas)

    async def close(self) -> None:
        self._closed = True
        poll, self._poll_task = self._poll_task, None
        if poll is not None:
            poll.cancel()
            try:
                await poll
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        task = self._scale_task
        if task is not None:
            # a scale-up settles first: cancelling mid-warmup would leak
            # the half-built replica's device state
            try:
                await task
            except Exception:  # noqa: BLE001 - the task logs its own failure
                pass
        # an evicted replica may be hung, which close() would wait on
        await asyncio.gather(*(
            r.abort(timeout_s=self.drain_timeout_s) if self._replica_states[i] == REPLICA_EVICTED else r.close()
            for i, r in self.live_replicas
        ))

    # -------------------------------------------------------------- routing
    def _live_depths(self) -> list[int]:
        """Queue depth plus active slots per arm (tombstones read 0)."""
        return [0 if r is None else r.queue_depth + r.active for r in self.replicas]

    def route(self, prompt) -> tuple[int, str]:
        """The serving replica for one prompt (token ids), and why."""
        key = prefix_route_key(prompt, block=self.affinity_block, seq_len=self.seq_len)
        arm, reason = self.balancer.pick(key, self._live_depths())
        self._metrics.router_route(self._deployment, self.policy, reason)
        return arm, reason

    def _reward_sink(self, arm: int, inner):
        """The streaming path's reward: the row's SLO verdict rewards its
        arm directly (a buffered request rewards through meta.tags.replica
        and ``ingest_feedback`` instead)."""

        def sink(ok: bool) -> None:
            self._reward_arm(arm, 1.0 if ok else 0.0)
            if inner is not None:
                inner(ok)

        return sink

    def _reward_arm(self, arm: int, r: float) -> None:
        self.balancer.reward(arm, r)
        self._metrics.router_arm(self._deployment, arm, self.balancer.arm_estimate(arm))

    async def submit(self, prompt, *, _slo_sink=None, **kw):
        """Route one sequence and submit it, tracked: if its replica is
        evicted, drained or its loop fails, it resubmits on a survivor with
        the streamed tokens as a teacher-forced replay, and the caller's
        stream goes on from the next token."""
        self._ensure_poller()
        self._autoscale_tick()
        out, _arm = await self._submit_routed(prompt, kw, _slo_sink, reward=True)
        return out

    async def _submit_routed(self, prompt, kw: dict, slo_sink, *, reward: bool) -> tuple[np.ndarray, int]:
        """The tracked submit and migrate loop: (result, serving arm).
        ``reward`` wires the streaming path's SLO-to-arm sink."""
        rec = _TrackedRequest(prompt, kw.pop("on_token", None))
        migrations = 0
        while True:
            arm, _reason = self.route(prompt)
            sink = slo_sink
            if reward and (self.slo_ttft_s > 0 or self.slo_itl_s > 0):
                sink = self._reward_sink(arm, slo_sink)
            replica = self.replicas[arm]
            if replica is None:
                # the balancer routed into a tombstone: nothing can serve
                raise APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, "decode fleet has no serving replicas")
            if not rec.tokens:
                # a resumed leg teacher-forces its whole context: no pull
                await self._maybe_sibling_pull(prompt, arm)
            kw2 = dict(kw)
            if rec.tokens:
                # replayed positions must write the replayed tokens' K/V,
                # which only a plain round conditions on the input
                kw2["_replay_tokens"] = list(rec.tokens)
                kw2["spec_k"] = 0
                kw2["spec_tree"] = "0"
            rec.arm = arm
            rec.migrating = False
            self._inflight[arm].add(rec)
            rec.task = asyncio.ensure_future(replica.submit(prompt, on_token=rec.on_token, _slo_sink=sink, **kw2))
            try:
                return await rec.task, arm
            except asyncio.CancelledError:
                if rec.migrating and not self._closed:
                    # an eviction or a drain cancelled the replica's future:
                    # re-route (the arm is ineligible now) and resume
                    migrations += 1
                    if migrations > MAX_MIGRATIONS:
                        raise APIException(
                            ErrorCode.ENGINE_MICROSERVICE_ERROR,
                            f"generation migrated {migrations - 1} times without completing — giving up",
                        ) from None
                    continue
                rec.task.cancel()  # the caller left
                raise
            except APIException as e:
                if (e.error is ErrorCode.ENGINE_MICROSERVICE_ERROR and not self._closed
                        and migrations < MAX_MIGRATIONS and self._note_replica_failure(arm, str(e))):
                    # the replica's loop failed under this request: it is
                    # evicted now, and the request moves
                    migrations += 1
                    continue
                raise
            finally:
                self._inflight[arm].discard(rec)

    async def _maybe_sibling_pull(self, prompt, arm: int) -> None:
        """When ``arm`` holds the prompt's leading block in none of its
        tiers, pull the entry from the key's rendezvous home among the
        other serving replicas before the request prefills cold. One pull
        per (arm, key) in flight; every failure degrades to a cold
        prefill."""
        if not preseed_enabled() or len(self.live_replicas) <= 1:
            return
        target = self.replicas[arm]
        if target is None or not target.prefix_enabled:
            return
        key = prefix_route_key(prompt, block=self.affinity_block, seq_len=self.seq_len)
        if not key:
            return
        try:
            if target.prefix_probe_depth(prompt) >= self.affinity_block:
                return  # a local tier is warm for the block
        except Exception:  # noqa: BLE001 - a probe bug must not block serving
            return
        kt = (arm,) + tuple(key)
        task = self._pulls.get(kt)
        if task is None:
            survivors = [i for i, _ in self.live_replicas if i != arm and self._replica_states[i] == REPLICA_UP]
            if not survivors:
                return
            home = max(survivors, key=lambda a: _key_rank(tuple(key), a))
            task = asyncio.ensure_future(self._pull_entry(home, arm, np.asarray(prompt, np.int32)))
            self._pulls[kt] = task
            task.add_done_callback(lambda _t, kt=kt: self._pulls.pop(kt, None))
        await task

    async def _pull_entry(self, home_arm: int, target_arm: int, prompt) -> None:
        """One sibling transfer: the home's deepest covering entry
        (``export_prefix_entry``) pre-seeded into the target. Never raises."""
        try:
            home, target = self.replicas[home_arm], self.replicas[target_arm]
            if home is None or target is None:
                return
            payload = home.export_prefix_entry(prompt)
            if payload and target.preseed_prefix_state(payload):
                self.stat_sibling_pulls += 1
                self._metrics.decode_kv_sibling_pull(self._deployment, "hit")
            else:
                # no entry, a geometry mismatch, a full pool, or covered in
                # the meantime
                self._metrics.decode_kv_sibling_pull(self._deployment, "miss")
        except Exception:  # noqa: BLE001 - a failed pull costs a cold prefill
            self.stat_sibling_pull_failures += 1
            self._metrics.decode_kv_sibling_pull(self._deployment, "error")
            log.warning("sibling prefix pull %s -> %s failed — cold prefill instead", home_arm, target_arm,
                        exc_info=True)

    async def execute_message(self, msg: SeldonMessage) -> SeldonMessage:
        """Buffered entry: every row routes and rides the tracked submit on
        its own; the reply is the single scheduler's plus
        ``meta.tags.replica`` (each row's serving arm), which the Feedback
        API rewards."""
        arr = msg.array
        if arr is None:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, "generative predictor needs tensor token ids")
        self._ensure_poller()
        self._autoscale_tick()
        rows = np.atleast_2d(np.asarray(arr)).astype(np.int32)
        overrides = self.request_params_from_meta(msg.meta)
        track_slo = bool(self.slo_ttft_s or self.slo_itl_s) or current_deadline() is not None
        slo_flags = [True] * len(rows)
        picks = [0] * len(rows)

        async def one(i: int) -> np.ndarray:
            sink = (lambda ok, i=i: slo_flags.__setitem__(i, ok)) if track_slo else None
            out, picks[i] = await self._submit_routed(rows[i], dict(overrides), sink, reward=False)
            return out

        # settle every row before failing the request
        outs = await asyncio.gather(*(one(i) for i in range(len(rows))), return_exceptions=True)
        for o in outs:
            if isinstance(o, BaseException):
                raise o
        max_new = max(1, min(int(overrides.get("max_new_tokens", self.max_new_tokens)), self.max_new_tokens))
        full = np.full((len(outs), rows.shape[1] + max_new), self.eos_id if self.eos_id >= 0 else 0, np.int32)
        gen_lens = []
        for i, o in enumerate(outs):
            full[i, : len(o)] = o
            gen_lens.append(int(len(o) - rows.shape[1]))
        tags = {**msg.meta.tags, "replica": picks, "gen_lens": gen_lens}
        if track_slo:
            tags["slo"] = ["met" if ok else "breached" for ok in slo_flags]
        meta = Meta(puid=msg.meta.puid, tags=tags, routing=dict(msg.meta.routing),
                    request_path=dict(msg.meta.request_path))
        return msg.with_array_meta(full, meta)

    # ----------------------------------------------------------- feedback
    def ingest_feedback(self, feedback, *, use_slo: bool = False) -> int:
        """Reward the arms a response's ``meta.tags.replica`` names with
        ``feedback.reward``, or (``use_slo``, the automatic sink) each row
        with its own SLO verdict. Rows naming no arm are skipped. Returns
        the arms updated."""
        resp = feedback.response
        if resp is None:
            return 0
        arms = resp.meta.tags.get("replica")
        if not isinstance(arms, (list, tuple)) or not arms:
            return 0
        slo = resp.meta.tags.get("slo")
        updated = 0
        for i, arm in enumerate(arms):
            try:
                arm = int(arm)
            except (TypeError, ValueError):
                continue
            if not (0 <= arm < len(self.replicas)):
                continue
            r = float(feedback.reward)
            if use_slo and isinstance(slo, (list, tuple)) and i < len(slo):
                r = 1.0 if slo[i] == "met" else 0.0
            self._reward_arm(arm, r)
            updated += 1
        return updated

    # ----------------------------------------------- health poll / eviction
    def replica_states(self) -> list[str]:
        """Lifecycle state per arm, tombstones included."""
        return list(self._replica_states)

    def _set_replica_state(self, arm: int, state: str, reason: str = "") -> None:
        """The one writer of ``_replica_states``: a transition flips the
        balancer's eligibility, moves the lifecycle counters and metrics
        and the replica's flight-recorder state together."""
        while len(self._replica_states) <= arm:
            self._replica_states.append(REPLICA_UP)
        prev = self._replica_states[arm]
        if prev == state:
            return
        self._replica_states[arm] = state
        self.balancer.set_eligible(arm, state == REPLICA_UP)
        r = self.replicas[arm] if arm < len(self.replicas) else None
        if r is not None:
            r.flight.replica_state = state
        self._metrics.replica_state(self._deployment, arm, state)
        if state == REPLICA_EVICTED:
            self.stat_evictions += 1
            self._metrics.replica_eviction(self._deployment)
        elif state == REPLICA_UP and prev == REPLICA_EVICTED:
            self.stat_recoveries += 1
            self._metrics.replica_recovery(self._deployment)
        elif state == REPLICA_DOWN:
            self.stat_drains += 1
            self._metrics.replica_drain(self._deployment)
        log.info("decode replica %s: %s -> %s%s", arm, prev, state, f" ({reason})" if reason else "")

    def _ensure_poller(self) -> None:
        """Start the health poll task on the running loop, once."""
        if self.health_poll_s <= 0 or self._closed:
            return
        t = self._poll_task
        if t is not None and not t.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._poll_task = loop.create_task(self._health_poll_loop())

    async def _health_poll_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self.health_poll_s)
            try:
                self.poll_fleet_once()
            except Exception:  # noqa: BLE001 - the poller outlives one bad poll
                log.exception("decode health poll failed")

    def poll_fleet_once(self) -> None:
        """One sweep: probe every live replica, feed its queue depth to the
        balancer and count consecutive misses into its breaker. An evicted
        replica gets the breaker's half-open probe and is readmitted when
        it answers."""
        for arm, r in self.live_replicas:
            state = self._replica_states[arm]
            if state in (REPLICA_DOWN, REPLICA_DRAINING):
                continue
            br = self._breakers[arm]
            if state == REPLICA_EVICTED:
                if not br.allow():
                    continue  # still inside the open window
                if self._probe_ok(arm, r):
                    br.record_success()  # closed: readmitted through the funnel
                    self._misses[arm] = 0
                else:
                    br.record_failure()
                continue
            if self._probe_ok(arm, r):
                self._misses[arm] = 0
                br.record_success()
            else:
                self._misses[arm] += 1
                self.stat_health_misses += 1
                br.record_failure()  # threshold misses open it: eviction
            r.flight.consecutive_misses = self._misses[arm]

    def _probe_ok(self, arm: int, r) -> bool:
        """A probe that raises is a miss, and so is one that answers with
        active slots and no tick progress since the last poll (a hung round
        answers host-side probes while serving nothing)."""
        try:
            h = r.health_probe()
        except Exception:  # noqa: BLE001 - any probe failure is a miss
            self._last_ticks[arm] = -1
            return False
        ticks = int(h.get("ticks", 0))
        stuck = int(h.get("active", 0)) > 0 and ticks == self._last_ticks[arm]
        self._last_ticks[arm] = ticks
        if stuck:
            return False
        self.balancer.observe_depth(arm, int(h.get("queue_depth", 0)))
        return True

    def _on_breaker(self, arm: int, state: str) -> None:
        """Every breaker transition ticks the breaker metrics; open evicts
        and migrates, closed readmits."""
        self._metrics.breaker(self._deployment, f"decode-replica-{arm}", state)
        if state == OPEN and self._replica_states[arm] == REPLICA_UP:
            self._set_replica_state(arm, REPLICA_EVICTED, "health breaker open")
            self._migrate_inflight(arm, "eviction")
        elif state == CLOSED and self._replica_states[arm] == REPLICA_EVICTED:
            self._set_replica_state(arm, REPLICA_UP, "half-open probe recovered")

    def _note_replica_failure(self, arm: int, reason: str) -> bool:
        """A replica's loop failed under a request: force its breaker open,
        so eviction and readmission ride the poller's funnel. True when
        another replica serves (the caller may migrate)."""
        if self._replica_states[arm] == REPLICA_UP:
            br = self._breakers[arm]
            while br.state != OPEN:
                br.record_failure()
            log.warning("decode replica %s failed in-request: %s", arm, reason)
        return any(i != arm and self._replica_states[i] == REPLICA_UP for i, _ in self.live_replicas)

    def _migrate_inflight(self, arm: int, reason: str) -> int:
        """Cancel every tracked request's replica-side future on ``arm``
        (flagged migrating): the tracked submit re-routes it and resumes
        from its last streamed token. The replica retires the cancelled
        slots on its next round, or at abort() when it hangs."""
        recs = [rec for rec in self._inflight[arm] if rec.task is not None]
        for rec in recs:
            rec.migrating = True
            if not rec.task.done():
                rec.task.cancel()
        if recs:
            self.stat_migrations += len(recs)
            self._metrics.replica_migration(self._deployment, len(recs))
            log.info("decode replica %s: migrating %d in-flight generation(s) (%s)", arm, len(recs), reason)
        return len(recs)

    # ------------------------------------------------------ drain/scale-down
    def _serving_others(self, arm: int) -> list[int]:
        return [i for i, _ in self.live_replicas if i != arm and self._replica_states[i] == REPLICA_UP]

    async def drain_replica(self, arm: int, *, timeout_s: float | None = None) -> dict:
        """Graceful scale-down of one replica: stop its admission, wait up to
        the drain timeout for its work, migrate the stragglers, spill its
        prefix pages to the store and push each entry to its new rendezvous
        home, close it and leave a tombstone. Terminal."""
        if not (0 <= arm < len(self.replicas)) or self.replicas[arm] is None:
            raise ValueError(f"replica {arm} does not exist")
        if self._replica_states[arm] != REPLICA_UP:
            raise ValueError(f"replica {arm} is not serving (state: {self._replica_states[arm]})")
        if not self._serving_others(arm):
            raise ValueError("cannot drain the last serving replica")
        r = self.replicas[arm]
        self._set_replica_state(arm, REPLICA_DRAINING, "drain requested")
        budget = self.drain_timeout_s if timeout_s is None else max(0.0, timeout_s)
        deadline = time.monotonic() + budget
        while (r.active or r.queue_depth or self._inflight[arm]) and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        migrated = 0
        if self._inflight[arm]:
            migrated = self._migrate_inflight(arm, "drain timeout")
            # bounded wait for the cancellations to land
            waited = 0.0
            while self._inflight[arm] and waited < 1.0:
                await asyncio.sleep(0.005)
                waited += 0.005
        spilled = await self._spill_replica_state(arm, r)
        await r.close()
        self.replicas[arm] = None
        self._set_replica_state(arm, REPLICA_DOWN, "drained")
        self._metrics.router_replicas(self._deployment, len(self.live_replicas))
        log.info("decode replica %s drained: %d generation(s) migrated, %d prefix entr(ies) pushed to siblings",
                 arm, migrated, spilled)
        return {"replica": arm, "migrated": migrated, "spilled_entries": spilled}

    async def scale_down(self) -> dict:
        """Drain the coldest serving replica: fewest prefix hits, then the
        lightest load, then the highest arm."""
        candidates = [i for i, _ in self.live_replicas if self._replica_states[i] == REPLICA_UP]
        if len(candidates) <= 1:
            raise ValueError("cannot scale down a single-replica fleet")
        arm = min(candidates, key=lambda i: (self.replicas[i].stat_prefix_hits,
                                             self.replicas[i].queue_depth + self.replicas[i].active, -i))
        return await self.drain_replica(arm)

    def _resolve_spill_store(self):
        if self.spill_store is None and self._spill_store_factory is not None:
            try:
                self.spill_store = self._spill_store_factory()
            except Exception:  # noqa: BLE001 - a broken store must not fail a drain or a boot
                log.exception("replica spill store unusable — in-process spill only")
            self._spill_store_factory = None
        return self.spill_store

    def _count_spill_failure(self, what: str) -> None:
        self.stat_spill_failures += 1
        self._metrics.replica_spill_failure(self._deployment)
        log.exception("%s failed — continuing without it", what)

    async def _spill_replica_state(self, arm: int, r) -> int:
        """The drain's prefix handoff: export the replica's pages, save them
        to the store (a restart boots from them) and pre-seed each entry
        into the serving replica that rendezvous-owns its key (a keyless
        one into the least loaded). Returns the entries seeded."""
        if not (preseed_enabled() and self.prefix_enabled):
            return 0
        payload = r.export_prefix_state()
        if not payload or not payload["entries"]:
            return 0
        store = self._resolve_spill_store()
        if store is not None:
            try:
                store.save(spill_key(self._deployment), pickle.dumps(payload))
            except Exception:  # noqa: BLE001 - degraded, counted
                self._count_spill_failure("drain spill store save")
        survivors = self._serving_others(arm)
        if not survivors:
            return 0
        targets: dict[int, list] = {}
        for e in payload["entries"]:
            key = prefix_route_key(e["tokens"], block=self.affinity_block, seq_len=self.seq_len)
            if key:
                home = max(survivors, key=lambda a: _key_rank(tuple(key), a))
            else:
                home = min(survivors, key=lambda a: self.replicas[a].queue_depth)
            targets.setdefault(home, []).append(e)
        seeded = 0
        for home, entries in targets.items():
            sub = {"page_size": payload["page_size"], "kv_dtype": payload["kv_dtype"], "entries": entries}
            try:
                seeded += self.replicas[home].preseed_prefix_state(sub)
            except Exception:  # noqa: BLE001 - a full sibling pool degrades, counted
                self._count_spill_failure(f"drain preseed into replica {home}")
        self.stat_preseeded_entries += seeded
        return seeded

    # ---------------------------------------------------------- autoscale
    def _autoscale_tick(self) -> None:
        """Per request: refresh the queue-depth gauges, and boot one replica
        in the background once the mean queue depth has stayed at the
        threshold for AUTOSCALE_STREAK ticks and AUTOSCALE_HOLD_S seconds."""
        for i, d in enumerate(self._live_depths()):
            self._metrics.router_queue_depth(self._deployment, i, d)
        live = self.live_replicas
        if not live or self.autoscale_replicas <= len(live) or self.autoscale_queue_depth <= 0 or self._scaling:
            return
        mean_depth = sum(r.queue_depth for _, r in live) / len(live)
        now = time.monotonic()
        if mean_depth < self.autoscale_queue_depth:
            self._hot_streak = 0
            self._hot_since = None
            return
        self._hot_streak += 1
        if self._hot_since is None:
            self._hot_since = now
        if self._hot_streak >= self.AUTOSCALE_STREAK and now - self._hot_since >= self.AUTOSCALE_HOLD_S:
            self._scaling = True
            self._hot_streak = 0
            self._hot_since = None
            self._scale_task = asyncio.ensure_future(self._scale_up())

    def _hottest_replica(self):
        """The serving replica whose prefix index served the most hits."""
        up = [r for i, r in self.live_replicas if self._replica_states[i] == REPLICA_UP]
        return max(up or [r for _, r in self.live_replicas], key=lambda r: r.stat_prefix_hits)

    def _build_warm_replica(self, replica_id: int, payload):
        """Construct, pre-seed and warm a replica (on a worker thread: its
        graph captures run on its own capture stream, beside the serving
        replicas' replays on theirs). The replica's ``boot_split`` holds the
        seconds of each part."""
        t0 = time.perf_counter()
        new = self.factory(replica_id)
        t1 = time.perf_counter()
        if payload is not None:
            self.stat_preseeded_entries += new.preseed_prefix_state(payload)
        t2 = time.perf_counter()
        new.warmup()
        new.boot_split = {"construct_s": t1 - t0, "preseed_s": t2 - t1, "warmup_s": time.perf_counter() - t2}
        return new

    async def _scale_up(self) -> None:
        t0 = time.perf_counter()
        try:
            rid = len(self.replicas)
            payload = None
            if preseed_enabled() and self.prefix_enabled:
                # on the loop: the index and allocator cannot move mid-export
                payload = self._hottest_replica().export_prefix_state()
                store = self._resolve_spill_store()
                if store is not None and payload and payload["entries"]:
                    # through the store, so a restart boots from the payload
                    # this scale-up used; an outage keeps the one in hand
                    try:
                        store.save(spill_key(self._deployment), pickle.dumps(payload))
                        raw = store.load(spill_key(self._deployment))
                        if raw is not None:
                            payload = pickle.loads(raw)
                    except Exception:  # noqa: BLE001 - degraded, counted
                        self._count_spill_failure("replica spill store round-trip")
            t_spill = time.perf_counter() - t0
            new = await asyncio.get_running_loop().run_in_executor(None, self._build_warm_replica, rid, payload)
            self.replicas.append(new)
            self.balancer.add_arm()
            self._breakers.append(self._new_breaker(rid))
            self._misses.append(0)
            self._last_ticks.append(-1)
            self._inflight.append(set())
            self._set_replica_state(rid, REPLICA_UP, "scale-up boot")
            self.stat_scale_ups += 1
            new.boot_split.update(spill_s=t_spill, total_s=time.perf_counter() - t0)
            self._metrics.router_replicas(self._deployment, len(self.live_replicas))
            log.info("decode autoscale: replica %s up in %.1fs (queue depth %s, preseeded entries so far: %s)",
                     rid, new.boot_split["total_s"], self.autoscale_queue_depth, self.stat_preseeded_entries)
        except Exception:  # noqa: BLE001 - a failed scale-up must not stop serving; counted
            self.stat_boot_failures += 1
            self._metrics.replica_boot_failure(self._deployment)
            log.exception("decode autoscale: replica boot failed")
        finally:
            self._scaling = False
            self._scale_task = None

    # ------------------------------------------------------------- audits
    def allocator_audits(self) -> None:
        """Every live replica's page-allocator consistency audit."""
        for _, r in self.live_replicas:
            r.pool.alloc.check()
