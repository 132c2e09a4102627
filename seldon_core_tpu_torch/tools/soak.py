"""Soak harness: serve under sustained load and report stability.

Port of ``seldon_core_tpu/tools/soak.py``: the same flags, defaults, legs,
gates and JSON keys, with the server on the card unless ``--device cpu``
asks for the host. The reference validated long-running behavior with locust soaks against a
cluster (SURVEY C24); this is the single-process twin with the two signals
that actually catch serving regressions early:

- **RSS slope** (MB/min, least-squares over per-second samples): a
  positive slope under steady load is a leak — e.g. an unbounded cache, a
  GC-frozen object churn, or a native buffer that never returns.
- **event-loop lag** (p99 of per-second max samples): scheduling stalls
  from GC, host-side compute, or ingress pathology, the same signal the
  `seldon_tpu_event_loop_lag_ms` gauge exports in production.

Runs the REAL stack: OAuth gateway -> fast ingress -> micro-batcher ->
model, driven by the raw-conn load generator. One JSON line on stdout.

    python -m seldon_core_tpu_torch.tools.soak --duration 60 --users 16

``--model`` is any zoo spec: ``--model 'bert_base?seq=512&attn_kernel=pallas'
--features 512`` serves BERT-base at full width in float32 through the
flash kernel. ``--tp N`` serves tensor-parallel decode
(``tpu.decode_mesh_axes={"tp": N}``) over the host's cards, or with
``--device cpu`` over N CPU positions (the JAX soak forces N virtual host
devices for the same run); ``soak(..., mesh_devices=)`` takes the positions
from its caller (``[cuda:0] * N`` on one card). A ``--tp`` soak the positions
cannot hold is refused before anything is built, and one whose scheduler
fell back to one device fails after the run, as the JAX soak does.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import resource
import socket
import sys
import time


def _rss_mb() -> float:
    """CURRENT resident set (VmRSS), not the getrusage high-water mark —
    a leak running below a prior RSS peak would be invisible to
    ru_maxrss (it only ratchets), which is exactly the case a soak
    exists to catch. Falls back to the high-water mark off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def tp_positions(tp: int, device=None, mesh_devices=None) -> list | None:
    """The positions a ``--tp`` soak decodes over: the caller's
    ``mesh_devices``, else N CPU positions for a CPU soak, else the host's
    cards (None without --tp). Refused by name when they cannot hold the
    mesh: such a soak would run on one device and report a green run that
    never exercised the sharded geometry."""
    if tp <= 1:
        return None
    import torch

    from seldon_core_tpu_torch.parallel.mesh import local_cards

    if mesh_devices is not None:
        positions = list(mesh_devices)
    elif device is not None and torch.device(device).type == "cpu":
        positions = [torch.device("cpu")] * tp
    else:
        positions = local_cards("cuda") if torch.cuda.is_available() else []
    if len(positions) < tp:
        raise RuntimeError(
            f"soak --tp {tp}: decode_mesh_axes={{'tp': {tp}}} needs {tp} devices, have {len(positions)} — the "
            "mesh request would be disabled and the sharded geometry NOT exercised"
        )
    return positions


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def soak_predictor(
    model: str = "iris_mlp",
    features: int = 4,
    fault_spec=None,
    spec_k: int = 0,
    spec_tree: str = "",
    prefix_share: float = 0.0,
    paged: bool = False,
    tp: int = 0,
    replicas: int = 0,
    kv_overflow: bool = False,
):
    """The predictor a soak leg serves, defaulted and validated: returns
    (predictor, prefix_share, paged, generative), the last three as the
    leg's flags imply them."""
    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.graph.validation import validate_deployment

    graph: dict = {
        "name": "m",
        "type": "MODEL",
        "implementation": "JAX_MODEL",
        "parameters": [{"name": "model", "value": model, "type": "STRING"}],
    }
    predictor_extra: dict = {}
    if paged and prefix_share <= 0:
        # the paged soak's point is CoW + reclaim under a SHARED/divergent
        # traffic mix — default the mix on when the caller didn't shape it
        prefix_share = 0.6
    if tp > 1 and not paged:
        # the tp soak's point is the sharded program set under sustained
        # load INCLUDING the paged copy/CoW ladder — default the pool on
        paged = True
        if prefix_share <= 0:
            prefix_share = 0.6
    if replicas > 1:
        # the replica soak's point is prefix-AFFINITY routing across the
        # fleet: it needs the paged pool's small page size (the affinity
        # key is one page of tokens — the default 16-token block exceeds
        # the soak's short prompts) and a shared-prefix traffic mix
        if tp > 1:
            raise RuntimeError("soak --replicas does not compose with --tp")
        paged = True
        if prefix_share <= 0:
            prefix_share = 0.6
    if kv_overflow:
        # the kv-overflow soak's point is the demote/promote churn of the
        # host tier under sustained load: a paged pool, a DELIBERATELY
        # tiny device prefix index, and a multi-group shared-prefix mix
        # wide enough to overflow it — every capture evicts (demotes) and
        # revisited groups promote back, all while the allocator audit
        # and zero-recompile gates run as usual
        paged = True
        if prefix_share <= 0:
            prefix_share = 0.6
    generative = (
        spec_k > 0 or bool(spec_tree) or prefix_share > 0 or paged or tp > 1
        or replicas > 1 or kv_overflow
    )
    if generative:
        if model != "iris_mlp":
            import sys as _sys

            print(
                f"soak: --spec-k/--prefix-share override --model (generative "
                f"soaks run tiny_gpt, ignoring {model!r})",
                file=_sys.stderr,
            )
        # generative soak: a deployment (prompt bucket = --features) served
        # by the decode scheduler, so sustained load drives the decode-loop
        # programs instead of the iris classifier. --spec-k adds a
        # seed-shared 1-layer draft (draft + widened verify programs);
        # --prefix-share shapes the prompt mix so that fraction of requests
        # share a system prefix, driving the prefix pool's match/gather/
        # capture/evict cycle under load. The soak's signals are RSS slope
        # / loop lag / error budget, not model quality.
        graph["parameters"] = [
            {"name": "model", "value": "tiny_gpt", "type": "STRING"},
            {"name": "seq", "value": str(features), "type": "INT"},
            {"name": "max_new_tokens", "value": "16", "type": "INT"},
            {"name": "resid_scale", "value": "0.1", "type": "FLOAT"},
        ]
        predictor_extra["tpu"] = {"decode_slots": 4}
        if tp > 1:
            # tensor-parallel mesh: hidden 256 -> 4 heads / ffn 1024, both
            # divisible by every width up to 4 (and ffn by 8)
            graph["parameters"] += [
                {"name": "hidden", "value": "256", "type": "INT"},
                {"name": "ffn", "value": "1024", "type": "INT"},
            ]
            predictor_extra["tpu"]["decode_mesh_axes"] = {"tp": tp}
        if spec_k > 0 or spec_tree:
            draft_uri = "zoo://draft?layers=1&resid_scale=0.1"
            if tp > 1:
                # the draft shards on the same mesh — pin its geometry to
                # the target's (only vocab/max_len are auto-injected)
                draft_uri += "&hidden=256&ffn=1024"
            predictor_extra["tpu"]["decode_draft_model"] = draft_uri
            if spec_tree:
                # tree speculation: the same draft proposes per-depth
                # top-b candidate branches, one widened verify scores the
                # flattened tree — sustained load drives the tree round
                # pair (and, with --paged/--tp, the same allocator and
                # per-shard audits the chain soaks run)
                predictor_extra["tpu"]["decode_spec_tree"] = spec_tree
            else:
                predictor_extra["tpu"]["decode_spec_k"] = spec_k
        if prefix_share > 0:
            predictor_extra["tpu"].update(
                decode_prefix_slots=8,
                decode_prefill_chunk=max(1, features // 4),
            )
        if paged:
            # a DELIBERATELY tight page budget: ~half the flat-equivalent
            # capacity, so shared-prefix admissions share pages copy-free,
            # divergent tails copy-on-write, and sustained load drives pin
            # reclaim — the allocator surface the soak exists to stress.
            # Chunk rounds page-aligned per the validation contract.
            ps = max(2, features // 4)
            pages_per_slot = -(-(features + 16) // ps)
            n_slots = predictor_extra["tpu"]["decode_slots"]
            budget = max(
                pages_per_slot + 2, n_slots + 1, 1 + 2 * pages_per_slot + 2
            )
            predictor_extra["tpu"].update(
                decode_prefix_slots=8,
                decode_kv_page_size=ps,
                decode_kv_pages=budget,
                decode_prefill_chunk=ps,
            )
        if kv_overflow:
            # squeeze the device prefix index down to TWO entries and hang
            # a host tier below it: with ~8 distinct shared-prefix groups
            # in the mix, every capture evicts an older group (demotion)
            # and every revisit of an evicted group promotes it back —
            # sustained demote/promote churn over the full soak duration
            predictor_extra["tpu"].update(
                decode_prefix_slots=2,
                decode_kv_host_bytes=32 << 20,
            )
        if replicas > 1:
            predictor_extra["tpu"].update(
                decode_replicas=replicas,
                decode_router_policy="affinity",
                # fleet health polling on: the poller feeds live queue
                # depths to the balancer and drives the breaker
                # evict/readmit funnel the chaos flags below exercise
                decode_health_poll_ms=50.0,
                decode_health_miss_threshold=2,
            )
            # pin headroom on top of the deliberately-tight paged budget:
            # the replica soak asserts the fleet HIT RATE, and a budget
            # that reclaims prefix pins as fast as groups capture would
            # fail that assert for allocator reasons, not routing ones
            ps = predictor_extra["tpu"]["decode_kv_page_size"]
            pin_pages = -(-max(1, features // 2) // ps)
            predictor_extra["tpu"]["decode_kv_pages"] += (
                4 * replicas * pin_pages + 2
            )
    if fault_spec is not None:
        # the faulted leg exercises the resilience layer end-to-end: the
        # model node gets a retry policy (absorbing injected transport
        # errors) — what survives shows up in the reported error budget
        graph["parameters"] += [
            {"name": "retry_max_attempts", "value": "3", "type": "INT"},
            {"name": "retry_backoff_ms", "value": "2", "type": "FLOAT"},
            {"name": "retry_seed", "value": str(fault_spec.seed), "type": "INT"},
        ]
    dep = SeldonDeployment.from_dict(
        {
            "spec": {
                "name": "soak",
                "predictors": [{"name": "p", "graph": graph, **predictor_extra}],
            }
        }
    )
    dep = default_deployment(dep)
    validate_deployment(dep)
    predictor = dep.spec.predictors[0]
    return predictor, prefix_share, paged, generative


async def soak(
    duration_s: float = 60.0,
    users: int = 16,
    model: str = "iris_mlp",
    features: int = 4,
    batch: int = 4,
    fault_spec=None,
    trace_summary: int = 0,
    spec_k: int = 0,
    spec_tree: str = "",
    prefix_share: float = 0.0,
    paged: bool = False,
    tp: int = 0,
    replicas: int = 0,
    profile_out: str = "",
    kill_replica: str = "",
    drain_replica: str = "",
    kv_overflow: bool = False,
    device=None,
    mesh_devices=None,
) -> dict:
    positions = tp_positions(tp, device, mesh_devices)
    from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
    from seldon_core_tpu_torch.tools import stack
    from seldon_core_tpu_torch.tools.loadtest import run_load

    predictor, prefix_share, paged, generative = soak_predictor(
        model=model,
        features=features,
        fault_spec=fault_spec,
        spec_k=spec_k,
        spec_tree=spec_tree,
        prefix_share=prefix_share,
        paged=paged,
        tp=tp,
        replicas=replicas,
        kv_overflow=kv_overflow,
    )

    if trace_summary > 0:
        # fresh process-global trace store per run: --faults runs two legs
        # in one process, and the faulted leg's summary must rank ITS
        # traces, not the union of both legs
        import seldon_core_tpu_torch.telemetry as telemetry

        telemetry.configure(telemetry.tracer_from_env())
    server, gw, oauth, _token = stack.build_gateway_stack(
        predictor,
        deployment_name="soak",
        oauth_key="soak-key",
        oauth_secret="soak-secret",
        device=device,
        mesh_devices=positions,
    )
    fault_schedules = {}
    if fault_spec is not None:
        from seldon_core_tpu_torch.engine.faults import install_faults

        fault_schedules = install_faults(server.executor, {"m": fault_spec})

    port = _free_port()
    fast = await start_fast_server(gateway_routes(gw), "127.0.0.1", port)

    # ---- seeded replica chaos (--kill-replica / --drain-replica n@t) ----
    def _parse_at(flag: str, raw: str) -> tuple[int, float]:
        try:
            n, _, t = raw.partition("@")
            arm, at_s = int(n), float(t)
        except ValueError:
            raise RuntimeError(f"soak {flag}: expected <replica>@<seconds>, got {raw!r}")
        if not (0 <= arm < max(replicas, 1)) or at_s < 0:
            raise RuntimeError(
                f"soak {flag}: replica must be in [0, {replicas}) and the "
                f"time non-negative, got {raw!r}"
            )
        return arm, at_s

    chaos_actions: list[tuple[str, int, float]] = []
    if kill_replica or drain_replica:
        if replicas <= 1:
            raise RuntimeError(
                "soak --kill-replica/--drain-replica need --replicas > 1 "
                "(a single scheduler has no surviving arm to migrate onto)"
            )
        if kill_replica:
            chaos_actions.append(("kill", *_parse_at("--kill-replica", kill_replica)))
        if drain_replica:
            chaos_actions.append(("drain", *_parse_at("--drain-replica", drain_replica)))
        chaos_actions.sort(key=lambda a: a[2])
    chaos_events: list[dict] = []

    rss_samples: list[tuple[float, float]] = []
    lag_samples: list[float] = []
    stop = asyncio.Event()

    async def sampler() -> None:
        while not stop.is_set():
            window_max_lag = 0.0
            t_end = time.perf_counter() + 1.0
            while time.perf_counter() < t_end and not stop.is_set():
                t0 = time.perf_counter()
                await asyncio.sleep(0.02)
                window_max_lag = max(
                    window_max_lag, time.perf_counter() - t0 - 0.02
                )
            rss_samples.append((time.perf_counter(), _rss_mb()))
            lag_samples.append(window_max_lag * 1e3)

    payload_fn = None
    shared_sent = {"n": 0}
    n_groups = 4 * replicas if replicas > 1 else 1
    if kv_overflow:
        # 4× the 2-entry device index: the working set of distinct shared
        # prefixes CANNOT fit on device, so overflow (and the host tier
        # underneath it) is guaranteed, not load-dependent
        n_groups = max(n_groups, 8)
    if prefix_share > 0:
        # prompt mix: `prefix_share` of requests open with a fixed system
        # prefix (half the prompt bucket) + a random tail, the rest are
        # fully random — retiring slots auto-capture full prompts, and the
        # radix index's longest-common-prefix match turns ANY captured
        # sharer into a hit for the next one; the random tails churn the
        # LRU pool so eviction runs under load too. A replicated soak uses
        # SEVERAL distinct system prefixes (4 per replica) so the affinity
        # router has a keyspace to spread — one group would just pin one
        # replica hot
        shared_len = max(1, features // 2)
        prefixes = [[7 + g] * shared_len for g in range(n_groups)]

        def payload_fn(rng):
            def tail(n):
                return [rng.randrange(64) for _ in range(n)]

            if rng.random() < prefix_share:
                shared_sent["n"] += 1
                g = rng.randrange(n_groups)
                if kv_overflow:
                    # group-DETERMINISTIC full prompts: the host tier holds
                    # whole page-aligned spans (entry must prefix the
                    # prompt), so a revisit only promotes when it replays
                    # the captured span exactly — random tails would bury
                    # the shared head inside never-rehit entries
                    prompt = [7 + g] * features
                else:
                    prompt = prefixes[g] + tail(features - shared_len)
            else:
                prompt = tail(features)
            return {"data": {"ndarray": [prompt] * batch}}

    async def chaos_driver() -> None:
        """Fire the scheduled replica chaos actions mid-load. A KILL arms a
        deterministic induced allocator-OOM on the target's very next
        decode round (engine/faults.py DecodeFaultSpec) — its loop crashes
        for real, the router force-opens the breaker, migrates the
        in-flight generations, and the health poller readmits the replica
        through the half-open probe once it answers again. A DRAIN calls
        the graceful path. Either way the load generator above must see
        ZERO errors — that is the assertion this harness exists for."""
        from seldon_core_tpu_torch.engine.faults import DecodeFaultSpec, install_decode_faults

        t0 = time.perf_counter()
        for kind, arm, at_s in chaos_actions:
            delay = at_s - (time.perf_counter() - t0)
            if delay > 0:
                try:
                    await asyncio.wait_for(stop.wait(), timeout=delay)
                    return  # load finished before the action came due
                except asyncio.TimeoutError:
                    pass
            sched_ = getattr(server, "decode_scheduler", None)
            fleet_ = getattr(sched_, "replicas", None)
            if fleet_ is None or fleet_[arm] is None:
                continue
            ev = {"action": kind, "replica": arm, "t_s": round(at_s, 2)}
            if kind == "kill":
                install_decode_faults(fleet_[arm], DecodeFaultSpec(oom_at_round=1))
            else:
                lookups_ = sched_.stat_prefix_hits + sched_.stat_prefix_misses
                ev["hit_rate_pre_drain"] = round(
                    sched_.stat_prefix_hits / max(lookups_, 1), 3
                )
                ev["hits_pre"] = sched_.stat_prefix_hits
                ev["lookups_pre"] = lookups_
                ev.update(await sched_.drain_replica(arm))
            chaos_events.append(ev)

    sampler_task = asyncio.ensure_future(sampler())
    chaos_task = (
        asyncio.ensure_future(chaos_driver()) if chaos_actions else None
    )
    try:
        stats = await run_load(
            f"http://127.0.0.1:{port}",
            users=users,
            duration_s=duration_s,
            features=features,
            batch=batch,
            oauth_key="soak-key",
            oauth_secret="soak-secret",
            static_payload=True,
            payload_fn=payload_fn,
        )
    finally:
        stop.set()
        await sampler_task
        if chaos_task is not None:
            await chaos_task
        fast.close()
        await fast.wait_closed()
        if getattr(server, "decode_scheduler", None) is not None:
            await server.decode_scheduler.close()
        if server.batcher is not None:
            await server.batcher.close()

    s = stats.summary()
    # The in-process load GENERATOR keeps every request's latency +
    # completion time for exact percentiles (tools/loadtest.py LoadStats)
    # — that is real, expected growth of ~64 bytes/request in THIS
    # process, not a server leak. Estimate it so the net server slope is
    # the leak signal. (A measured 90 s iris soak: 45 MB raw growth,
    # ~36 MB of it the stats lists.)
    loadgen_mb = s["requests"] * 64 / 1e6
    # least-squares slope over (minute, MB) samples
    slope = 0.0
    if len(rss_samples) >= 2:
        t0 = rss_samples[0][0]
        xs = [(t - t0) / 60.0 for t, _ in rss_samples]
        ys = [m for _, m in rss_samples]
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs)
        if denom > 0:
            slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
    lag_sorted = sorted(lag_samples)
    # s["requests"] counts only SUCCESSES (loadtest tallies errors apart);
    # the budget denominator is all attempts, clamped only against div-by-0
    attempts = max(int(s["requests"]) + int(s["errors"]), 1)
    traces = None
    if trace_summary > 0:
        # built-in attribution for soak/chaos runs: the slowest retained
        # traces (tail sampling keeps errors + slowest-N), each with its
        # top spans by SELF time — where the tail latency actually went
        from seldon_core_tpu_torch.telemetry import get_tracer

        traces = get_tracer().store.slowest_summaries(n=trace_summary)
    spec_stats = None
    sched = getattr(server, "decode_scheduler", None)
    if (spec_k > 0 or spec_tree) and sched is not None:
        spec_stats = {
            **({"spec_tree": spec_tree} if spec_tree else {"spec_k": spec_k}),
            "spec_dispatches": sched.stat_spec_dispatches,
            "accept_rate": round(
                sched.stat_spec_accepted / max(sched.stat_spec_proposed, 1), 3
            ),
            "tokens_per_dispatch": round(
                sched.stat_spec_emitted / max(sched.stat_spec_dispatches, 1), 2
            ),
            "tokens_per_ride": round(
                sched.stat_spec_ride_emitted / max(sched.stat_spec_rides, 1), 2
            ),
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
        }
    fleet = getattr(sched, "replicas", None) if sched is not None else None
    # drained replicas leave a None tombstone in the fleet list (positional
    # rendezvous ranks); every aggregation below reads the LIVE ones
    live_fleet = [r for r in fleet if r is not None] if fleet else None
    paged_stats = None
    if paged and sched is not None:
        pools = [r.pool for r in live_fleet] if live_fleet else [sched.pool]
        allocs = [p.alloc for p in pools]
        paged_stats = {
            "page_size": pools[0].page_size,
            "page_budget": sum(p.n_pages for p in pools),
            "peak_slots": sched.stat_peak_active,
            "pages_shared": sum(a.stat_pages_shared for a in allocs),
            "cow_copies": sum(a.stat_cow_copies for a in allocs),
            "pins_reclaimed": sum(a.stat_pin_reclaims for a in allocs),
            "pages_reclaimed": sum(a.stat_reclaimed_pages for a in allocs),
            "admit_blocked_rounds": sched.stat_admit_blocked_rounds,
            "pages_free_end": sum(a.free_pages for a in allocs),
            "pages_live_end": sum(a.live_pages for a in allocs),
            "pages_prefix_end": sum(a.prefix_pages for a in allocs),
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
        }
        # end-of-run allocator audit (per replica on a fleet): a soak that
        # leaked or double-freed a page fails loudly here rather than
        # reporting a green run
        for a in allocs:
            a.check()
    tp_stats = None
    if tp > 1:
        # a --tp soak that silently fell back to single-device (mesh
        # warn-disabled: head/ffn divisibility; no scheduler) would report
        # a vacuously green run with the shard audit never executed — the
        # exact failure mode a CI gate keyed on exit code must not miss
        if sched is None or getattr(sched, "tp", None) != tp:
            raise RuntimeError(
                f"soak --tp {tp}: scheduler runs at tp="
                f"{getattr(sched, 'tp', None)} — the mesh request was "
                "disabled (device count or head/ffn divisibility); the "
                "sharded geometry was NOT exercised"
            )
        # per-shard audit beside the allocator's host-side check(): every
        # pool/draft-cache buffer must be laid out across exactly the mesh
        # positions with head-sharded payloads — a soak that drifted a
        # buffer off the mesh (or silently replicated a shard) fails
        # loudly here rather than reporting a green run
        tp_stats = {
            **sched.shard_audit(),
            "requested_tp": tp,
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
        }
    replica_stats = None
    if replicas > 1:
        # a --replicas soak that silently fell back to one scheduler
        # (validation refused, spec dropped) must not report green
        if fleet is None or len(fleet) < replicas:
            raise RuntimeError(
                f"soak --replicas {replicas}: replicated decode tier not "
                f"built (got {0 if fleet is None else len(fleet)} replicas)"
            )
        hits = sched.stat_prefix_hits
        misses = sched.stat_prefix_misses
        lookups = max(hits + misses, 1)
        # the analytic round-robin FLOOR for this mix, from the traffic
        # the payload generator actually sent: shared rows can hit at
        # best after their group's cold capture, and under round-robin
        # EVERY replica pays its own capture per group — so round-robin's
        # hit count is bounded by shared_rows - replicas * groups * batch
        # (batch rows per request admit and look up individually).
        # Affinity pays one capture per group fleet-wide; beating the
        # floor is the point of keying the router on the radix prefix.
        shared_rows = shared_sent["n"] * batch
        cold_rows_per_group = batch  # one cold REQUEST (batch rows)
        rr_cold = len(fleet) * n_groups * cold_rows_per_group
        rr_floor = max(0.0, (shared_rows - rr_cold) / lookups)
        agg_hit = hits / lookups
        replica_stats = {
            "replicas": len(fleet),
            "policy": sched.policy,
            "routes": dict(sched.balancer.stat_routes),
            "aggregate_hit_rate": round(agg_hit, 3),
            "rr_floor_hit_rate": round(rr_floor, 3),
            "shared_requests_sent": shared_sent["n"],
            "scale_ups": sched.stat_scale_ups,
            "per_replica": [
                {
                    "replica_id": r.replica_id,
                    "admitted": r.stat_admitted,
                    "hits": r.stat_prefix_hits,
                    "misses": r.stat_prefix_misses,
                    "queue_depth_end": r.queue_depth,
                }
                for r in live_fleet
            ],
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
        }
        # fleet hit-rate above the round-robin floor — the affinity
        # contract under a sustained mixed shared/divergent stream. Only
        # judged when the mix sent enough shared traffic for the floor to
        # separate from capture-race noise (a sparse short smoke records
        # the numbers without asserting on them).
        # a chaos leg invalidates the floor: an eviction/drain re-captures
        # its groups on the surviving replicas (and again on readmission),
        # so the capture cost the floor models is paid extra times — that
        # leg is judged by its own zero-error/lifecycle asserts instead
        if shared_rows >= 4 * rr_cold and hits > 0 and not chaos_actions:
            if not agg_hit > rr_floor:
                raise RuntimeError(
                    f"soak --replicas: aggregate prefix hit rate {agg_hit:.3f} "
                    f"did not clear the round-robin floor {rr_floor:.3f} — "
                    "affinity routing is not keeping sharers co-located"
                )
    flight_stats = None
    if generative and live_fleet is not None:
        # per-replica flight summaries (each replica owns its recorder;
        # /decode/health serves the same per-replica rows live)
        per_replica = []
        for r in live_fleet:
            agg = r.flight.aggregate()
            per_replica.append(
                {
                    "name": r.flight.name,
                    "replica_id": r.replica_id,
                    "rounds": agg["rounds"],
                    "occupancy_mean": agg["occupancy_mean"],
                    "bubble_fraction": agg["bubble_fraction"],
                    "goodput": agg["goodput"],
                }
            )
        flight_stats = {"per_replica": per_replica}
    elif generative and sched is not None and getattr(sched, "flight", None):
        # the flight recorder's aggregate beside the allocator audit: the
        # same bubble/occupancy/blocked-cause read-out GET /decode/flight
        # serves live, as an end-of-run summary
        fa = sched.flight.aggregate()
        flight_stats = {
            "rounds": fa["rounds"],
            "modes": fa["modes"],
            "occupancy_mean": fa["occupancy_mean"],
            "bubble_fraction": fa["bubble_fraction"],
            # the pipelined loop's win: host work hidden under in-flight
            # dispatches, and the share of the would-be serial gap it
            # covered vs the residual still exposed as bubble
            "overlap_ms": fa["overlap_ms"],
            "overlap_of_gap": fa["overlap_of_gap"],
            "bubble_residual": fa["bubble_residual"],
            "pipelined_rounds": sched.stat_pipelined_rounds,
            "busy_ms": fa["busy_ms"],
            # the enqueue/readback split of busy_ms and the per-phase
            # decomposition of gap_ms — the host-bubble attribution the
            # pipelined decode loop spends, printed beside the aggregate
            # exactly as GET /decode/flight serves it
            "enqueue_ms": fa["enqueue_ms"],
            "readback_ms": fa["readback_ms"],
            "phase_ms": fa["phase_ms"],
            "top_gap_phase": sched.flight.top_gap_phase(),
            "gap_ms": fa["gap_ms"],
            "blocked_rounds": fa["blocked_rounds"],
            "goodput": fa["goodput"],
        }
    profile_stats = None
    if profile_out:
        # --profile: the run must have exercised the decode loop AND the
        # sampler must have caught it in the act at least once — a smoke
        # gate that fails loudly instead of writing an empty file
        from seldon_core_tpu_torch.telemetry import profile as profile_mod

        if not generative:
            raise RuntimeError(
                "soak --profile needs a generative leg (--spec-k/"
                "--prefix-share/--paged) — the sampler targets the "
                "decode loop's thread"
            )
        prof = profile_mod.get_profiler()
        folded = prof.folded()
        if prof.samples < 1 or not folded:
            raise RuntimeError(
                "soak --profile: the sampling profiler captured no decode-"
                "loop stack (ENGINE_DECODE_PROFILE off? run shorter than "
                f"one {prof.hz} Hz sampling tick?)"
            )
        # the profile-smoke leg doubles as the pipelined-round gate: the
        # generative smoke must actually hide host work under in-flight
        # dispatches — a silently-serialized decode loop (pipeline flag
        # dropped, overlap window skipped, overlap accounting broken)
        # fails CI here instead of shipping as a quiet perf regression
        if (
            sched is not None
            and getattr(sched, "_pipeline_on", lambda: False)()
            and flight_stats is not None
            and flight_stats.get("rounds")
        ):
            # overlap_of_gap comes from flight frames — with the recorder
            # killed (ENGINE_FLIGHT=off) or no frames recorded there is
            # nothing to judge, and failing would blame the pipeline for
            # a telemetry kill switch
            ov = flight_stats.get("overlap_of_gap", 0.0)
            if not ov > 0.0:
                raise RuntimeError(
                    "soak --profile: the decode pipeline is on but "
                    "overlap_of_gap is 0 — no host work was hidden under "
                    "an in-flight dispatch (silently-serialized loop?)"
                )
        with open(profile_out, "w") as f:
            f.write("\n".join(folded) + "\n")
        rep = prof.report(n=3)
        profile_stats = {
            "samples": rep["samples"],
            "hz": rep["hz"],
            "stacks": rep["table_entries"],
            "truncated_samples": rep["truncated_samples"],
            "folded_out": profile_out,
            "top_self": [t["frame"] for t in rep["top"]],
        }
    chaos_stats = None
    if chaos_actions:
        # the fault-tolerance contract, asserted: replica death/drain
        # under load is INVISIBLE to clients — every in-flight generation
        # migrated and resumed, zero errors in the load generator's tally
        if s["errors"] > 0:
            raise RuntimeError(
                f"soak replica-chaos: {s['errors']} request error(s) leaked "
                "to clients — migration/recovery did not absorb the fault"
            )
        if not chaos_events:
            raise RuntimeError(
                "soak replica-chaos: no scheduled action actually fired "
                "(action time past --duration, or target already gone) — "
                "the run proved nothing"
            )
        killed = [e for e in chaos_events if e["action"] == "kill"]
        if killed and sched.stat_evictions < 1:
            raise RuntimeError(
                "soak --kill-replica: the induced allocator-OOM never "
                "evicted the target (no breaker-open observed) — the kill "
                "was not exercised"
            )
        # readmission via the half-open probe: only judged when the kill
        # left the poller time to recover the replica before shutdown
        if killed and sched.stat_recoveries < 1 and all(
            duration_s - e["t_s"] >= 2.0 for e in killed
        ):
            raise RuntimeError(
                "soak --kill-replica: the evicted replica was never "
                "readmitted (half-open probe did not recover it)"
            )
        for e in chaos_events:
            if e["action"] != "drain":
                continue
            lookups_post = (
                sched.stat_prefix_hits + sched.stat_prefix_misses - e["lookups_pre"]
            )
            hits_post = sched.stat_prefix_hits - e["hits_pre"]
            e["hit_rate_post_drain"] = round(hits_post / max(lookups_post, 1), 3)
            # the drain acceptance bar (warm-TTFT hit rate within 5% of
            # pre-drain) — only judged when enough post-drain traffic ran
            # for the rate to mean anything
            if (
                lookups_post >= 100
                and e["hit_rate_post_drain"] < e["hit_rate_pre_drain"] - 0.05
            ):
                raise RuntimeError(
                    f"soak --drain-replica: post-drain hit rate "
                    f"{e['hit_rate_post_drain']} fell more than 5% below "
                    f"pre-drain {e['hit_rate_pre_drain']} — the spill/"
                    "sibling-push did not keep the working set warm"
                )
        chaos_stats = {
            "events": chaos_events,
            "replica_states": sched.replica_states(),
            "evictions": sched.stat_evictions,
            "recoveries": sched.stat_recoveries,
            "migrations": sched.stat_migrations,
            "drains": sched.stat_drains,
            "health_misses": sched.stat_health_misses,
        }
    prefix_stats = None
    if prefix_share > 0 and sched is not None:
        lookups = sched.stat_prefix_hits + sched.stat_prefix_misses
        prefix_stats = {
            "prefix_share": prefix_share,
            "hit_rate": round(sched.stat_prefix_hits / max(lookups, 1), 3),
            "prefill_tokens_saved": sched.stat_prefix_tokens_saved,
            "captures": sched.stat_prefix_captures,
            "evictions": sched.stat_prefix_evictions,
            "chunk_dispatches": sched.stat_chunk_dispatches,
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
        }
    kvtier_stats = None
    if kv_overflow and sched is not None:
        tier = getattr(sched, "_host_tier", None)
        kvtier_stats = {
            "groups": n_groups,
            "prefix_slots": 2,
            "demotions": sched.stat_tier_demotions,
            "promotions": sched.stat_tier_promotions,
            "promote_overlap": sched.stat_tier_promote_overlap,
            "sent_shared": shared_sent["n"],
            "recompiles_after_warmup": sched.recompiles_since_warmup(),
            **({"host_tier": tier.snapshot()} if tier is not None else {}),
        }
        # with 8 distinct groups and a 2-entry device index, every capture
        # past the second must evict-and-demote — zero demotions means the
        # tier was never wired in and the soak proved nothing
        if shared_sent["n"] >= n_groups and kvtier_stats["demotions"] < 1:
            raise RuntimeError(
                "soak --kv-overflow: the device prefix index never demoted "
                "to the host tier — overflow was not exercised"
            )
        # revisited groups must come back WARM from the host tier; enough
        # shared traffic makes a revisit-of-evicted statistically certain
        if shared_sent["n"] >= 4 * n_groups and kvtier_stats["promotions"] < 1:
            raise RuntimeError(
                "soak --kv-overflow: no evicted prefix was ever promoted "
                "back from the host tier — the ladder is one-way"
            )
        if kvtier_stats["recompiles_after_warmup"] != 0:
            raise RuntimeError(
                "soak --kv-overflow: promotion churn built a new decode "
                "program — tier traffic must never touch captured signatures"
            )
    return {
        "duration_s": duration_s,
        "users": users,
        "model": "tiny_gpt" if generative else model,
        "preds_per_sec": round(s["requests_per_sec"] * batch, 2),
        "p99_ms": s["p99_ms"],
        "errors": s["errors"],
        # error budget consumed: failed fraction of all requests (the SLO
        # number the faulted leg is judged by)
        "error_rate": round(s["errors"] / attempts, 4),
        "faults_injected": (
            sum(sch.injected for sch in fault_schedules.values())
            if fault_schedules
            else 0
        ),
        "rss_start_mb": round(rss_samples[0][1], 1) if rss_samples else None,
        "rss_end_mb": round(rss_samples[-1][1], 1) if rss_samples else None,
        "rss_slope_mb_per_min": round(slope, 3),
        "loadgen_stats_mb_est": round(loadgen_mb, 1),
        # the leak signal: growth with the loadgen's own accounting removed
        "rss_slope_net_mb_per_min": round(
            slope - loadgen_mb / max(duration_s / 60.0, 1e-9), 3
        ),
        "loop_lag_p99_ms": round(
            lag_sorted[min(len(lag_sorted) - 1, int(0.99 * len(lag_sorted)))], 2
        ) if lag_sorted else None,
        "loop_lag_max_ms": round(max(lag_samples), 2) if lag_samples else None,
        **({"trace_summary": traces} if traces is not None else {}),
        **({"chaos": chaos_stats} if chaos_stats is not None else {}),
        **({"replicas": replica_stats} if replica_stats is not None else {}),
        **({"flight": flight_stats} if flight_stats is not None else {}),
        **({"profile": profile_stats} if profile_stats is not None else {}),
        **({"spec": spec_stats} if spec_stats is not None else {}),
        **({"prefix": prefix_stats} if prefix_stats is not None else {}),
        **({"paged": paged_stats} if paged_stats is not None else {}),
        **({"kv_tier": kvtier_stats} if kvtier_stats is not None else {}),
        **({"tp": tp_stats} if tp_stats is not None else {}),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--users", type=int, default=16)
    ap.add_argument("--model", default="iris_mlp")
    ap.add_argument("--features", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument(
        "--faults",
        action="store_true",
        help="run the soak twice — faults off, then a seeded fault schedule "
        "injected into the model node (retries enabled) — and report p99 + "
        "error budget for both legs side by side",
    )
    ap.add_argument(
        "--trace-summary",
        type=int,
        nargs="?",
        const=5,
        default=0,
        metavar="N",
        help="after the run, include the slowest-N retained traces (id, "
        "total ms, top-3 spans by self-time) in the report (default N=5)",
    )
    ap.add_argument(
        "--spec-k",
        type=int,
        default=0,
        help="run the soak against a generative deployment with draft-model "
        "speculative decoding (k proposals per dispatch); the report gains "
        "accept_rate / tokens_per_dispatch under 'spec'",
    )
    ap.add_argument(
        "--spec-tree",
        default="",
        metavar="B,B,...",
        help="run the soak with TREE speculation (decode_spec_tree, e.g. "
        "'2,2,1'): per-depth top-b candidate branches scored in one "
        "widened verify dispatch; the report gains accept_rate / "
        "tokens_per_ride under 'spec' and composes with --paged "
        "(same allocator audit)",
    )
    ap.add_argument(
        "--prefix-share",
        type=float,
        default=0.0,
        help="run the soak against a generative deployment with the prefix "
        "cache enabled and shape the prompt mix so this fraction of requests "
        "share a system prefix; the report gains hit_rate / tokens_saved / "
        "evictions under 'prefix'",
    )
    ap.add_argument(
        "--paged",
        action="store_true",
        help="run the soak against a generative deployment with a TIGHT "
        "paged-KV budget and a mixed shared-prefix/divergent prompt stream "
        "so copy-on-write and LRU pin reclaim run under load; the report "
        "gains pages_shared / cow_copies / pins_reclaimed under 'paged' "
        "(implies --prefix-share 0.6 unless set)",
    )
    ap.add_argument(
        "--tp",
        type=int,
        default=0,
        help="run the soak against a generative deployment decoded "
        "tensor-parallel over an N-position mesh (decode_mesh_axes={'tp': N}) "
        "on the host's cards, or N CPU positions with --device cpu; the "
        "shard audit lands under 'tp' and the end-of-run allocator check "
        "runs as usual",
    )
    ap.add_argument(
        "--replicas",
        type=int,
        default=0,
        help="run the soak against a REPLICATED generative deployment: N "
        "decode-scheduler replicas behind the prefix-affinity router "
        "(decode_replicas=N; implies --paged and a multi-group shared-"
        "prefix mix); the report gains per-replica admissions/hits and "
        "the routing split under 'replicas', every replica's allocator is "
        "audited, and the aggregate prefix hit rate must clear the "
        "analytic round-robin floor",
    )
    ap.add_argument(
        "--profile",
        default="",
        metavar="FILE",
        help="after a generative run, dump the decode-loop sampling "
        "profiler's folded stacks (flamegraph input) to FILE and FAIL if "
        "no stack was captured — the `make profile-smoke` gate; the "
        "report gains samples/hz/top frames under 'profile'",
    )
    ap.add_argument(
        "--kill-replica",
        default="",
        metavar="N@T",
        help="with --replicas: at T seconds into the run, arm a "
        "deterministic induced allocator-OOM on replica N's next decode "
        "round — its loop crashes for real, the router evicts it, migrates "
        "its in-flight generations, and the health poller readmits it via "
        "the half-open probe; the run FAILS unless clients saw zero "
        "errors, the eviction fired, and (time permitting) the replica "
        "was readmitted. The report gains the lifecycle counters under "
        "'chaos'",
    )
    ap.add_argument(
        "--drain-replica",
        default="",
        metavar="N@T",
        help="with --replicas: at T seconds into the run, gracefully drain "
        "replica N (stop admission, migrate stragglers, spill its prefix "
        "pages to the store + push them to their new rendezvous homes, "
        "release the device); the run FAILS unless clients saw zero "
        "errors and the post-drain warm hit rate stays within 5%% of "
        "pre-drain (when enough post-drain traffic ran to judge)",
    )
    ap.add_argument(
        "--kv-overflow",
        action="store_true",
        help="run the soak against a generative deployment whose device "
        "prefix index is squeezed to TWO entries under an 8-group shared-"
        "prefix mix, with a host-RAM KV tier hung below it — sustained "
        "evict/demote + revisit/promote churn with the allocator audit and "
        "zero-recompile gate live; the run FAILS unless demotions AND "
        "promotions both fired and no decode program recompiled; the "
        "report gains the tier counters under 'kv_tier' (implies --paged)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device the server runs on (default: the card; 'cpu' "
        "asks for the host)",
    )
    ap.add_argument("--fault-seed", type=int, default=1337)
    ap.add_argument("--fault-error-rate", type=float, default=0.3)
    ap.add_argument("--fault-latency-ms", type=float, default=0.0)
    ap.add_argument(
        "--fault-flap-period",
        type=int,
        default=0,
        help="calls per unhealthy window (0 = steady error rate)",
    )
    args = ap.parse_args(argv)

    try:
        tp_positions(args.tp, args.device)
    except RuntimeError as e:
        sys.exit(str(e))

    def _run(fault_spec=None) -> dict:
        return asyncio.run(
            soak(
                duration_s=args.duration,
                users=args.users,
                model=args.model,
                features=args.features,
                batch=args.batch,
                fault_spec=fault_spec,
                trace_summary=args.trace_summary,
                spec_k=args.spec_k,
                spec_tree=args.spec_tree,
                prefix_share=args.prefix_share,
                paged=args.paged,
                tp=args.tp,
                replicas=args.replicas,
                profile_out=args.profile,
                kill_replica=args.kill_replica,
                drain_replica=args.drain_replica,
                kv_overflow=args.kv_overflow,
                device=args.device,
            )
        )

    if not args.faults:
        out = _run()
    else:
        from seldon_core_tpu_torch.engine.faults import FaultSpec

        spec = FaultSpec(
            error_rate=args.fault_error_rate,
            latency_ms=args.fault_latency_ms,
            flap_period=args.fault_flap_period,
            seed=args.fault_seed,
        )
        baseline = _run()
        faulted = _run(fault_spec=spec)
        out = {
            "fault_seed": args.fault_seed,
            "baseline": baseline,
            "faulted": faulted,
            # the resilience claim in one number: how much error budget the
            # injected fault rate actually burned after retries absorbed it
            "p99_delta_ms": round(faulted["p99_ms"] - baseline["p99_ms"], 2),
            "error_rate_delta": round(
                faulted["error_rate"] - baseline["error_rate"], 4
            ),
        }
    json.dump(out, sys.stdout)
    print()


if __name__ == "__main__":
    main()
