"""Continuous-batching decode scheduler for the generative tier.

Port of ``seldon_core_tpu/serving/decode_scheduler.py`` (Orca-style
iteration-level scheduling over a vLLM-style paged KV pool):

- ONE per-step program (``_step_logits``: ``paged_decode_step``, then
  sampling) runs over the shared page pool through static-shape
  ``[n_slots, max_pages]`` block tables; slots are assigned per sequence
  and freed on completion.
- Between steps the scheduler admits waiting sequences into free slots and
  retires finished ones (EOS or the request's own ``max_new_tokens``), so
  batch composition changes at step boundaries while every dispatch keeps
  its shape.
- Prompts are computed by chunk rounds (``_chunk_logits``) from a small
  ladder of chunk buckets, interleaved with decode steps; with
  ``decode_prefill_chunk`` a long prompt spreads over several rounds.
- Prefix reuse (``decode_prefix_slots``): a host-side radix index over
  prompt prefixes whose entries reference pool pages; an admission maps the
  longest match's pages into its block table (refcount bumps, no copy) and
  computes only the uncovered suffix.
- Draft-model speculation (``decode_draft_model`` with ``decode_spec_k``,
  or ``decode_spec_tree`` for a token tree): a small draft decoder keeps a
  flat per-slot cache beside the pool and proposes k tokens (or a whole
  candidate tree) per slot in one dispatch (``_fused_draft`` /
  ``_fused_draft_tree``); the target scores them in one widened dispatch
  over the pool and accepts on the device (``_fused_verify`` /
  ``_fused_tree_verify``); slots advance by their accepted length plus a
  bonus token. A round reads back only (out_tokens, n_accepted).
  ``decode_spec_accept_floor`` runs the accept-driven controller
  (``_TreeAutoTuner``) that moves the depth between plain decode and the
  configured ceiling, and reshapes the tree's widths. Per request,
  ``meta.tags.spec_k`` and ``meta.tags.spec_tree`` tighten (``spec_k=0``
  opts out).
- Feature drafting (``zoo://draft?features=1``, the EAGLE-style head of
  ``models/decoder.init_feature_draft``): the draft conditions on the
  target's last hidden state. Each slot's feature is carried on the device
  ([n_slots, hidden] at the target's dtype) and every program that moves a
  position updates it where the round's carry mask (the generating slots)
  says so. Four keys take the place of step, chunk, draft admit and the
  tree pair: ``step_f``, ``chunk_f`` (which also prefills the head's flat
  cache with the chunk's prompt, so there is no draft admit),
  ``draft_feat`` and ``ftree_verify``; a chain config is promoted to the
  branching-1 tree. A prefix-warm admission opens the head's attention
  window at its computed suffix (``_draft_start``).
- Tokens stream to the caller as they are chosen (``on_token``), which is
  what the SSE route forwards.

Device work runs on one CUDA stream per scheduler (``_on_stream``), which
the loop's thread and the scheduler's one worker thread both enter, so the
order of the work on the card is the order in which either thread queued
it. Every (program, shape) key is one CUDA graph on the card (``ops/graphs.py``),
captured in ``warmup()`` over static inputs, the device block tables
(``PagedKVPool.bt_device``), the pool and the draft cache, which keep their
addresses for the scheduler's life; a round writes its arguments into the
static inputs and replays. The programs are captured up to the logits, and
sampling stays eager after them, with the draws per (seed, tick, stream)
unchanged. A speculative round pair samples inside the draft chain and the
acceptance, so only greedy rounds (every slot at temperature 0) replay the
captured pair; a round with a sampled slot runs the pair eagerly
(``stat_eager_rounds``). ``compile_counts()`` counts the keys built, per
program, under the JAX scheduler's names; ``warmup()`` builds every key
serving can need, so no new key may appear after it
(``recompiles_since_warmup() == 0``), the port's form of the JAX package's
zero-recompile guard. ``cuda_graphs=False`` runs the same keys eagerly on
the same static buffers (the eager twin).

Greedy equivalence: with greedy sampling every sequence gets, token for
token, the fused ``generate``'s output, whenever it was admitted and
whatever the draft proposes (on the card up to float32 near-ties: cuBLAS
may sum a slot batch, a widened verify and a bucket batch in other orders).

Telemetry, as in the JAX package: every round commits ONE flight frame
(``telemetry/flight.py``) at ``_commit_round`` — mode, active and
prefilling slots, admissions, retirements and the blocked cause, tokens,
speculation accepted and proposed, and each program family's wall split
into enqueue and blocked readback (``rdb_ns``) against the host gap, which
``with self._phase(P_X)`` blocks split by phase. On the card a replay
returns before the device finishes and ``.cpu()`` is where the host waits;
``ENGINE_FLIGHT_SYNC_TIMING=on`` synchronizes the scheduler's stream after
each dispatch so the enqueue column is the device's wall. The metrics
hooks (steps, TTFT, ITL, SLO attainment against ``decode_slo_ttft_ms`` /
``decode_slo_itl_ms`` and a request's deadline budget, goodput,
speculation, prefix reuse, the page pool, rounds, bubble, capture seconds)
report to the server's registry; each request's trace gets its admission,
prefill-chunk, verify and generate spans on the contexts captured at
submit (the loop runs in its own task, its dispatches on a worker thread).
The sampling profiler watches the loop's thread (``telemetry/profile.py``).

Pipelined rounds (the default; ``ENGINE_DECODE_PIPELINE=off`` or
``ENGINE_FLIGHT_SYNC_TIMING=on`` forces the serial loop): the loop's
thread queues the round's block tables, the step's (or the greedy round
pair's) replay and a ``non_blocking`` copy of its tokens into pinned host
memory with an event behind it, then runs round N+1's host phases while
the card works (``_overlap_window``: admission decisions into a shadow
list, the next chunk round's input arrays, the queue-expiry sweep and the
pool gauges), and only then waits for the event: polled between turns of
the event loop for up to ``readback_spin_s``, then synchronized on the
worker (``stat_readback_handoffs``). The decisions are installed after the readback
walks (``_apply_pending``), so each round admits what the serial loop
would. A speculative round with a sampled slot runs its eager pair on the
worker thread while the window runs on the loop. The serial loop runs
every dispatch and its readback on the worker thread, as before: it is the
twin whose output the pipelined loop is held to.

Host and store KV tiers (``decode_kv_host_bytes``,
``decode_kv_store_tier``; ``serving/kv_host_tier.py``): a prefix entry the
pool reclaims or the index's cap evicts demotes its pages' bytes to host
memory (then to the store), and an admission whose device match is
shallower than a tier's promotes the entry back into ``preseed_pin``-pinned
free pages, inside the overlap window when the admission is decided there.

Fleet replicas (``serving/affinity_router.py``): ``scheduler_for_executor``
builds ``decode_replicas`` schedulers behind the affinity router, each with
its own pool, index, graph cache, stream and worker over the runtime's
parameter tensors. A replica answers ``health_probe``, reports
``queue_depth``, exports its prefix pages (``export_prefix_state``,
``export_prefix_entry``; only the chosen pages' columns leave the card) and
resumes a migrated generation (``submit(_replay_tokens=)``: the prompt
prefills through the warmed chunk keys, then each replayed position rides
a plain round whose input is the recorded token, and nothing replayed is
streamed again). ``engine/faults.py::install_decode_faults`` arms its chaos
hooks: a round that hangs on the loop, an induced allocator OOM, a
readback stall on the worker, dropped probes.

Tensor-parallel decode (``tpu.decode_mesh_axes``, e.g. ``{"tp": 4}``;
``parallel/tp.py``): the target and the draft are placed by the head/FFN
rule over the mesh's positions (``devices``, which may repeat a device),
the pool's payloads and the draft cache hold one head shard per position,
and every fused program runs over the positions with two psums a layer.
Positions on one card run inside the same captured graph per dispatch key;
positions over distinct cards run eagerly. The pipelined loop, the KV tiers
and speculation sit above the programs and do not change. The queue timeout
is honoured, and a request's deadline budget is enforced at the ingress and
judged here for goodput.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from seldon_core_tpu_torch import telemetry
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_device
from seldon_core_tpu_torch.engine.resilience import current_deadline
from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch.models.decoder import (
    STREAM_DRAFT,
    STREAM_VERIFY,
    decoder_dims,
    draft_propose,
    draft_propose_features,
    draft_propose_tree,
    draft_tree_commit,
    feature_chunk_prefill,
    init_slot_cache,
    is_feature_draft,
    paged_chunk_prefill,
    paged_decode_step,
    paged_tree_commit,
    paged_tree_verify,
    paged_verify_step,
    prefill,
    sample_tokens,
    sampling_generator,
    speculative_accept,
    speculative_accept_tree,
    _each_block,
    _tree_tables,
)
from seldon_core_tpu_torch.models.spec_tree import MAX_TREE_NODES, SpecTree, parse_spec_tree
from seldon_core_tpu_torch.ops.graphs import GraphCache
from seldon_core_tpu_torch.parallel.tp import Placed, decode_mesh_problems, decode_tp_mesh, place_decoder
from seldon_core_tpu_torch.persistence.state import make_state_store
from seldon_core_tpu_torch.serving.affinity_router import capture_prefix_len, usable_prefix_len
from seldon_core_tpu_torch.serving.kv_host_tier import KVHostTier
from seldon_core_tpu_torch.serving.kv_pool import PagedKVPool
from seldon_core_tpu_torch.telemetry import profile as profile_mod
from seldon_core_tpu_torch.telemetry.flight import (
    F_CHUNK,
    F_COPY,
    F_DRAFT,
    F_STEP,
    F_VERIFY,
    P_ACCEPT_WALK,
    P_ADMIT,
    P_ALLOC,
    P_COMMIT,
    P_EMIT_SLO,
    P_PREFIX_MATCH,
    P_SAMPLING,
    P_SCATTER,
    FlightFrame,
    FlightRecorder,
    PhaseTimer,
    decode_pipeline_enabled,
    sync_timing_enabled,
)
from seldon_core_tpu_torch.telemetry.flight import register as flight_register

log = logging.getLogger(__name__)

OnToken = Callable[[int, int], None]  # (token_id, index within the generation)


def _sampling_inputs(temps: np.ndarray, topks: np.ndarray, device) -> tuple | None:
    """A round's temperatures and top-k on the device, or None when every
    slot is greedy. Uploaded before the round's program is queued: a
    blocking upload behind it would wait for the program."""
    if not (temps > 0).any():
        return None
    return to_device(temps, device), to_device(topks, device)


def _sample(logits, sampling: tuple | None, seed: int, tick: int) -> torch.Tensor:
    """Eager sampling after a program's logits: the greedy argmax, or draws
    from the (seed, tick) generator when any slot samples (``sampling``:
    ``_sampling_inputs``)."""
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_tokens(logits, *sampling, sampling_generator(seed, tick, logits.device))


def _step_logits(params, pool, bt, tokens, positions):
    """The captured half of one scheduler step: the paged decode step for
    every slot. Returns logits [n, V]; the pool is written in place."""
    return paged_decode_step(params, pool, bt, tokens, positions)[0]


def _chunk_logits(params, pool, bt, ids, positions, counts):
    """The captured half of one prefill chunk round: ``paged_chunk_prefill``
    over every slot (counts-0 slots ride along, their writes sent to the
    junk page) and the logits at each slot's last consumed position, which
    give the first generated token of a slot whose prompt completes this
    round. Returns logits [n, V]."""
    logits, _hidden, _ = paged_chunk_prefill(params, pool, bt, ids, positions, counts)
    idx = (counts.long() - 1).clamp(0, ids.shape[1] - 1)
    return logits[torch.arange(ids.shape[0], device=ids.device), idx]


def _step_feat_logits(params, pool, bt, tokens, positions, feats, fmask):
    """``_step_logits`` for feature-draft deployments: the same step, and
    the consumed position's hidden replaces the slot's carried feature
    ``feats`` [n, d] in place wherever ``fmask`` (the generating slots)
    holds, so a plain round keeps the next speculative round's draft root
    conditioned on the last consumed position."""
    logits, hidden, _ = paged_decode_step(params, pool, bt, tokens, positions)
    feats.copy_(torch.where(fmask[:, None], hidden.to(feats.dtype), feats))
    return logits


def _chunk_feat_logits(params, fparams, pool, bt, dck, dcv, ids, positions, counts, feats, starts):
    """``_chunk_logits`` for feature-draft deployments: the target's chunk,
    then the head's teacher-forced prefill of the same chunk into its flat
    cache under the same counts mask (``feature_chunk_prefill``: the head's
    prompt K/V rides the chunk round, so feature mode has no draft admit),
    and the carry: a slot that consumed prompt tokens takes the hidden of
    its last one. Returns the last consumed position's logits [n, V]."""
    logits, hidden, _ = paged_chunk_prefill(params, pool, bt, ids, positions, counts)
    rows = torch.arange(ids.shape[0], device=ids.device)
    idx = (counts.long() - 1).clamp(0, ids.shape[1] - 1)
    feature_chunk_prefill(fparams, dck, dcv, ids, hidden, feats, positions, counts, starts)
    feats.copy_(torch.where((counts > 0)[:, None], hidden[rows, idx].to(feats.dtype), feats))
    return logits[rows, idx]


# The speculative programs below take tensors already on the device: the
# round uploads every input before it queues the draft, because an upload
# between the draft and the verify would wait for the draft to finish.


def _scatter_prefill_rows(cache_k, cache_v, k_new, v_new, row_for_slot, valid_slot):
    """Write a prefill wave's K/V (k_new [L, rows, h, s, hd]) into the flat
    DRAFT cache, in place: slot j takes wave row ``row_for_slot[j]`` where
    ``valid_slot[j]`` and keeps its bytes elsewhere. Each slot selects its
    row, so no write has two sources."""
    s = k_new.shape[3]
    mask = valid_slot[None, :, None, None, None]

    def write(cache, new):  # new: the cache's heads of the wave's K/V
        sel = new.index_select(1, row_for_slot.to(new.device)).to(cache.dtype)  # [L, n_slots, h, s, hd]
        cache[:, :, :, :s] = torch.where(mask.to(cache.device), sel, cache[:, :, :, :s])

    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        _each_block(cache, new, 2, write)
    return cache_k, cache_v


def _fused_draft_admit(params, dcache_k, dcache_v, ids, row_for_slot, valid_slot):
    """Draft-side prompt prefill for slots whose target prefill completed:
    the draft shares no K/V with the target's pool, so its flat cache takes
    the FULL prompt in one bucketed dispatch, whatever prefix the target
    reused."""
    _, k_new, v_new = prefill(params, ids)
    return _scatter_prefill_rows(dcache_k, dcache_v, k_new, v_new, row_for_slot, valid_slot)


def _fused_draft(params, cache_k, cache_v, tokens, positions, temps, topks, generator, k):
    """Draft side of a chain round: k draft steps (``draft_propose``) from
    the round's draft stream. Returns (drafts [n, k], draft_logits [n, k,
    V]), the draft cache written in place."""
    drafts, dlogits, _, _ = draft_propose(params, cache_k, cache_v, tokens, positions, temps, topks, generator, k)
    return drafts, dlogits


def _fused_verify(params, pool, bt, tokens, drafts, draft_logits, positions, limits, temps, topks, generator):
    """Target side of a chain round: the widened [n, k+1] paged verify and
    the acceptance rule. Returns (out_tokens [n, k+1], n_accepted [n]) on
    the device, the pool written in place; the draft's proposals and
    logits never leave the device."""
    queries = torch.cat([tokens[:, None], drafts.long()], dim=1)
    logits, _hidden, _ = paged_verify_step(params, pool, bt, queries, positions)
    return speculative_accept(logits, drafts, draft_logits, limits, temps, topks, generator)


def _fused_draft_tree(params, cache_k, cache_v, tokens, positions, temps, topks, generator, tree):
    """Draft side of a tree round: the root step and ``tree.depth`` widened
    expansions (``draft_propose_tree``). Returns (node_tokens, block_logits,
    node_k, node_v); the draft cache gains only the root's entry."""
    return draft_propose_tree(params, cache_k, cache_v, tokens, positions, temps, topks, generator, tree)[:4]


def _fused_tree_verify(params, pool, bt, tokens, node_tokens, block_logits, node_k, node_v, dck, dcv, positions,
                       width_limits, temps, topks, generator, tree):
    """Target side of a tree round: the whole tree scored in one widened
    dispatch (``paged_tree_verify``; the pool is not written by the
    forward), the longest-accepted-path walk, then both commits: the
    accepted path's target K/V into the pool (every other column to junk
    page 0) and its draft K/V into the flat draft cache. Returns
    (out_tokens [n, depth+1], n_accepted [n]) on the device."""
    queries = torch.cat([tokens[:, None], node_tokens.long()], dim=1)
    logits, _hidden, new_k, new_v = paged_tree_verify(params, pool, bt, queries, positions, tree)
    out, acc, path_idx = speculative_accept_tree(logits, queries, block_logits, width_limits, temps, topks,
                                                 generator, tree)
    paged_tree_commit(pool, bt, new_k, new_v, path_idx, positions, acc)
    draft_tree_commit(dck, dcv, node_k, node_v, path_idx, positions, acc)
    return out, acc


def _fused_draft_feat(fparams, dck, dcv, feats, tokens, positions, starts, temps, topks, generator, tree):
    """Draft side of a feature round: the head's root step (the carried
    target feature fused with the last emitted token) and ``tree.depth``
    expansions autoregressing in feature space
    (``draft_propose_features``). Returns (node_tokens, block_logits,
    node_k, node_v), the layout of the token tree's draft."""
    return draft_propose_features(fparams, dck, dcv, feats, tokens, positions, starts, temps, topks, generator,
                                  tree)[:4]


def _fused_ftree_verify(params, pool, bt, tokens, node_tokens, block_logits, node_k, node_v, dck, dcv, feats, fmask,
                        positions, width_limits, temps, topks, generator, tree):
    """``_fused_tree_verify`` for feature-draft deployments: the same verify,
    walk and both commits, and the carry the next round's root needs: the
    target's hidden at the accepted path's last block (the root when
    nothing was accepted) replaces ``feats`` in place where ``fmask``
    holds. The readback stays (out_tokens, n_accepted)."""
    queries = torch.cat([tokens[:, None], node_tokens.long()], dim=1)
    logits, hidden, new_k, new_v = paged_tree_verify(params, pool, bt, queries, positions, tree)
    out, acc, path_idx = speculative_accept_tree(logits, queries, block_logits, width_limits, temps, topks,
                                                 generator, tree)
    paged_tree_commit(pool, bt, new_k, new_v, path_idx, positions, acc)
    draft_tree_commit(dck, dcv, node_k, node_v, path_idx, positions, acc)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last_blk = torch.gather(path_idx.long(), 1, acc.long()[:, None])[:, 0]
    feats.copy_(torch.where(fmask[:, None], hidden[rows, last_blk].to(feats.dtype), feats))
    return out, acc


class _TreeAutoTuner:
    """Accept-driven speculation controller (the JAX package's, unchanged):
    an EWMA of accepted/allowed moves the effective depth between plain
    decode (rate < ``floor``, with a periodic depth-1 probe) and the
    configured ceiling; on tree deployments ``reach[d]``, an EWMA of the
    probability that a riding slot's accepted path reaches depth d+1,
    narrows the widths of rarely reached depths (``reach / reach_hi``,
    floor 1; cut below ``reach_lo``), with a periodic full-shape probe while
    narrowed. Adaptation changes only data (per-slot limits and width
    masks), never a program shape, and never widens past the configured
    tree. ``floor <= 0`` pins the configured shape."""

    def __init__(
        self,
        floor: float,
        ceiling: int,
        tree: SpecTree | None = None,
        alpha: float = 0.2,
        probe_every: int = 16,
        reach_hi: float = 0.5,
        reach_lo: float = 0.05,
    ):
        self.floor = float(floor)
        self.ceiling = int(ceiling)
        self.tree = tree
        self.alpha = float(alpha)
        self.probe_every = int(probe_every)
        self.reach_hi = float(reach_hi)
        self.reach_lo = float(reach_lo)
        # optimistic start: the first rounds run the full configured shape
        self.rate = 1.0
        self.reach = [1.0] * (tree.depth if tree is not None else 0)
        self.plain_rounds = 0
        self.spec_rounds = 0
        self.probes = 0
        self.probing = False  # the last decide() returned a probe round

    def update(self, accepted: int, allowed: int, paths=None) -> None:
        """Per-round observation: total accepted/allowed, and optionally the
        riding slots' (accepted, limit) pairs for the reach estimate."""
        if allowed > 0:
            self.rate += self.alpha * (accepted / allowed - self.rate)
        if not paths or self.tree is None:
            return
        # reach[0] stays 1.0: depth-1 nodes are reachable by construction
        for d in range(1, len(self.reach)):
            samples = [1.0 if a >= d else 0.0 for a, lim in paths if lim >= d + 1]
            if samples:
                self.reach[d] += self.alpha * (sum(samples) / len(samples) - self.reach[d])

    def depth(self) -> int:
        """Effective depth for the next round (0: plain). Moves the probe
        counters: call once per round (``decide``)."""
        if self.floor <= 0.0:
            return self.ceiling
        if self.rate < self.floor:
            self.plain_rounds += 1
            if self.probe_every and self.plain_rounds % self.probe_every == 0:
                self.probes += 1
                self.probing = True
                return 1
            return 0
        self.plain_rounds = 0
        frac = (self.rate - self.floor) / max(1.0 - self.floor, 1e-6)
        return max(1, min(self.ceiling, int(np.ceil(frac * self.ceiling))))

    def widths(self) -> tuple[int, ...] | None:
        """Tuned per-depth width ceiling for the next round (None: no tree
        or adaptation off). Depth 1 keeps its configured width."""
        if self.tree is None or self.floor <= 0.0:
            return None
        base = self.tree.branching
        out = [base[0]]
        for d in range(1, len(base)):
            r = self.reach[d]
            if r < self.reach_lo:
                out.append(0)
            elif r >= self.reach_hi:
                out.append(base[d])
            else:
                out.append(max(1, int(np.ceil(base[d] * r / self.reach_hi))))
        if self.probing or tuple(out) == base:
            return base if self.probing else tuple(out)
        # narrowed: a periodic full-shape probe so reach can recover
        self.spec_rounds += 1
        if self.probe_every and self.spec_rounds % self.probe_every == 0:
            self.probes += 1
            self.probing = True
            return base
        return tuple(out)

    def decide(self) -> tuple[int, tuple[int, ...] | None, bool]:
        """One call per round: (effective depth, tuned width ceiling or
        None, probe flag). A depth-0 (plain) round skips the width tuner, so
        it spends no width-probe on a round that observes nothing."""
        self.probing = False
        d = self.depth()
        if d == 0:
            return 0, None, False
        w = self.widths()
        return d, w, self.probing


class _PipelineGate:
    """Per-stage cost gate for the pipelined loop's overlap window (the
    JAX package's, unchanged): an EWMA of each stage's measured host cost,
    with a floor below which the stage stops riding the pipeline (moving a
    trivially cheap phase across the round boundary buys nothing). A
    skipped stage still probes every ``probe_every``-th opportunity, so a
    workload whose host cost grows re-enables it. Optimistic start: an
    unmeasured stage always runs."""

    __slots__ = ("floor_ns", "alpha", "probe_every", "ewma", "skips")

    def __init__(self, floor_ns: float = 1_000.0, alpha: float = 0.2, probe_every: int = 32):
        self.floor_ns = float(floor_ns)
        self.alpha = float(alpha)
        self.probe_every = int(probe_every)
        self.ewma: dict[str, float] = {}
        self.skips: dict[str, int] = {}

    def allow(self, stage: str) -> bool:
        mean = self.ewma.get(stage)
        if mean is None or mean >= self.floor_ns:
            return True
        n = self.skips.get(stage, 0) + 1
        self.skips[stage] = n
        return self.probe_every > 0 and n % self.probe_every == 0

    def note(self, stage: str, ns: int) -> None:
        prev = self.ewma.get(stage)
        self.ewma[stage] = float(ns) if prev is None else prev + self.alpha * (ns - prev)


class _PendingAdmit:
    """One admission decided under an in-flight dispatch (shadow round
    state): held un-installed until ``_apply_pending``, so the readback
    walks see exactly the dispatch-time slot table. The allocator
    reservation (``try_admit``) is the decision's only live footprint, so
    ``alloc.retire(slot)`` is the whole rollback."""

    __slots__ = ("seq", "slot", "entry", "reuse", "t0")

    def __init__(self, seq: "_Seq", slot: int, entry, reuse: int, t0: int):
        self.seq = seq
        self.slot = slot
        self.entry = entry
        self.reuse = reuse
        self.t0 = t0


class _PrefixEntry:
    """One cached prefix: its tokens and a reference to the pool pages that
    hold its K/V (a kv_pool pin id), its LRU age and its hits."""

    __slots__ = ("tokens", "pages", "pin_id", "last_use", "hits")

    def __init__(self, tokens: np.ndarray, pages: list[int], pin_id: int):
        self.tokens = np.asarray(tokens, np.int32)
        self.pages = list(pages)
        self.pin_id = pin_id
        self.last_use = 0
        self.hits = 0


class PrefixIndex:
    """Host-side radix index over token prefixes whose K/V lives in pool
    pages: a hit maps the entry's pages into the reader's block table.

    Matching walks the token trie as deep as the prompt agrees with any
    entry (longest common prefix: causal K/V at position i depends only on
    tokens 0..i). ``max_entries`` caps the index (insert evicts the LRU entry
    and returns it, so the caller releases its pin); the pool reclaims
    pin-only pages under pressure and drops their entries through
    ``remove_by_pins``."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self.entries: dict[int, _PrefixEntry] = {}  # pin_id -> entry
        self._clock = 0
        self.evictions = 0  # entries the cap or a reclaim pushed out
        self._root: dict[int, list] = {}  # token -> [children, entry]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt, touch: bool = True) -> tuple["_PrefixEntry | None", int]:
        """Longest common prefix of ``prompt`` with any entry: (entry,
        depth). ``touch=False`` peeks without bumping the LRU age."""
        node, ent, depth = self._root, None, 0
        for t in prompt:
            nxt = node.get(int(t))
            if nxt is None:
                break
            node, ent = nxt[0], nxt[1]
            depth += 1
        if ent is None:
            return None, 0
        if touch:
            ent.last_use = self._tick()
            ent.hits += 1
        return ent, depth

    def insert(self, tokens, pages: list[int], pin_id: int) -> tuple["_PrefixEntry", "_PrefixEntry | None"]:
        """Index a captured prefix; returns (entry, evicted), ``evicted``
        being the LRU entry the cap pushed out (the caller releases its
        pin) or None."""
        evicted = None
        if len(self.entries) >= self.max_entries:
            evicted = min(self.entries.values(), key=lambda e: e.last_use)
            self.remove(evicted)
            self.evictions += 1
        e = _PrefixEntry(tokens, pages, pin_id)
        e.last_use = self._tick()
        self.entries[pin_id] = e
        self._index(e)
        return e, evicted

    def _index(self, e: "_PrefixEntry") -> None:
        node = self._root
        for t in e.tokens:
            nxt = node.setdefault(int(t), [{}, e])
            nxt[1] = e  # the newest entry through a node wins
            node = nxt[0]

    def _rebuild(self) -> None:
        self._root = {}
        for other in self.entries.values():
            self._index(other)

    def remove(self, e: "_PrefixEntry") -> None:
        del self.entries[e.pin_id]
        self._rebuild()

    def remove_by_pins(self, pin_ids) -> int:
        """Pool-pressure reclaim callback: drop the entries whose pins the
        allocator dropped, with one trie rebuild. Returns how many."""
        dropped = [pin_id for pin_id in pin_ids if self.entries.pop(pin_id, None) is not None]
        if dropped:
            self._rebuild()
            self.evictions += len(dropped)
        return len(dropped)

    def clear(self) -> None:
        self.entries.clear()
        self._root = {}


class _Seq:
    """One in-flight generation request."""

    __slots__ = (
        "prompt", "max_new", "temperature", "top_k", "spec_k", "tree_widths",
        "on_token", "future", "tokens", "pos", "deadline", "prefilling",
        "prefill_pos", "chunk_cap", "cache_prefix", "t_enqueued", "t_last_token",
        "slo_deadline", "slo_ok", "slo_sink", "prefix_len", "chunk_idx", "trace_ctxs",
        "gen_spans", "uid", "slot", "kv_tier", "replay", "emit_base",
    )

    def __init__(self, prompt, max_new, temperature, top_k, spec_k, on_token, future):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.spec_k = spec_k  # this request's speculation depth cap (0: plain)
        # tree deployments: the per-depth widths this request rides (the
        # deployment tree tightened by meta.tags.spec_tree); () elsewhere
        self.tree_widths: tuple[int, ...] = ()
        self.on_token = on_token
        self.future = future
        # the scheduler's serial number for this request (submit order): a
        # chunk plan's key tells two tenants of one slot apart by it
        self.uid = 0
        self.slot = -1
        self.tokens: list[int] = []
        self.pos = 0
        self.deadline = 0.0  # admission deadline (perf_counter; 0: none)
        # incremental prefill: prefill_pos is the next prompt position to
        # compute (it starts past the span reused from the prefix pool)
        self.prefilling = False
        self.prefill_pos = 0
        self.chunk_cap = 0  # per-round prefill token cap (0: the whole suffix)
        self.cache_prefix = 0  # meta.tags.cache_prefix capture hint
        # telemetry: arrival and last-token times (TTFT, ITL), the deadline
        # budget this request is judged against for goodput (perf_counter;
        # 0: none) and its SLO verdict, reported through slo_sink
        self.t_enqueued = time.perf_counter()
        self.t_last_token = 0.0
        self.slo_deadline = 0.0
        self.slo_ok = True
        self.slo_sink = None
        self.prefix_len = 0  # prompt positions reused from the prefix pool
        self.chunk_idx = 0
        # meta.tags.kv_tier, tighten-only: "" the whole ladder, "host" no
        # store consult, "off" no promotion (the device match still applies)
        self.kv_tier = ""
        # a migrated generation's resume: positions below emit_base take the
        # token a dead replica already streamed (``replay``) and are not
        # streamed again
        self.replay: tuple[int, ...] = ()
        self.emit_base = 0
        # the submitter's trace contexts, captured at submit: the loop runs
        # in its own task, so spans go to each sequence's traces explicitly
        self.trace_ctxs = telemetry.current_contexts()
        self.gen_spans: list = []  # open "decode.generate" spans, one per context


class DecodeScheduler:
    """Slot-based continuous-batching decode loop for one decoder model.

    ``params`` is the decoder's parameter tree as tensors on one device
    (``ModelRuntime.params``). ``seq_len`` is the fixed prompt bucket and
    ``max_new_tokens`` the generation cap the pool is sized for
    (``max_ctx = seq_len + max_new_tokens``). ``draft_params`` (on the same
    device) with ``spec_k`` or ``spec_tree`` turns speculation on."""

    def __init__(
        self,
        params,
        *,
        seq_len: int,
        max_new_tokens: int,
        n_slots: int = 8,
        eos_id: int = -1,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        queue_timeout_s: float = 0.0,
        draft_params=None,
        spec_k: int = 0,
        spec_tree: str = "",
        spec_accept_floor: float = 0.0,
        prefix_slots: int = 0,
        prefix_ctx: int = 0,
        prefill_chunk: int = 0,
        kv_page_size: int = 0,
        kv_pages: int = 0,
        kv_dtype: str = "",
        kv_host_bytes: int = 0,
        kv_store=None,
        dtype: torch.dtype | None = None,
        cuda_graphs: bool = True,
        metrics: NullMetrics | None = None,
        deployment_name: str = "",
        slo_ttft_ms: float = 0.0,
        slo_itl_ms: float = 0.0,
        replica_id: int = 0,
        mesh_axes: dict | None = None,
        devices=None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if spec_k > 0 and draft_params is None:
            raise ValueError(f"spec_k={spec_k} needs a draft model (decode_draft_model)")
        dims = decoder_dims(params)
        self.max_ctx = seq_len + max_new_tokens
        if self.max_ctx > dims["max_len"]:
            raise ValueError(
                f"seq_len {seq_len} + max_new_tokens {max_new_tokens} exceeds "
                f"the position table ({dims['max_len']})"
            )
        self.params = params
        self.seq_len = seq_len
        self.max_new_tokens = max_new_tokens
        self.n_slots = n_slots
        self._init_speculation(dims, draft_params, int(spec_k), str(spec_tree or "").strip(), spec_accept_floor)
        # tensor-parallel decode mesh (parallel/tp.py): the target and the
        # draft are placed by the head/FFN rule up front, and every program
        # below runs over the mesh's positions. Raises on an unservable
        # request (too many devices, indivisible heads/ffn): the serving
        # builder pre-checks and warn-disables
        self.mesh, self._tp_axis, self.tp = decode_tp_mesh(mesh_axes, params, self.draft_params, devices)
        if self.mesh is not None:
            self.params = params = place_decoder(params, self.mesh, self._tp_axis)
            if self.spec_enabled:
                self.draft_params = place_decoder(self.draft_params, self.mesh, self._tp_axis)
            if self.mesh.n_devices > 1 and cuda_graphs:
                # one CUDA graph cannot span cards
                log.warning("decode mesh %s spans %d devices: its rounds run eagerly, not as captured graphs",
                            self.mesh.shape, self.mesh.n_devices)
                cuda_graphs = False
        # span attributes distinguishing sharded deployments in /traces
        self._mesh_attrs = (
            {"tp": self.tp, "mesh_axes": ",".join(f"{k}={v}" for k, v in (mesh_axes or {}).items())}
            if self.mesh is not None
            else {}
        )
        self.eos_id = int(eos_id)
        self.default_temperature = float(temperature)
        self.default_top_k = int(top_k)
        # how long a request may wait un-admitted before REQUEST_TIMEOUT
        self.queue_timeout_s = float(queue_timeout_s)
        self.replica_id = int(replica_id)  # its arm in a fleet (0 alone)
        # the decode-tier chaos profile (engine/faults.install_decode_faults)
        self._faults = None
        self._seed = int(seed)
        self._tick = 0  # sampling draws are deterministic in (seed, tick)

        self.prefix_enabled = prefix_slots > 0
        self.prefix_slots = int(prefix_slots) if self.prefix_enabled else 0
        self.prefix_ctx = min(int(prefix_ctx) or seq_len, seq_len) if self.prefix_enabled else 0
        self.prefill_chunk = min(max(0, int(prefill_chunk)), seq_len)
        # power-of-four chunk ladder up to the chunk cap (or the prompt)
        top = self.prefill_chunk or seq_len
        cb, b = [], 1
        while b < top:
            cb.append(b)
            b *= 4
        self.chunk_buckets = tuple(cb) + (top,)

        # one captured graph per (program, shape) key: compile_counts()
        self.graphs = GraphCache(params["tok_emb"].device, capture=cuda_graphs)
        dtype = dtype if dtype is not None else params["tok_emb"].dtype
        # spec_k columns of headroom in the pool and the draft cache: a
        # chain round writes a fixed [k+1]-wide block at each slot's
        # position, which for a slot one token from its budget reaches
        # spec_k past max_ctx (the flat draft cache would otherwise clamp
        # the block backwards over accepted entries)
        self._cache_ctx = self.max_ctx + self.spec_k
        self.pool = PagedKVPool(
            params,
            n_slots=n_slots,
            cache_ctx=self._cache_ctx,
            page_size=kv_page_size,
            n_pages=kv_pages,
            kv_dtype=kv_dtype,
            dtype=dtype,
            graphs=self.graphs,
        )
        self._dtype = dtype
        dev = self.pool.device
        # the one stream every device call of this scheduler is queued on,
        # from the loop's thread and from the worker's (a stream is a
        # per-thread setting in PyTorch: both enter this one), so a CoW copy
        # or a promotion queued after a pipelined replay runs after it
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._pinned: dict[tuple, torch.Tensor] = {}  # pipelined readback buffers
        # the greedy round pair's temperatures and top-k: a round with no
        # generator reads neither
        self._zf = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        self._zi = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.stat_eager_rounds = 0  # sampled round pairs, run eagerly
        if self.spec_enabled:
            # head-sharded over a decode mesh, as the pool's payloads
            self._dck, self._dcv = init_slot_cache(self.draft_params, n_slots, self._cache_ctx, dtype)
            if self.feature_draft:
                # each slot's carried target feature (the hidden at its last
                # consumed position, at the target's dtype), which every
                # program that moves a position updates on the device, and
                # each slot's draft attention window start (host data: the
                # prefix a warm admission reused has no draft K/V)
                self._feat = torch.zeros((n_slots, dims["hidden"]), dtype=dtype, device=dev)
                self._draft_start = np.zeros(n_slots, np.int32)
            if self.spec_tree is not None:
                # the tree's constant tables go to the device now, never
                # inside a program (a capture refuses an upload)
                _tree_tables(self.spec_tree, dev)
        if self.prefix_enabled:
            self._prefix_index = PrefixIndex(self.prefix_slots)
            self.pool.alloc.on_pins_reclaimed = self._on_pins_reclaimed
        # demand-paged prefix tiers below the pool: host numpy state, no
        # dispatch key. ``kv_store`` is the store tier under the host tier
        # (``persistence.state.make_state_store`` of the JAX scheduler's
        # ``kv_store_url``), None for host only
        self._host_tier = None
        if self.prefix_enabled and int(kv_host_bytes) > 0:
            self._host_tier = KVHostTier(
                int(kv_host_bytes),
                page_size=self.pool.page_size,
                kv_dtype=self.pool.kv_dtype,
                store=kv_store,
                deployment=deployment_name or "decode",
                metrics=metrics,
            )
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="seldon-decode")
        self._slots: list[_Seq | None] = [None] * n_slots
        self._free: list[int] = list(range(n_slots - 1, -1, -1))
        self._waiting: collections.deque[_Seq] = collections.deque()
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        self._warmup_keys: int | None = None

        self.stat_steps = 0
        self.stat_admitted = 0
        self.stat_retired = 0
        self.stat_peak_active = 0
        self.stat_prefix_hits = 0
        self.stat_prefix_misses = 0
        self.stat_prefix_tokens_saved = 0
        self.stat_prefix_preseeded = 0
        self.stat_prefix_captures = 0
        # the tiers: device evictions demoted, misses promoted back, the
        # promotions made inside an overlap window, and the demotions made
        # there with the ns their page readback held the window
        self.stat_tier_demotions = 0
        self.stat_tier_promotions = 0
        self.stat_tier_promote_overlap = 0
        self.stat_tier_demote_overlap = 0
        self.stat_tier_demote_overlap_ns = 0
        self.stat_chunk_dispatches = 0
        # rounds whose queue head could not reserve pages
        self.stat_admit_blocked_rounds = 0
        # speculation: accept rate = accepted / proposed (proposed counts
        # the depth positions a path could advance through), tokens per
        # target dispatch = emitted / dispatches; rides are generating
        # slots that rode a round with a nonzero limit, and ride_emitted
        # the tokens those slots emitted
        self.stat_spec_dispatches = 0
        self.stat_spec_proposed = 0
        self.stat_spec_accepted = 0
        self.stat_spec_emitted = 0
        self.stat_spec_rides = 0
        self.stat_spec_ride_emitted = 0
        self.stat_tokens = 0

        self._metrics = metrics or NullMetrics()
        self._deployment = deployment_name
        # SLO targets the attainment telemetry judges (0: not configured)
        self.slo_ttft_s = max(0.0, float(slo_ttft_ms)) / 1e3
        self.slo_itl_s = max(0.0, float(slo_itl_ms)) / 1e3
        # one frame per round into a bounded ring (ENGINE_FLIGHT=off: none),
        # read by GET /decode/flight and /decode/health
        self.flight = flight_register(
            FlightRecorder(
                n_slots=n_slots,
                name=deployment_name or "decode",
                slo_ttft_ms=float(slo_ttft_ms),
                slo_itl_ms=float(slo_itl_ms),
                replica_id=self.replica_id,
            )
        )
        self.flight.queue_depth_source = lambda: len(self._waiting)
        self._phases = PhaseTimer(enabled=self.flight.enabled)
        self._sync_timing = sync_timing_enabled()
        # pipelined rounds: round N+1's host phases run against the shadow
        # state below (pending admissions and a chunk plan keyed on the
        # rows it was built for) while round N's dispatch is in flight
        self.pipeline_enabled = decode_pipeline_enabled()
        self._gate = _PipelineGate()
        self._pending_admits: list[_PendingAdmit] = []
        self._pending_chunk_plan: tuple | None = None
        # the last overlap window ran the admission sundries (expiry sweep,
        # gauges): the next serial walk skips them once
        self._pending_admit_sweep = False
        self._seq_uid = 0
        self.stat_pipelined_rounds = 0  # rounds that ran an overlap window
        self.stat_pipeline_admits = 0  # admissions decided under a flight
        self.stat_pipeline_deferred = 0  # heads the pre-retire pool deferred
        self.stat_pipeline_rollbacks = 0  # decisions whose caller left in flight
        self.stat_pipeline_plans_used = 0  # chunk plans from a window consumed
        # the poll's bound (``_await_readback``): above a step's readback
        # wait under traffic, below a speculative round's
        self.readback_spin_s = 1e-3
        self.stat_readback_handoffs = 0  # readback waits handed to the worker
        self._in_overlap = False  # inside _overlap_window (promotion attribution)
        self._round_reset()

    def _init_speculation(self, dims: dict, draft_params, spec_k: int, tree_text: str, accept_floor: float) -> None:
        """The speculation config: a k-chain (``spec_k``) or a token tree
        (``tree_text``, whose depth then stands for spec_k: the per-request
        spec_k tighten caps the depth, meta.tags.spec_tree the widths), the
        draft's geometry checks and the accept-driven controller."""
        self.spec_tree: SpecTree | None = None
        if tree_text:
            if draft_params is None:
                raise ValueError("decode_spec_tree needs a draft model (decode_draft_model)")
            self.spec_tree = SpecTree.from_text(tree_text)
            if self.spec_tree.n_tree > MAX_TREE_NODES:
                raise ValueError(
                    f"decode_spec_tree {tree_text!r} flattens to {self.spec_tree.n_tree} nodes — "
                    f"the widened verify dispatch caps at {MAX_TREE_NODES}"
                )
        self.spec_enabled = draft_params is not None and (spec_k >= 1 or self.spec_tree is not None)
        # the EAGLE-style feature head (``models/decoder.init_feature_draft``,
        # marked by its ``fc`` fuse) always rides the tree programs: a chain
        # config is promoted to the branching-1 tree, which is the chain,
        # under the chain's verify headroom
        self.feature_draft = self.spec_enabled and is_feature_draft(draft_params)
        if self.feature_draft and self.spec_tree is None:
            if spec_k > MAX_TREE_NODES:
                raise ValueError(
                    f"decode_spec_k={spec_k} exceeds the widened-verify headroom "
                    f"({MAX_TREE_NODES} proposed tokens per dispatch)"
                )
            self.spec_tree = SpecTree.chain(max(1, spec_k))
        if self.spec_tree is not None:
            self.spec_k = self.spec_tree.depth
        else:
            self.spec_k = spec_k if self.spec_enabled else 0
            if self.spec_k > MAX_TREE_NODES:
                raise ValueError(
                    f"decode_spec_k={self.spec_k} exceeds the widened-verify headroom "
                    f"({MAX_TREE_NODES} proposed tokens per dispatch)"
                )
        self.draft_params = draft_params if self.spec_enabled else None
        self._adapt = _TreeAutoTuner(accept_floor, self.spec_k, self.spec_tree) if self.spec_enabled else None
        if not self.spec_enabled:
            return
        ddims = decoder_dims(draft_params)
        if ddims["vocab"] != dims["vocab"]:
            raise ValueError(
                f"draft vocab {ddims['vocab']} != target vocab {dims['vocab']} — "
                "speculation needs a shared vocabulary"
            )
        if self.max_ctx > ddims["max_len"]:
            raise ValueError(
                f"draft position table ({ddims['max_len']}) is smaller than "
                f"seq_len + max_new_tokens ({self.max_ctx})"
            )
        if self.feature_draft:
            if ddims["hidden"] != dims["hidden"]:
                raise ValueError(
                    f"feature draft hidden {ddims['hidden']} != target hidden {dims['hidden']} — "
                    "the head's fc fuse consumes the target's feature vector directly"
                )
            return  # the head's prompt K/V rides the chunk rounds: no draft admit
        # wave buckets of the draft's prompt prefill (one dispatch for the
        # slots whose target prefill completed in a round)
        buckets, b = [], 1
        while b < self.n_slots:
            buckets.append(b)
            b *= 2
        self.admit_buckets = tuple(buckets) + (self.n_slots,)

    # ------------------------------------------------------------ dispatch
    # Each method runs inside ``_on_stream()``: on the worker thread (the
    # serial loop, chunk rounds, copies) or on the loop's thread (the
    # pipelined rounds' ``*_enqueue``). The round's block tables are
    # already in ``pool.bt_device`` (``pool.load_block_tables``).
    def _on_stream(self):
        """The scheduler's stream as the calling thread's current stream
        (nothing off the card)."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _step_enqueue(self, toks, pos, temps, topks, tick, fmask=None) -> torch.Tensor:
        """Queue one step and its sampling; the next tokens [n] stay on the
        device. The entry's lock is released only after the sampling that
        reads its static logits is queued, so a later replay of the key
        runs after it on the stream. ``fmask`` [n] (feature mode): the
        generating slots, whose carried feature the step moves (None:
        none)."""
        n = len(toks)
        params, pool, bt = self.params, self.pool.state, self.pool.bt_device
        ins = [((n,), torch.int32), ((n,), torch.int32)]
        if self.feature_draft:
            feats = self._feat
            entry = self.graphs.entry(("step_f", n),
                                      lambda t, p, m: _step_feat_logits(params, pool, bt, t, p, feats, m),
                                      ins + [((n,), torch.bool)])
            args = (toks, pos, np.zeros(n, bool) if fmask is None else fmask)
        else:
            entry = self.graphs.entry(("step", n), lambda t, p: _step_logits(params, pool, bt, t, p), ins)
            args = (toks, pos)
        sampling = _sampling_inputs(temps, topks, self.pool.device)
        return entry.run(*args, post=lambda logits: _sample(logits, sampling, self._seed, tick))

    def _step(self, toks, pos, temps, topks, tick, fmask=None) -> np.ndarray:
        nxt = self._step_enqueue(toks, pos, temps, topks, tick, fmask)
        self._mark_enqueued()
        return nxt.cpu().numpy()

    def _chunk(self, ids, pos, counts, temps, topks, tick) -> np.ndarray:
        n = len(pos)
        params, pool, bt = self.params, self.pool.state, self.pool.bt_device
        ins = [(ids.shape, torch.int32), ((n,), torch.int32), ((n,), torch.int32)]
        if self.feature_draft:
            fparams, dck, dcv, feats = self.draft_params, self._dck, self._dcv, self._feat
            entry = self.graphs.entry(
                ("chunk_f",) + ids.shape,
                lambda i, p, c, st: _chunk_feat_logits(params, fparams, pool, bt, dck, dcv, i, p, c, feats, st),
                ins + [((n,), torch.int32)])
            args = (ids, pos, counts, self._draft_start.copy())
        else:
            entry = self.graphs.entry(("chunk",) + ids.shape,
                                      lambda i, p, c: _chunk_logits(params, pool, bt, i, p, c), ins)
            args = (ids, pos, counts)
        sampling = _sampling_inputs(temps, topks, self.pool.device)
        toks = entry.run(*args, post=lambda logits: _sample(logits, sampling, self._seed, tick))
        self._mark_enqueued()
        return toks.cpu().numpy()

    def _readback_async(self, t: torch.Tensor) -> tuple:
        """Queue ``t``'s copy into a pinned host buffer behind the work that
        makes it, and an event behind the copy: (buffer, event). Off the
        card the tensor is already on the host: (t, None). One buffer per
        shape, reused: a round reads its buffer before the next is queued."""
        if self._stream is None:
            return t, None
        key = (tuple(t.shape), t.dtype)
        host = self._pinned.get(key)
        if host is None:
            host = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)
        return host, done

    async def _await_readback(self, host: torch.Tensor, done) -> np.ndarray:
        """Wait for ``_readback_async``'s event, then copy the values out of
        the reused buffer. The event is polled between turns of the event
        loop (ingress and submits run meanwhile) for at most
        ``readback_spin_s``; a round still in flight then hands the wait to
        the worker (the event's synchronize(), which releases the GIL), so
        a long round never spins the loop's thread against the units and
        the compute pool it shares the GIL with."""
        if self._faults is not None:
            stall = self._faults.readback_stall_s()
            if stall > 0:
                # the chaos readback stall holds the worker, as a stalled
                # readback of the round in flight would
                await self._device_call(lambda: time.sleep(stall))
        if done is not None:
            end = time.perf_counter() + self.readback_spin_s
            while not done.query():
                if time.perf_counter() >= end:
                    self.stat_readback_handoffs += 1
                    await self._device_call(done.synchronize)
                    break
                await asyncio.sleep(0)
        return host.numpy().copy()

    def _draft_admit(self, ids, row_for_slot, valid_slot) -> None:
        """The draft's prompt prefill for a wave of slots (``ids`` [bucket,
        seq_len], slot j taking row row_for_slot[j] where valid_slot[j]);
        no readback."""
        dparams, dck, dcv, n = self.draft_params, self._dck, self._dcv, self.n_slots
        entry = self.graphs.entry(("draft_admit",) + ids.shape,
                                  lambda i, r, v: _fused_draft_admit(dparams, dck, dcv, i, r.long(), v),
                                  [(ids.shape, torch.int32), ((n,), torch.int32), ((n,), torch.bool)])
        entry.run(ids, row_for_slot, valid_slot, post=lambda _: None)

    def _spec_entries(self, n: int) -> tuple:
        """The greedy round pair's two entries: the draft program (static
        inputs: last tokens, positions, and in feature mode the draft
        window starts) and the verify program (static input: the per-slot
        limits, or width limits on a tree, and in feature mode the carry
        mask), which reads the draft's inputs and outputs where they lie."""
        dparams, params, dck, dcv = self.draft_params, self.params, self._dck, self._dcv
        pool, bt, zf, zi, tree, k = self.pool.state, self.pool.bt_device, self._zf, self._zi, self.spec_tree, self.spec_k
        ins = [((n,), torch.int32), ((n,), torch.int32)]
        if self.feature_draft:
            feats = self._feat
            draft = self.graphs.entry(
                ("draft_feat", n, tree.branching),
                lambda t, p, st: _fused_draft_feat(dparams, dck, dcv, feats, t.long(), p.long(), st.long(), zf, zi,
                                                   None, tree),
                ins + [((n,), torch.int32)])

            def ftree_verify_fn(wl, fm):
                t, p = (a.long() for a in draft.inputs[:2])
                node_toks, blogits, nk, nv = draft.outputs
                return _fused_ftree_verify(params, pool, bt, t, node_toks, blogits, nk, nv, dck, dcv, feats, fm, p,
                                           wl, zf, zi, None, tree)

            return draft, self.graphs.entry(("ftree_verify", n, tree.width), ftree_verify_fn,
                                            [((n, tree.depth), torch.int32), ((n,), torch.bool)])
        if tree is None:
            draft = self.graphs.entry(
                ("draft", n, k),
                lambda t, p: _fused_draft(dparams, dck, dcv, t.long(), p.long(), zf, zi, None, k), ins)

            def verify_fn(lim):
                t, p = (a.long() for a in draft.inputs)
                drafts, dlogits = draft.outputs
                return _fused_verify(params, pool, bt, t, drafts, dlogits, p, lim, zf, zi, None)

            return draft, self.graphs.entry(("verify", n, k + 1), verify_fn, [((n,), torch.int32)])
        draft = self.graphs.entry(
            ("draft_tree", n, tree.branching),
            lambda t, p: _fused_draft_tree(dparams, dck, dcv, t.long(), p.long(), zf, zi, None, tree), ins)

        def tree_verify_fn(wl):
            t, p = (a.long() for a in draft.inputs)
            node_toks, blogits, nk, nv = draft.outputs
            return _fused_tree_verify(params, pool, bt, t, node_toks, blogits, nk, nv, dck, dcv, p, wl, zf, zi,
                                      None, tree)

        return draft, self.graphs.entry(("tree_verify", n, tree.width), tree_verify_fn,
                                        [((n, tree.depth), torch.int32)])

    def _feature_inputs(self, fmask) -> tuple[tuple, tuple]:
        """The round pair's feature-mode static inputs, (the draft's window
        starts,) and (the verify's carry mask,); () and () otherwise.
        ``fmask`` None: no slot's carry moves."""
        if not self.feature_draft:
            return (), ()
        return (self._draft_start.copy(),), (np.zeros(self.n_slots, bool) if fmask is None else fmask,)

    def _spec_enqueue(self, toks, pos, lim, t0: int, fmask=None) -> torch.Tensor:
        """Queue the captured greedy round pair: [n, spec_k + 2] on the
        device, out_tokens then n_accepted, copied off the static outputs
        before the entries' locks are released."""
        draft, verify = self._spec_entries(len(toks))
        draft_extra, verify_extra = self._feature_inputs(fmask)
        with draft.lock, verify.lock, torch.inference_mode():
            draft.load(toks, pos, *draft_extra)
            verify.load(lim, *verify_extra)
            draft.replay()
            self._draft_done(t0)
            out, acc = verify.replay()
            return torch.cat([out, acc[:, None]], dim=1)

    def _spec(self, toks, pos, temps, topks, limits, wlimits, tick, fmask=None) -> tuple[np.ndarray, np.ndarray]:
        """One speculative round pair, draft then widened verify, and its one
        readback: (out_tokens [n, spec_k + 1], n_accepted [n]). Every input
        is uploaded before the draft is queued, and nothing between the two
        programs waits on the card. ``wlimits`` (tree deployments) replaces
        ``limits`` as the verify's per-slot mask; ``fmask`` (feature mode)
        marks the generating slots, whose carried feature the verify moves.
        A greedy round replays the captured pair; a round with a sampled
        slot runs it eagerly."""
        lim = limits if wlimits is None else wlimits
        t0 = time.perf_counter_ns()
        if (temps > 0).any():
            out, acc = self._spec_sampled(toks, pos, temps, topks, lim, tick, t0, fmask)
            res = torch.cat([out, acc[:, None]], dim=1)
        else:
            res = self._spec_enqueue(toks, pos, lim, t0, fmask)
        self._mark_enqueued()
        res = res.cpu().numpy()
        return res[:, :-1], res[:, -1]

    def _spec_sampled(self, toks, pos, temps, topks, lim, tick, t0: int, fmask=None) -> tuple:
        """The eager round pair: the draft's draws from stream 1 and the
        acceptance's from stream 2 of the tick's generator."""
        self.stat_eager_rounds += 1
        dev = self.pool.device
        toks_d, pos_d, temps_d, topks_d, lim_d = (to_device(a, dev) for a in (toks, pos, temps, topks, lim))
        toks_d, pos_d, bt_d = toks_d.long(), pos_d.long(), self.pool.bt_device
        g_draft = sampling_generator(self._seed, tick, dev, STREAM_DRAFT)
        g_verify = sampling_generator(self._seed, tick, dev, STREAM_VERIFY)
        tree = self.spec_tree
        if self.feature_draft:
            (starts,), (fm,) = self._feature_inputs(fmask)
            starts_d, fm_d = to_device(starts, dev).long(), to_device(fm, dev)
            node_toks, blogits, nk, nv = _fused_draft_feat(self.draft_params, self._dck, self._dcv, self._feat, toks_d,
                                                           pos_d, starts_d, temps_d, topks_d, g_draft, tree)
            self._draft_done(t0)
            return _fused_ftree_verify(self.params, self.pool.state, bt_d, toks_d, node_toks, blogits, nk, nv,
                                       self._dck, self._dcv, self._feat, fm_d, pos_d, lim_d, temps_d, topks_d,
                                       g_verify, tree)
        if tree is None:
            drafts, dlogits = _fused_draft(self.draft_params, self._dck, self._dcv, toks_d, pos_d, temps_d, topks_d,
                                           g_draft, self.spec_k)
            self._draft_done(t0)
            return _fused_verify(self.params, self.pool.state, bt_d, toks_d, drafts, dlogits, pos_d, lim_d,
                                 temps_d, topks_d, g_verify)
        node_toks, blogits, nk, nv = _fused_draft_tree(self.draft_params, self._dck, self._dcv, toks_d, pos_d,
                                                       temps_d, topks_d, g_draft, tree)
        self._draft_done(t0)
        return _fused_tree_verify(self.params, self.pool.state, bt_d, toks_d, node_toks, blogits, nk, nv,
                                  self._dck, self._dcv, pos_d, lim_d, temps_d, topks_d, g_verify, tree)

    def _on_worker(self, fn):
        with self._on_stream(), torch.inference_mode():
            return fn()

    # ------------------------------------------------------ round telemetry
    def _sync(self) -> None:
        """ENGINE_FLIGHT_SYNC_TIMING=on: wait for the device after a
        dispatch, so its family's column is the device's wall."""
        if self._sync_timing and self._stream is not None:
            self._stream.synchronize()

    def _mark_enqueued(self) -> None:
        """On the worker, between a dispatch's enqueue and its blocking
        readback: ``_timed_call`` splits the family's wall here."""
        self._sync()
        self._rb_mark_ns = time.perf_counter_ns()

    def _draft_done(self, t0: int, late: bool = False) -> None:
        """On the worker, after the draft program of a round (queued from
        ``t0``): its share of the call goes to the draft family. ``late``:
        it ran after the call's readback mark (the draft admit after a
        chunk), so it also leaves the readback column."""
        self._sync()
        self._rb_draft_ns = time.perf_counter_ns() - t0
        self._rb_draft_late = late

    async def _timed_call(self, family: int, fn):
        """_device_call with its wall attributed to one program family of
        the round's frame, split into enqueue and blocked readback at the
        worker's ``_mark_enqueued`` (no mark: all enqueue), less what a
        ``_draft_done`` moved to the draft family."""
        t0 = time.perf_counter_ns()
        self._rb_mark_ns = 0
        self._rb_draft_ns = 0
        stall = self._faults.readback_stall_s() if self._faults is not None else 0.0
        if stall > 0:
            fn = _stalled(fn, stall)
        try:
            return await self._device_call(fn)
        finally:
            t2 = time.perf_counter_ns()
            mark = self._rb_mark_ns or t2
            d = self._rb_draft_ns
            self._rb_busy[family] += t2 - t0 - d
            self._rb_rdb[family] += t2 - mark - (d if self._rb_draft_late else 0)
            self._rb_busy[F_DRAFT] += d

    def _round_reset(self, t_ns: int | None = None) -> None:
        """Reset the per-round flight accumulators (written on the hot path,
        read only at _commit_round)."""
        self._rb_busy = [0, 0, 0, 0, 0]  # ns per flight.FAMILIES entry
        self._rb_rdb = [0, 0, 0, 0, 0]  # the blocked-readback share of busy
        self._rb_mark_ns = 0
        self._rb_draft_ns = 0
        self._rb_draft_late = False
        self._rb_t0 = t_ns if t_ns is not None else time.perf_counter_ns()
        self._rb_admitted = 0
        self._rb_retired = 0
        self._rb_blocked = ""
        self._rb_tokens = 0
        self._rb_cow = 0
        self._rb_accepted = 0
        self._rb_proposed = 0
        self._rb_depth = 0
        self._rb_active = 0
        self._rb_probe = False
        self._rb_widths: tuple = ()
        self._rb_promotions = 0
        # shadow admissions still pending here are error-path residue (the
        # normal flow drains them at _apply_pending before the commit):
        # roll their reservations back
        for p in self._pending_admits:
            self.pool.alloc.retire(p.slot)
        self._pending_admits.clear()
        self._phases.reset()

    def _phase(self, p: int):
        """The round's host-phase ``with`` handle for a flight P_* constant
        (innermost phase wins; a no-op under ENGINE_FLIGHT=off). Never
        held across a dispatch: busy time is _timed_call's."""
        return self._phases.phase(p)

    def _kv_gauges(self) -> None:
        a = self.pool.alloc
        self._metrics.decode_kv_pool(self._deployment, a.free_pages, a.live_pages, a.prefix_pages)
        # pages resident per device: the page axis is NOT sharded (every
        # position holds all pages x its head shard), so the count matches
        # the pool-wide allocation while per-page BYTES scale 1/tp — the
        # tp label is what makes the gauge readable as per-device memory
        self._metrics.decode_kv_per_device(self._deployment, a.live_pages + a.prefix_pages, self.tp)

    def shard_audit(self) -> dict:
        """Per-shard audit of the device pools on a decode mesh (the soak
        harness runs this beside the allocator's host-side ``check()``):
        every pool and draft-cache component must be laid out across exactly
        the mesh's devices, 5-D payloads carrying heads/tp per position and
        replicated components full-size. Raises AssertionError on any
        divergence; returns a small report dict (``mesh_devices``: the
        positions, ``distinct_devices``: the devices behind them)."""
        pages = self.pool.alloc.live_pages + self.pool.alloc.prefix_pages
        if self.mesh is None:
            return {"tp": 1, "kv_pages_per_device": pages}
        mesh = self.mesh
        audited = 0

        def _check(name: str, arr) -> None:
            nonlocal audited
            if not isinstance(arr, Placed) or len(arr.parts) != mesh.size:
                raise AssertionError(f"{name}: not placed over the {mesh.size} mesh positions")
            devs = [t.device for t in arr.parts]
            if devs != list(mesh.positions):
                raise AssertionError(f"{name}: parts on {devs}, mesh positions are {list(mesh.positions)}")
            want = list(arr.shape)
            if len(want) == 5:
                if want[2] % self.tp:
                    raise AssertionError(f"{name}: head axis {want[2]} % tp != 0")
                want[2] //= self.tp
                if len({id(t) for t in arr.parts}) != mesh.size:
                    raise AssertionError(f"{name}: two positions share one head shard")
            elif len({id(t) for t in arr.parts}) != mesh.n_devices:
                raise AssertionError(f"{name}: a replicated component is not held once per device")
            for t in arr.parts:
                if list(t.shape) != want:
                    raise AssertionError(f"{name}: shard shape {list(t.shape)} != {want}")
            audited += 1

        for i, a in enumerate(self.pool.state):
            _check(f"pool[{i}]", a)
        if self.spec_enabled:
            _check("draft_k", self._dck)
            _check("draft_v", self._dcv)
        return {
            "tp": self.tp,
            "mesh_devices": mesh.size,
            "distinct_devices": mesh.n_devices,
            "components_audited": audited,
            "kv_pages_per_device": pages,
        }

    def _commit_round(self, mode: str, *, step: bool) -> None:
        """THE per-round commit point: the round stats, the step metric,
        the round metrics and the flight frame. (``stat_steps`` counts the
        plain and the speculative rounds here, at one site, so the two
        paths cannot drift.) ``step`` marks rounds that ran a decode or
        verify dispatch; a chunk-only round records a frame too."""
        t_c0 = time.perf_counter_ns()
        active = self._rb_active if step else self.active
        if step:
            self.stat_steps += 1
            self._metrics.decode_step(self._deployment, active, self.n_slots)
        # the phase array freezes before the round clock stops, so the
        # commit's own cost stays inside the gap it is attributed to
        phase_ns = self._phases.commit(P_COMMIT, t_c0) if self.flight.enabled else ()
        now_ns = time.perf_counter_ns()
        busy = sum(self._rb_busy)
        gap = max(now_ns - self._rb_t0 - busy, 0)
        if self.flight.enabled:
            snap = self.pool.alloc.snapshot()
            prefilling = sum(1 for s in self._slots if s is not None and s.prefilling)
            self.flight.record(
                FlightFrame(
                    self.flight.rounds, now_ns, mode, active, prefilling,
                    len(self._waiting), self._rb_admitted, self._rb_retired,
                    self._rb_blocked, self._rb_tokens, self._rb_accepted,
                    self._rb_proposed, self._rb_depth, tuple(self._rb_busy),
                    gap, snap["free"], snap["live"], snap["prefix"],
                    self._rb_cow, phase_ns, tuple(self._rb_rdb), self._phases.overlap_ns,
                    self._rb_probe, tuple(self._rb_widths), self._rb_promotions,
                )
            )
            if self.spec_enabled:
                tree = self.spec_tree
                self.flight.spec_state = {
                    "tree": ",".join(map(str, tree.branching)) if tree is not None else "",
                    "widths": list(self._rb_widths),
                    "nodes": tree.nodes_for_widths(self._rb_widths) if tree is not None and self._rb_widths else 0,
                    "accept_ewma": round(self._adapt.rate, 4),
                    "depth": self._rb_depth,
                    "probes": self._adapt.probes,
                }
        self._metrics.decode_round(self._deployment, busy / 1e9, gap / 1e9)
        if self.flight.enabled and self.flight.rounds % 64 == 0:
            self._metrics.decode_bubble(self._deployment, self.flight.bubble_fraction())
        self._round_reset(now_ns)

    async def _device_call(self, fn):
        """Run a device dispatch and its readback on the worker thread."""
        return await asyncio.get_running_loop().run_in_executor(self._worker, self._on_worker, fn)

    def warmup(self) -> None:
        """Build (on the card: capture) every (program, shape) key serving
        can need — each chunk bucket, the step, the copy ladder and, with
        speculation, the draft admit per wave bucket (none in feature mode)
        and the greedy round pair — on the worker thread, with all-zero
        block tables, counts, limits and carry masks, so every pool write
        lands in junk page 0 and no carried feature moves (the draft
        cache's junk is overwritten by each admission). compile_counts()
        after this is the baseline."""

        def run():
            z = np.zeros(self.n_slots, np.int32)
            zf = np.zeros(self.n_slots, np.float32)
            self.pool.load_block_tables(self.pool.block_tables())
            for c in self.chunk_buckets:
                self._chunk(np.zeros((self.n_slots, c), np.int32), z, z, zf, z, 0)
            self.pool.warmup()
            self._step(z, z, zf, z, 0)
            if self.spec_enabled:
                for b in () if self.feature_draft else self.admit_buckets:
                    self._draft_admit(np.zeros((b, self.seq_len), np.int32), z, np.zeros(self.n_slots, bool))
                wl0 = None if self.spec_tree is None else np.zeros((self.n_slots, self.spec_k), np.int32)
                self._spec(z, z, zf, z, z, wl0, 0)

        self._worker.submit(self._on_worker, run).result()
        self._warmup_keys = sum(self.compile_counts().values())
        # seldon_tpu_xla_compile_seconds keeps the JAX package's name and
        # bucket label (the slot count): one sample per dispatch key, its
        # capture's seconds (its first eager run off the card)
        for seconds in self.graphs.build_seconds().values():
            self._metrics.compile(self._deployment, self.n_slots, seconds)

    def compile_counts(self) -> dict[str, int]:
        """(program, shape) keys built, per program, under the JAX
        scheduler's names: on the card each is one captured CUDA graph."""
        if self.feature_draft:
            names = ["step_f", "chunk_f", "copy", "draft_feat", "ftree_verify"]
        else:
            names = ["step", "chunk", "copy"]
            if self.spec_enabled:
                names += ["draft_admit"] + (["draft", "verify"] if self.spec_tree is None
                                            else ["draft_tree", "tree_verify"])
        counts = self.graphs.counts()
        return {name: counts.get(name, 0) for name in names}

    def recompiles_since_warmup(self) -> int:
        """Keys built since warmup(): 0 is the serving invariant; -1 when
        warmup never ran."""
        if self._warmup_keys is None:
            return -1
        return sum(self.compile_counts().values()) - self._warmup_keys

    @property
    def active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def queue_depth(self) -> int:
        """Requests waiting un-admitted: the fleet's shed and autoscale
        signal (``/decode/health`` ``queue_depth``)."""
        return len(self._waiting)

    # -------------------------------------------------------------- submit
    async def submit(
        self,
        prompt,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_k: int | None = None,
        spec_k: int | None = None,
        spec_tree: str | None = None,
        cache_prefix: int | None = None,
        prefill_chunk: int | None = None,
        kv_tier: str | None = None,
        on_token: OnToken | None = None,
        _slo_sink: Callable[[bool], None] | None = None,
        _replay_tokens=None,
    ) -> np.ndarray:
        """Generate for one prompt [seq_len]; resolves with the int32
        sequence (prompt echoed, generated ids appended). ``on_token`` is
        called from the loop per generated token: keep it cheap.
        ``spec_k`` tightens (never widens) the deployment's speculation
        depth, 0 opting this request out; ``spec_tree`` ("2,1") tightens a
        tree deployment's per-depth widths (ignored elsewhere).
        ``cache_prefix`` hints how many leading tokens are worth capturing
        into the prefix pool; ``prefill_chunk`` tightens (never widens) the
        deployment's chunk cap. ``kv_tier`` ("off" or "host") narrows which
        KV tiers may promote this request's prefix. ``_slo_sink`` receives
        the request's SLO verdict at retirement (``execute_message``'s
        ``meta.tags.slo``). ``_replay_tokens`` (a fleet migration only):
        the tokens a dead replica already streamed, teacher-forced and not
        streamed again, so the resumed row is the uninterrupted greedy
        row."""
        if self._closed:
            raise APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, "decode scheduler closed")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.shape[0] != self.seq_len:
            raise APIException(
                ErrorCode.ENGINE_INVALID_JSON,
                f"prompt length {prompt.shape[0]} != deployment seq_len "
                f"{self.seq_len} (the generative tier serves one prompt bucket)",
            )
        max_new = int(max_new_tokens) if max_new_tokens is not None else self.max_new_tokens
        max_new = max(1, min(max_new, self.max_new_tokens))
        temp = float(temperature) if temperature is not None else self.default_temperature
        k = int(top_k) if top_k is not None else self.default_top_k
        sk = self.spec_k if spec_k is None else max(0, min(int(spec_k), self.spec_k))
        seq = _Seq(prompt, max_new, temp, k, sk, on_token, asyncio.get_running_loop().create_future())
        self._seq_uid += 1
        seq.uid = self._seq_uid
        if self.spec_tree is not None:
            # per depth min(request, deployment); omitted depths get 0, and
            # a 0 width (min_branch=0) is the documented opt-out
            seq.tree_widths = self.spec_tree.branching
            if spec_tree is not None:
                try:
                    seq.tree_widths = self.spec_tree.tighten(parse_spec_tree(spec_tree, min_branch=0))
                except ValueError as e:
                    raise APIException(ErrorCode.ENGINE_INVALID_JSON, f"meta.tags.spec_tree: {e}") from None
        seq.chunk_cap = self.prefill_chunk
        if prefill_chunk is not None and int(prefill_chunk) >= 1:
            # tighten-only; values < 1 are ignored (0 is the widest setting)
            pc = int(prefill_chunk)
            seq.chunk_cap = min(pc, self.prefill_chunk) if self.prefill_chunk else pc
        if self.prefix_enabled and cache_prefix is not None:
            seq.cache_prefix = max(0, min(int(cache_prefix), self.prefix_ctx))
        if kv_tier is not None:
            kt = str(kv_tier)
            if kt not in ("", "off", "host"):
                raise APIException(ErrorCode.ENGINE_INVALID_JSON, f"meta.tags.kv_tier '{kt}' must be 'off' or 'host'")
            seq.kv_tier = kt
        # goodput: a request submitted under a deadline budget is judged
        # against it at retirement
        d = current_deadline()
        if d is not None:
            seq.slo_deadline = time.perf_counter() + max(d.remaining(), 0.0)
        seq.slo_sink = _slo_sink
        if _replay_tokens:
            seq.replay = tuple(int(t) for t in _replay_tokens)
            seq.emit_base = len(seq.replay)
        if self.queue_timeout_s > 0:
            seq.deadline = seq.t_enqueued + self.queue_timeout_s
        self._waiting.append(seq)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())
        self._wake.set()
        return await seq.future

    # ---------------------------------------------------------------- loop
    def _emit(self, seq: _Seq, tok: int) -> int:
        """Record one generated token: time it (TTFT, ITL and their SLOs),
        stream it. Returns the effective token, which every consumer (the
        finish check, the next round's input) uses: during a migration's
        replay the recorded token overrides the computed one. Runs under the
        emit/SLO phase."""
        with self._phase(P_EMIT_SLO):
            return self._emit_inner(seq, tok)

    def _emit_inner(self, seq: _Seq, tok: int) -> int:
        idx = len(seq.tokens)
        if idx < seq.emit_base:
            # replay: teacher-force the token a dead replica already
            # streamed; no metric, no stream (that emission was the real one)
            tok = int(seq.replay[idx])
            seq.tokens.append(tok)
            seq.t_last_token = time.perf_counter()
            return tok
        now = time.perf_counter()
        seq.tokens.append(tok)
        if len(seq.tokens) == 1:
            ttft = now - seq.t_enqueued
            self._metrics.decode_ttft(self._deployment, ttft)
            if self.prefix_enabled:
                self._metrics.decode_ttft_split(self._deployment, ttft, "warm" if seq.prefix_len > 0 else "cold")
            if self.slo_ttft_s > 0:
                # a breach dumps the flight ring (rate-limited), and the
                # dump's trace id rides the breach counter as an exemplar
                ok = ttft <= self.slo_ttft_s
                seq.slo_ok = seq.slo_ok and ok
                tid = self.flight.note_ttft(ok)
                self._metrics.decode_slo(self._deployment, "ttft", ok, trace_id=tid or None)
            for sp in seq.gen_spans:
                sp.add_event("first_token", {"ttft_ms": round(ttft * 1e3, 3)})
        else:
            itl = now - seq.t_last_token
            self._metrics.decode_inter_token(self._deployment, itl)
            if self.slo_itl_s > 0:
                ok = itl <= self.slo_itl_s
                seq.slo_ok = seq.slo_ok and ok
                tid = self.flight.note_itl(ok)
                self._metrics.decode_slo(self._deployment, "itl", ok, trace_id=tid or None)
        seq.t_last_token = now
        self.stat_tokens += 1
        self._rb_tokens += 1
        # a request that left while its round was in flight streams nothing
        # more: a migrated one resumes elsewhere from what it had streamed
        if seq.on_token is not None and not seq.future.done():
            try:
                seq.on_token(tok, len(seq.tokens) - 1)
            except Exception:  # noqa: BLE001 - a broken consumer must not kill the loop
                log.exception("on_token callback failed")
        return tok

    def _finished(self, seq: _Seq, tok: int) -> bool:
        return tok == self.eos_id or len(seq.tokens) >= seq.max_new

    def _on_pins_reclaimed(self, pin_ids: list[int]) -> None:
        """Allocator callback: pool pressure reclaimed prefix pins; drop the
        index entries that held them. The allocator calls before any
        reclaimed page is reused, so the entries' pages still hold their
        bytes: with the host tier they demote instead of vanishing."""
        if self._host_tier is not None:
            for pin_id in pin_ids:
                entry = self._prefix_index.entries.get(pin_id)
                if entry is not None:
                    self._demote_entry(entry)
        for _ in range(self._prefix_index.remove_by_pins(pin_ids)):
            self._metrics.decode_prefix_evicted(self._deployment)
        self._metrics.decode_kv_reclaimed(self._deployment, len(pin_ids))

    def _maybe_capture(self, seq: _Seq, slot: int, length: int) -> None:
        """Pin ``slot``'s leading prompt pages as a prefix entry unless the
        index already covers prompt[:length]: a refcount bump, no device
        work."""
        length = capture_prefix_len(length, self.prefix_ctx, self.seq_len)
        if length < 1:
            return
        _, depth = self._prefix_index.match(seq.prompt, touch=False)
        if depth >= length:
            return
        pin = self.pool.alloc.capture(slot, length)
        if pin is None:
            return  # the span's pages are not materialized
        _, evicted = self._prefix_index.insert(seq.prompt[:length], pin.pages, pin.pin_id)
        if evicted is not None:
            # the index cap's LRU victim demotes while its pages are intact
            self._demote_entry(evicted)
            self.pool.alloc.release(evicted.pin_id)
            self._metrics.decode_prefix_evicted(self._deployment)
        self.stat_prefix_captures += 1

    @property
    def stat_prefix_evictions(self) -> int:
        return self._prefix_index.evictions if self.prefix_enabled else 0

    def _demote_entry(self, entry) -> None:
        """Demote one evicted prefix entry's pages to the host tier: each
        pool component's columns read back verbatim (an int8 pool's planes
        with their scale and zero point) while the pages are intact. The
        readback waits for the stream: inside an overlap window that is the
        in-flight round, and the wait is counted
        (``stat_tier_demote_overlap``, ``stat_tier_demote_overlap_ns``)."""
        if self._host_tier is None:
            return
        t0 = time.perf_counter_ns()
        with self._on_stream():
            comps = self.pool.read_pages(entry.pages)
        if self._in_overlap:
            self.stat_tier_demote_overlap += 1
            self.stat_tier_demote_overlap_ns += time.perf_counter_ns() - t0
        if self._host_tier.put(entry.tokens, comps):
            self.stat_tier_demotions += 1

    def _promote(self, seq: _Seq, depth: int) -> bool:
        """Consult the host (then store) tier for an entry deeper than the
        device match and promote it into pinned free pages. Runs on both
        admission paths, the serial walk and ``_pipeline_admit`` under an
        in-flight dispatch: the page writes are queued behind the round on
        the scheduler's stream and touch only pages off the free list, and
        ``preseed_pin`` keeps the reservation invariant. Returns whether
        the device index gained a deeper entry."""
        tier = self._host_tier
        include_store = seq.kv_tier != "host"
        if tier.probe(seq.prompt, include_store=include_store) <= depth:
            return False
        got = tier.fetch(seq.prompt, min_depth=depth, include_store=include_store)
        if got is None:
            return False
        tokens, comps, src_tier = got
        t0 = telemetry.now_ns()
        if not self._install_promoted(tokens, comps):
            return False
        self.stat_tier_promotions += 1
        self._rb_promotions += 1
        if self._in_overlap:
            self.stat_tier_promote_overlap += 1
        self._metrics.decode_kv_promotion(self._deployment, src_tier, 1)
        nbytes = int(sum(int(np.asarray(c).nbytes) for c in comps))
        for c in seq.trace_ctxs:
            ms = c.buf.begin("decode.kv_promote", c.span.span_id,
                             {"tier": src_tier, "bytes": nbytes, "overlap": self._in_overlap, **self._mesh_attrs},
                             start_ns=t0)
            ms.add_event("promoted", {"tokens": int(np.asarray(tokens).shape[0])})
            ms.end()
        return True

    def _entry_pages(self, tokens, comps) -> tuple | None:
        """(span, page count, each component's first columns) of a tier or
        spill entry this pool can install: the span clamped down to whole
        pages inside the prefix window, every component's axes and dtype
        checked against the pool's before any page is pinned. None when it
        does not fit."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        layout = self.pool.host_layout()
        if len(comps) != len(layout):
            return None
        length = capture_prefix_len(len(tokens), self.prefix_ctx, self.seq_len)
        length = (length // self.pool.page_size) * self.pool.page_size
        n_pages = self.pool.alloc.pages_for(length)
        if n_pages < 1:
            return None
        cols = []
        for comp, (shape, dtype) in zip(comps, layout):
            full = np.asarray(comp)
            if (full.ndim != len(shape) + 1 or full.shape[0] != shape[0] or full.shape[1] < n_pages
                    or full.shape[2:] != tuple(shape[1:]) or full.dtype != dtype):
                return None
            cols.append(full[:, :n_pages])
        return tokens[:length], n_pages, cols

    def _install_promoted(self, tokens, comps) -> bool:
        """Install one promoted entry's bytes into ``preseed_pin``-pinned
        free pages and the prefix index (the one-entry twin of
        ``preseed_prefix_state``). False degrades to a cold prefill."""
        fit = self._entry_pages(tokens, comps)
        if fit is None:
            return False
        span, n_pages, cols = fit
        _, depth = self._prefix_index.match(span, touch=False)
        if depth >= len(span):
            return False  # a device entry at least as deep landed meanwhile
        pin = self.pool.alloc.preseed_pin(n_pages)
        if pin is None:
            # free-list pressure: a promotion never triggers the reclaim it
            # would feed; the normal reservation path prefills cold instead
            return False
        with self._on_stream():
            self.pool.write_pages(pin.pages, cols)
        self._index_pinned(span, pin)
        return True

    def _index_pinned(self, span, pin) -> None:
        _, evicted = self._prefix_index.insert(span, pin.pages, pin.pin_id)
        if evicted is not None:
            self._demote_entry(evicted)
            self.pool.alloc.release(evicted.pin_id)
            self._metrics.decode_prefix_evicted(self._deployment)

    def preseed_prefix_state(self, payload: dict | None) -> int:
        """Seed the page pool and the prefix index from a spilled payload
        (the JAX package's ``export_prefix_state`` schema: page_size,
        kv_dtype and entries of tokens and per-component page columns), so
        the first request sharing a seeded prefix admits warm. Pages come
        straight off the free list into prefix pins; entries that do not
        fit this pool's geometry are skipped, and an empty free list stops
        the walk. Returns the entries seeded."""
        if not self.prefix_enabled or not payload:
            return 0
        if payload.get("page_size") != self.pool.page_size or payload.get("kv_dtype") != self.pool.kv_dtype:
            log.warning("prefix spill geometry mismatch (page_size/kv_dtype): preseed skipped")
            return 0
        staged: list[tuple[np.ndarray, object]] = []  # (span, pin)
        staged_cols: list[list[np.ndarray]] = []
        for entry in payload.get("entries", ()):
            fit = self._entry_pages(entry.get("tokens"), entry.get("components") or [])
            if fit is None:
                continue
            span, n_pages, cols = fit
            _, depth = self._prefix_index.match(span, touch=False)
            if depth >= len(span) or any(len(t) >= len(span) and np.array_equal(t[: len(span)], span)
                                         for t, _ in staged):
                continue  # already covered (an entry or an earlier staged one)
            pin = self.pool.alloc.preseed_pin(n_pages)
            if pin is None:
                break  # free list exhausted: stop seeding, keep serving
            staged.append((span, pin))
            staged_cols.append(cols)
        if not staged:
            return 0
        # one write per component for the whole payload
        pages = [p for _, pin in staged for p in pin.pages]
        with self._on_stream():
            self.pool.write_pages(pages, [np.concatenate(c, axis=1) for c in zip(*staged_cols)])
        for span, pin in staged:
            self._index_pinned(span, pin)
        self.stat_prefix_preseeded += len(staged)
        self._metrics.router_preseed(self._deployment, len(pages))
        self._kv_gauges()
        return len(staged)

    def _payload(self, entries: list[tuple]) -> dict:
        """A spill payload (``preseed_prefix_state``'s schema) of (tokens,
        components) entries."""
        return {
            "page_size": self.pool.page_size,
            "kv_dtype": self.pool.kv_dtype,
            "entries": [{"tokens": np.asarray(t, np.int32).copy(), "components": [np.asarray(c) for c in comps]}
                        for t, comps in entries],
        }

    def _read_entries(self, entries: list) -> list[tuple]:
        """(tokens, components) of index entries: one gather of just their
        pages' columns on the card and one readback, never the whole pool."""
        pages = [p for e in entries for p in e.pages]
        if not pages:
            return []
        with self._on_stream():
            comps = self.pool.read_pages(pages)
        out, at = [], 0
        for e in entries:
            n = len(e.pages)
            out.append((e.tokens, [c[:, at : at + n] for c in comps]))
            at += n
        return out

    def export_prefix_state(self, top_n: int = 0) -> dict | None:
        """The prefix index's hottest entries with their pages' bytes as
        stored (an int8 pool's planes and scales verbatim), for a new or a
        sibling replica's ``preseed_prefix_state``: ranked by the pages'
        refcounts (live sharers), then hits, then recency; ``top_n`` caps
        them (0: all). None without the prefix cache. Runs on the loop
        between awaits, so the index cannot move under it; the page reads
        queue behind the round in flight."""
        if not self.prefix_enabled:
            return None
        refs = self.pool.alloc.refs
        entries = sorted(self._prefix_index.entries.values(),
                         key=lambda e: (sum(int(refs[p]) for p in e.pages), e.hits, e.last_use), reverse=True)
        if top_n > 0:
            entries = entries[: int(top_n)]
        return self._payload(self._read_entries(entries))

    def prefix_probe_depth(self, prompt) -> int:
        """How deep any local tier (the device index, the host and store
        tiers) could serve ``prompt``: host metadata only, no LRU touch."""
        if not self.prefix_enabled:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        _, depth = self._prefix_index.match(prompt, touch=False)
        if self._host_tier is not None:
            depth = max(depth, self._host_tier.probe(prompt))
        return int(depth)

    def export_prefix_entry(self, prompt) -> dict | None:
        """A one-entry payload of the deepest local entry covering
        ``prompt`` (what a rendezvous home answers a sibling pull with): a
        host or store hit hands over its demoted bytes, a device hit reads
        that entry's pages. None when no tier covers it."""
        if not self.prefix_enabled:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        entry, depth = self._prefix_index.match(prompt, touch=False)
        if self._host_tier is not None and self._host_tier.probe(prompt) > depth:
            got = self._host_tier.fetch(prompt)
            if got is not None:
                tokens, comps, _tier = got
                return self._payload([(tokens, comps)])
        if entry is None or depth < 1:
            return None
        return self._payload(self._read_entries([entry]))

    def _retire(self, slot: int) -> None:
        seq = self._slots[slot]
        self._slots[slot] = None
        self._free.append(slot)
        self.stat_retired += 1
        self._rb_retired += 1
        if seq is None:
            return
        # goodput: the tokens count as delivered within the SLO only when
        # the request's deadline budget held at retirement
        met = True
        if seq.slo_deadline:
            met = time.perf_counter() <= seq.slo_deadline
            seq.slo_ok = seq.slo_ok and met
            tid = self.flight.note_deadline(met)
            self._metrics.decode_slo(self._deployment, "deadline", met, trace_id=tid or None)
        self.flight.note_goodput(len(seq.tokens), met)
        self._metrics.decode_goodput(self._deployment, len(seq.tokens), met)
        if seq.slo_sink is not None:
            seq.slo_sink(seq.slo_ok)
        # automatic capture: the full prompt of every request that gave no
        # cache_prefix hint (a hinted one captured at prefill completion);
        # a request cancelled mid-prefill has incomplete K/V
        if self.prefix_enabled and not seq.prefilling and seq.cache_prefix == 0:
            self._maybe_capture(seq, slot, self.seq_len)
        self.pool.alloc.retire(slot)
        self._kv_gauges()
        _end_spans(seq, tokens=len(seq.tokens))
        if not seq.future.done():
            seq.future.set_result(np.concatenate([seq.prompt, np.asarray(seq.tokens, np.int32)]))

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    async def _run_copies(self, copies: list[tuple[int, int]]) -> None:
        """The round's copy-on-write page copies, before its write dispatch."""
        if copies:
            await self._timed_call(F_COPY, lambda: self.pool.run_copies(copies))
            self._rb_cow += len(copies)
            self._metrics.decode_kv_cow(self._deployment, len(copies))

    def _admit_decide(self, seq: _Seq, slot: int) -> tuple:
        """Longest-prefix match (promoting a deeper host or store entry
        first), the cache_prefix boundary-page reserve and the allocator's
        worst-case reservation (``try_admit`` maps shared pages into the
        slot's block table). Shared by the serial walk and
        ``_pipeline_admit``, where it runs under an in-flight dispatch: the
        reservation is undone whole by ``alloc.retire(slot)``, and is
        conservative (round N's retirements only free pages). Returns
        (entry, reuse, admitted)."""
        entry, reuse = None, 0
        if self.prefix_enabled:
            with self._phase(P_PREFIX_MATCH):
                entry, depth = self._prefix_index.match(seq.prompt)
                # a promotion installs a cache entry (monotone), so a
                # decision rolled back later needs no undo of it
                if self._host_tier is not None and seq.kv_tier != "off" and self._promote(seq, depth):
                    entry, depth = self._prefix_index.match(seq.prompt)
            reuse = usable_prefix_len(depth, self.seq_len)
            if reuse <= 0:
                entry = None
        # a hinted capture whose last page reaches past the prompt will be
        # copy-on-written by this slot's own generation: reserve for it
        extra = 0
        if self.prefix_enabled and seq.cache_prefix > 0:
            alloc = self.pool.alloc
            extra = 1 if alloc.pages_for(seq.cache_prefix) * alloc.page_size > self.seq_len else 0
        with self._phase(P_ALLOC):
            admitted = self.pool.alloc.try_admit(slot, entry.pages if entry is not None else (), reuse, extra)
        return entry, reuse, admitted

    def _install_admit(self, seq: _Seq, slot: int, entry, reuse: int, t0: int) -> None:
        """Install an admission decision into the live slot table (the
        pipelined loop defers this to ``_apply_pending``); the caller owns
        the queue and free-list bookkeeping."""
        seq.slot = slot
        seq.prefilling = True
        self._slots[slot] = seq
        self.stat_admitted += 1
        self._rb_admitted += 1
        if self.feature_draft:
            # the head's window opens at the computed suffix: the reused span
            # (a device match or a promoted tier entry) has no draft K/V
            self._draft_start[slot] = reuse
        shared_pages = self.pool.alloc.pages_for(reuse) if reuse else 0
        if self.prefix_enabled:
            if entry is not None:
                self.pool.alloc.touch(entry.pin_id)
                self.stat_prefix_hits += 1
                self.stat_prefix_tokens_saved += reuse
                self._metrics.decode_prefix(self._deployment, True, reuse)
                self._metrics.decode_kv_shared(self._deployment, shared_pages)
            else:
                self.stat_prefix_misses += 1
                self._metrics.decode_prefix(self._deployment, False, 0)
        seq.prefill_pos = reuse
        seq.prefix_len = reuse
        for c in seq.trace_ctxs:
            ms = c.buf.begin(
                "decode.prefix_match" if self.prefix_enabled else "decode.admit",
                c.span.span_id,
                {"slot": slot, "hit": reuse > 0, **self._mesh_attrs},
                start_ns=t0,
            )
            ms.add_event("reuse", {"tokens": reuse})
            ms.add_event(
                "kv_alloc",
                {
                    "shared_pages": shared_pages,
                    "reserved_pages": int(self.pool.alloc._reserved[slot]),
                    "free_pages": self.pool.alloc.free_pages,
                },
            )
            ms.end()
        self.stat_peak_active = max(self.stat_peak_active, self.active)

    def _admit(self) -> None:
        """Move waiting sequences into free slots, FIFO: host work only
        (slot assignment, prefix match, page reservation). The head waits
        when the pool cannot guarantee its pages. On the pipelined loop this
        is the serial tail of admission: the flight's decisions were
        installed before the last round committed, and what still waits
        (arrivals during the flight, heads the pre-retire pool deferred)
        admits here against the post-retire pool, so each round admits
        what the serial loop would."""
        while self._waiting and self._free:
            seq = self._waiting[0]
            if seq.future.cancelled():
                self._waiting.popleft()
                continue
            t0 = telemetry.now_ns()
            slot = self._free[-1]
            entry, reuse, admitted = self._admit_decide(seq, slot)
            if not admitted:
                self.stat_admit_blocked_rounds += 1
                self._rb_blocked = "pages"
                break
            self._waiting.popleft()
            self._free.pop()
            self._install_admit(seq, slot, entry, reuse, t0)
        if not self._pipeline_take_admit_sweep():
            # the gauges and the expiry sweep, unless the last overlap
            # window ran them under the in-flight dispatch
            self._kv_gauges()
            self._expire_waiting()
        if self._waiting and not self._free and not self._rb_blocked:
            # queued behind fully occupied slots (the page cause is set
            # where try_admit refused)
            self._rb_blocked = "slots"

    def _expire_waiting(self) -> None:
        """Fail waiting requests past the queue deadline (REQUEST_TIMEOUT),
        from the serial walk or under the flight (``_pipeline_sundries``).
        A waiter the same window already decided is admitted, not waiting:
        the serial walk pops admitted requests before the sweep sees them,
        and the pipelined one must match."""
        if not self._waiting:
            return
        decided = {p.seq.uid for p in self._pending_admits}
        now = time.perf_counter()
        for seq in [s for s in self._waiting if s.deadline and s.deadline < now and s.uid not in decided]:
            self._waiting.remove(seq)
            if not seq.future.done():
                seq.future.set_exception(
                    APIException(ErrorCode.REQUEST_TIMEOUT, "request timed out waiting for a decode slot")
                )

    # ------------------------------------------------- pipelined round state
    def _pipeline_on(self) -> bool:
        """Whether this round may run pipelined: the ENGINE_DECODE_PIPELINE
        switch (read at build into ``pipeline_enabled``) and not sync
        timing, whose per-dispatch device walls need the serial loop."""
        return self.pipeline_enabled and not self._sync_timing

    def _overlap_window(self) -> None:
        """Round N+1's host phases, run on the loop while round N's dispatch
        is in flight (between its enqueue and the wait for its readback).
        Each stage is gated on its own measured cost (``_PipelineGate``).
        Phase timers count into the frame's ``overlap_ns`` here (the
        PhaseTimer's overlap mode): this wall lies inside the dispatch's
        busy window, so it must not land in the round's phase split."""
        self._phases.begin_overlap()
        self._in_overlap = True
        try:
            if self._waiting and self._free and self._gate.allow("admit"):
                g0 = time.perf_counter_ns()
                with self._phase(P_ADMIT):
                    self._pipeline_admit()
                self._gate.note("admit", time.perf_counter_ns() - g0)
            if ((self._pending_admits or any(s is not None and s.prefilling for s in self._slots))
                    and self._gate.allow("build")):
                g0 = time.perf_counter_ns()
                with self._phase(P_ALLOC):
                    self._pipeline_plan_chunk()
                self._gate.note("build", time.perf_counter_ns() - g0)
            # the per-round admission sundries ride every window, ungated
            self._pipeline_sundries()
        finally:
            self._in_overlap = False
            self._phases.end_overlap()
            self.stat_pipelined_rounds += 1

    def _pipeline_admit(self) -> None:
        """Round N+1's admission decisions under round N's dispatch, into
        the shadow pending list; ``_apply_pending`` installs them after the
        readback walks. Slots come from the current free list (never a
        predicted retirement) and reservations are made against the
        pre-retire pool, so a decision holds however round N retires. A
        head the pool cannot guarantee yet defers to the serial ``_admit``
        after the reconcile (``stat_pipeline_deferred``)."""
        pending = self._pending_admits
        taken = {p.slot for p in pending}
        queued = {p.seq.uid for p in pending}
        avail = [s for s in self._free if s not in taken]
        for seq in self._waiting:
            if seq.uid in queued:
                continue
            if seq.future.cancelled():
                continue  # the serial walk owns queue cleanup: this pass only reads the queue
            if not avail:
                break
            slot = avail[-1]
            t0 = telemetry.now_ns()
            entry, reuse, admitted = self._admit_decide(seq, slot)
            if not admitted:
                # FIFO: the head defers, everyone behind waits with it
                self.stat_pipeline_deferred += 1
                break
            avail.pop()
            pending.append(_PendingAdmit(seq, slot, entry, reuse, t0))

    def _pipeline_sundries(self) -> None:
        """The serial walk's per-round sundries under the flight: the
        queue-expiry sweep and the pool gauges. Both touch only waiters
        and metrics; the next serial walk skips them once
        (``_pipeline_take_admit_sweep``)."""
        with self._phase(P_ADMIT):
            self._expire_waiting()
            self._kv_gauges()
        self._pending_admit_sweep = True

    def _pipeline_take_admit_sweep(self) -> bool:
        """One-shot: whether the last overlap window ran the admission
        sundries for this round (a serial round runs them itself)."""
        swept = self._pending_admit_sweep
        self._pending_admit_sweep = False
        return swept

    def _pipeline_plan_chunk(self) -> None:
        """Round N+1's chunk-round input arrays, built against the shadow
        state: the prefilling slots' next chunk and the pending admissions'
        first. Array building only: page residency (prepare_write, CoW)
        stays in the serial chunk round, because a copy cannot be rolled
        back. The plan carries its rows' key (slot, uid, position, count);
        ``_pipeline_take_chunk_plan`` hands it out only while the live rows
        still match, so a cancellation, an extra admission or a slot's new
        tenant in between discards it."""
        rows: list[tuple[int, int, int, int, _Seq]] = []
        for i, seq in enumerate(self._slots):
            if seq is None or not seq.prefilling or seq.future.cancelled():
                continue
            rem = self.seq_len - seq.prefill_pos
            c = min(rem, seq.chunk_cap or rem)
            if c > 0:
                rows.append((i, seq.uid, seq.prefill_pos, c, seq))
        for p in self._pending_admits:
            if p.seq.future.cancelled():
                continue
            rem = self.seq_len - p.reuse
            c = min(rem, p.seq.chunk_cap or rem)
            if c > 0:
                rows.append((p.slot, p.seq.uid, p.reuse, c, p.seq))
        if not rows:
            self._pending_chunk_plan = None
            return
        rows.sort(key=lambda r: r[0])
        self._pending_chunk_plan = (tuple(r[:4] for r in rows),) + self._chunk_input_arrays(rows)

    def _pipeline_take_chunk_plan(self, key: tuple):
        """The window's chunk plan if the live rows still match its key,
        else None (a stale plan is normal: the serial build runs). One-shot
        either way."""
        plan = self._pending_chunk_plan
        self._pending_chunk_plan = None
        if plan is not None and plan[0] == key:
            self.stat_pipeline_plans_used += 1
            return plan
        return None

    def _apply_pending(self) -> None:
        """The reconcile of the shadow admissions: install the flight's
        decisions into the live slot table, after the readback walks (which
        must see the dispatch-time slot table) and before ``_commit_round``
        (they belong to this round's frame, as the serial walk's do). A
        decision whose caller left during the flight (its future settled)
        rolls back: ``alloc.retire`` releases its reservation."""
        if not self._pending_admits:
            return
        while self._pending_admits:
            p = self._pending_admits.pop(0)
            if p.seq.future.done():
                self.pool.alloc.retire(p.slot)
                self.stat_pipeline_rollbacks += 1
                with contextlib.suppress(ValueError):  # expiry skips decided admits
                    self._waiting.remove(p.seq)
                continue
            entry, reuse = p.entry, p.reuse
            if self.prefix_enabled and reuse < self.seq_len - 1:
                # the decision matched an index older than this round's
                # captures (a retirement in the walk can capture the very
                # prompt a decided sharer carries, which the serial walk,
                # admitting after the walks, would see): re-match and
                # upgrade to the warm mapping
                with self._phase(P_PREFIX_MATCH):
                    _, depth = self._prefix_index.match(p.seq.prompt, touch=False)
                if usable_prefix_len(depth, self.seq_len) > reuse:
                    self.pool.alloc.retire(p.slot)  # undo the shallow mapping
                    entry, reuse, ok = self._admit_decide(p.seq, p.slot)
                    if not ok:
                        # a deeper reuse on the post-retire pool needs fewer
                        # pages, so this is defensive: the head stays queued
                        self.stat_pipeline_deferred += 1
                        continue
            with contextlib.suppress(ValueError):
                self._waiting.remove(p.seq)
            self._free.remove(p.slot)
            self._install_admit(p.seq, p.slot, entry, reuse, p.t0)
            self.stat_pipeline_admits += 1
        self._kv_gauges()

    def _chunk_input_arrays(self, rows: list) -> tuple:
        """(bucket, ids, pos, counts, temps, topks) of a chunk round from
        (slot, uid, prefill_pos, count, seq) rows, for the serial chunk
        round and the window's plan alike."""
        bucket = next(b for b in self.chunk_buckets if b >= max(r[3] for r in rows))
        ids = np.zeros((self.n_slots, bucket), np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        counts = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        topks = np.zeros(self.n_slots, np.int32)
        for slot, _uid, pp, c, seq in rows:
            ids[slot, :c] = seq.prompt[pp : pp + c]
            pos[slot] = pp
            counts[slot] = c
            temps[slot] = seq.temperature
            topks[slot] = seq.top_k
        return bucket, ids, pos, counts, temps, topks

    def _draft_admit_arrays(self, slots: list[int]) -> tuple:
        """(ids [bucket, seq_len], row_for_slot, valid_slot) of a draft
        admit wave over ``slots``."""
        bucket = next(b for b in self.admit_buckets if b >= len(slots))
        ids = np.zeros((bucket, self.seq_len), np.int32)
        row_for_slot = np.zeros(self.n_slots, np.int32)
        valid_slot = np.zeros(self.n_slots, bool)
        for r, i in enumerate(slots):
            ids[r] = self._slots[i].prompt
            row_for_slot[i] = r
            valid_slot[i] = True
        return ids, row_for_slot, valid_slot

    async def _chunk_round(self) -> None:
        """One prefill chunk round: every prefilling slot consumes up to its
        chunk cap of prompt tokens in one dispatch; slots whose prompt
        completes emit their first token and start generating."""
        with self._phase(P_ALLOC):
            rows = []
            for i, seq in enumerate(self._slots):
                if seq is None or not seq.prefilling:
                    continue
                if seq.future.cancelled():
                    self._retire(i)
                    continue
                rem = self.seq_len - seq.prefill_pos
                rows.append((i, seq.uid, seq.prefill_pos, min(rem, seq.chunk_cap or rem), seq))
            if not rows:
                return
            # the window may have built this round's arrays under the last
            # round's dispatch: valid only while the live rows match its key
            plan = self._pipeline_take_chunk_plan(tuple(r[:4] for r in rows))
            if plan is not None:
                _, bucket, ids, pos, counts, temps, topks = plan
            else:
                bucket, ids, pos, counts, temps, topks = self._chunk_input_arrays(rows)
            copies: list[tuple[int, int]] = []
            for i, _, pp, c, _ in rows:
                # allocate fresh pages, copy-on-write a shared boundary page
                # (always serial: a copy cannot be rolled back)
                copies += self.pool.alloc.prepare_write(i, pp, c)
        await self._run_copies(copies)
        with self._phase(P_ALLOC):
            bt = self.pool.block_tables()
        tick = self._next_tick()
        # the slots whose prompt completes this round also prefill the
        # draft's cache with their full prompt, in the same worker call
        # (feature mode: the head's chunk prefill rode the chunk program)
        finishing = [i for i, _, pp, c, _ in rows if pp + c >= self.seq_len]
        admit = (self._draft_admit_arrays(finishing)
                 if self.spec_enabled and not self.feature_draft and finishing else None)

        def run():
            self.pool.load_block_tables(bt)
            toks = self._chunk(ids, pos, counts, temps, topks, tick)
            if admit is not None:
                td = time.perf_counter_ns()
                self._draft_admit(*admit)
                self._draft_done(td, late=True)
            return toks

        t0 = telemetry.now_ns()
        toks = await self._timed_call(F_CHUNK, run)
        t1 = telemetry.now_ns()
        self.stat_chunk_dispatches += 1
        with self._phase(P_SCATTER):
            done = []
            for i, _, _, c, seq in rows:
                seq.prefill_pos += c
                for ctx in seq.trace_ctxs:
                    ctx.buf.begin(
                        "decode.prefill_chunk",
                        ctx.span.span_id,
                        {"slot": i, "chunk": seq.chunk_idx, "tokens": c, "bucket": bucket, "reused": seq.prefix_len},
                        start_ns=t0,
                    ).end(t1)
                seq.chunk_idx += 1
                if seq.prefill_pos >= self.seq_len:
                    done.append((i, seq))
            for i, seq in done:
                seq.prefilling = False
                seq.pos = self.seq_len
                if self.prefix_enabled and seq.cache_prefix > 0:
                    # hinted capture: the span's pages are pinned from now on
                    self._maybe_capture(seq, i, seq.cache_prefix)
                for ctx in seq.trace_ctxs:
                    seq.gen_spans.append(ctx.buf.begin("decode.generate", ctx.span.span_id,
                                                       {"slot": i, **self._mesh_attrs}, start_ns=t1))
                tok = self._emit(seq, int(toks[i]))
                if self._finished(seq, tok):
                    self._retire(i)

    def _spec_limits(self) -> tuple[np.ndarray | None, np.ndarray | None]:
        """This round's per-slot accept limits [n] (and, on tree
        deployments, per-depth width limits [n, depth]) from the
        controller's effective depth and tuned widths, each request's
        tighten and its remaining budget; (None, None) without speculation.
        A slot one token from its budget rides with limit 0."""
        if not self.spec_enabled:
            return None, None
        depth, tuned, probe = self._adapt.decide()
        self._rb_depth = int(depth)
        self._rb_probe = bool(probe)
        if self.spec_tree is not None:
            self._rb_widths = tuned if tuned is not None else self.spec_tree.branching
        limits = np.zeros(self.n_slots, np.int32)
        for i, seq in enumerate(self._slots):
            if seq is not None and not seq.prefilling:
                # a round emits accepted + 1 tokens
                limits[i] = max(0, min(seq.spec_k, depth, seq.max_new - len(seq.tokens) - 1))
        if self.spec_tree is None:
            return limits, None
        wlimits = np.zeros((self.n_slots, self.spec_tree.depth), np.int32)
        for i, seq in enumerate(self._slots):
            if seq is None or seq.prefilling or limits[i] <= 0:
                continue
            w = seq.tree_widths
            if tuned is not None:
                w = tuple(min(a, b) for a, b in zip(w, tuned))
            for d in range(min(int(limits[i]), len(w))):
                if w[d] <= 0:
                    break
                wlimits[i, d] = w[d]
            # the depth the walk can reach: a zeroed width must not count
            # as an acceptance opportunity
            limits[i] = int((wlimits[i] > 0).sum())
        return limits, wlimits

    async def _step_round(self) -> str | None:
        """One decode round for every generating slot: a speculative round
        pair when any slot may speculate, else the plain step. Returns the
        round's mode ("plain", "chain" or "tree"), None when no slot was
        generating."""
        with self._phase(P_SAMPLING):
            toks = np.zeros(self.n_slots, np.int32)
            pos = np.zeros(self.n_slots, np.int32)
            temps = np.zeros(self.n_slots, np.float32)
            topks = np.zeros(self.n_slots, np.int32)
            gen = []
            # the generating slots: the feature programs' carry mask (a slot
            # riding the dispatch with junk must keep its carried feature)
            fmask = np.zeros(self.n_slots, bool)
            for i, seq in enumerate(self._slots):
                if seq is None:
                    continue
                if seq.future.cancelled():
                    # the client vanished (a stream closed): free the slot
                    self._retire(i)
                    continue
                if seq.prefilling:
                    # ride the step like a free slot, its junk write parked
                    # at its own prefill cursor, which the next chunk
                    # overwrites
                    pos[i] = seq.prefill_pos
                    continue
                toks[i] = seq.tokens[-1]
                pos[i] = seq.pos
                temps[i] = seq.temperature
                topks[i] = seq.top_k
                gen.append(i)
                fmask[i] = True
        if not gen:
            return None
        limits, wlimits = self._spec_limits()
        spec_round = limits is not None and bool(limits.any())
        if not spec_round:
            # a probe that fell to a plain round is no exploration
            self._rb_probe = False
            self._rb_widths = ()
        # page residency for the round's writes: one token per generating
        # slot on the plain step, the whole [k+1]-wide block on a
        # speculative round (prefilling slots' junk parks in pages they own
        # or in the junk page)
        width = self.spec_k + 1 if spec_round else 1
        with self._phase(P_ALLOC):
            copies: list[tuple[int, int]] = []
            for i in gen:
                copies += self.pool.alloc.prepare_write(i, self._slots[i].pos, width)
        await self._run_copies(copies)
        pipelined = self._pipeline_on()
        with self._phase(P_ALLOC):
            bt = self.pool.block_tables()
            if not pipelined:
                # the pipelined loop refreshes the gauges in every window
                # (_pipeline_sundries), at most one round stale
                self._kv_gauges()
        tick = self._next_tick()
        if spec_round:

            def spec():
                self.pool.load_block_tables(bt)
                return self._spec(toks, pos, temps, topks, limits, wlimits, tick, fmask)

            t0 = telemetry.now_ns()
            if pipelined:
                out_t, acc = await self._spec_round_pipelined(bt, toks, pos, temps, limits, wlimits, fmask, spec)
            else:
                out_t, acc = await self._timed_call(F_VERIFY, spec)
                self._rb_active = self.active  # occupancy at dispatch
            self._consume_spec(out_t, acc, limits, wlimits, t0, telemetry.now_ns())
            mode = "chain" if self.spec_tree is None else "tree"
        else:
            if pipelined:
                nxt = await self._step_round_pipelined(bt, toks, pos, temps, topks, tick, fmask)
            else:

                def step():
                    self.pool.load_block_tables(bt)
                    return self._step(toks, pos, temps, topks, tick, fmask)

                nxt = await self._timed_call(F_STEP, step)
                self._rb_active = self.active  # occupancy at dispatch
            with self._phase(P_SAMPLING):
                for i in gen:
                    seq = self._slots[i]
                    seq.pos += 1
                    tok = self._emit(seq, int(nxt[i]))
                    if self._finished(seq, tok):
                        self._retire(i)
            mode = "plain"
        # the flight's admission decisions join this round, after its walks
        with self._phase(P_ADMIT):
            self._apply_pending()
        return mode

    async def _step_round_pipelined(self, bt, toks, pos, temps, topks, tick, fmask) -> np.ndarray:
        """The pipelined plain round: queue the block tables, the step and
        its readback from the loop's thread, run round N+1's host phases
        (``_overlap_window``), then wait for the readback. The step's busy
        column spans enqueue to readback (the window inside it is the
        frame's overlap_ns); its rdb column is the wait after the window."""
        t0 = time.perf_counter_ns()
        # every host array the upload reads is a copy the window cannot
        # touch: ``bt`` is ``pool.block_tables()``'s copy (the window's
        # try_admit edits the allocator's own tables), and each static
        # buffer stages its value in pinned memory it guards with an event
        with self._on_stream(), torch.inference_mode():
            self.pool.load_block_tables(bt)
            host, done = self._readback_async(self._step_enqueue(toks, pos, temps, topks, tick, fmask))
        self._rb_active = self.active  # occupancy at dispatch
        self._overlap_window()
        t2 = time.perf_counter_ns()
        nxt = await self._await_readback(host, done)
        t3 = time.perf_counter_ns()
        self._rb_busy[F_STEP] += t3 - t0
        self._rb_rdb[F_STEP] += t3 - t2
        return nxt

    async def _spec_round_pipelined(self, bt, toks, pos, temps, limits, wlimits, fmask, spec) -> tuple:
        """The pipelined speculative round: the greedy pair's replays and
        its readback queued from the loop's thread, the window, then the
        wait. A pair with a sampled slot runs eagerly (hundreds of
        launches, which would hold the loop for the whole round): it goes
        to the worker thread unawaited and the window runs on the loop
        meanwhile; its draws come from the same (seed, tick, stream)
        generators as the serial loop's (``spec`` is the serial loop's call).
        The draft's enqueue goes to the draft column, the rest of the wall
        to the verify's."""
        t0 = time.perf_counter_ns()
        self._rb_draft_ns = 0
        if (temps > 0).any():
            pair = asyncio.get_running_loop().run_in_executor(self._worker, self._on_worker, spec)
            self._rb_active = self.active  # occupancy at dispatch
            self._overlap_window()
            t2 = time.perf_counter_ns()
            out_t, acc = await pair
        else:
            with self._on_stream(), torch.inference_mode():
                self.pool.load_block_tables(bt)
                lim = limits if wlimits is None else wlimits
                host, done = self._readback_async(self._spec_enqueue(toks, pos, lim, t0, fmask))
            self._rb_active = self.active
            self._overlap_window()
            t2 = time.perf_counter_ns()
            res = await self._await_readback(host, done)
            out_t, acc = res[:, :-1], res[:, -1]
        t3 = time.perf_counter_ns()
        d = self._rb_draft_ns
        self._rb_busy[F_DRAFT] += d
        self._rb_busy[F_VERIFY] += t3 - t0 - d
        self._rb_rdb[F_VERIFY] += t3 - t2
        return out_t, acc

    def _consume_spec(self, out_t: np.ndarray, acc: np.ndarray, limits: np.ndarray, wlimits, t0: int,
                      t1: int) -> None:
        """The readback half of a speculative round: every generating slot
        emits out_t[i, :acc[i] + 1] token by token (EOS and budget retire
        mid-burst, streaming sees each token), then the attribution and the
        controller's update. Limit-0 slots emit exactly their plain-step
        token. Each slot's traces get one ``decode.verify`` span for the
        round (``t0``..``t1``) with its accept count."""
        self.stat_spec_dispatches += 1
        proposed, accepted, emitted = int(limits.sum()), int(acc.sum()), 0
        tree = self.spec_tree
        with self._phase(P_ACCEPT_WALK):
            for i, seq in enumerate(list(self._slots)):
                if seq is None or seq.prefilling:
                    continue
                riding = int(limits[i]) > 0
                attrs = {"slot": i, "proposed": int(limits[i]), **self._mesh_attrs}
                if tree is not None:
                    nodes = int(wlimits[i].sum())
                    attrs["tree"] = ",".join(map(str, tree.branching))
                    attrs["tree_nodes"] = nodes
                    if riding:
                        self._metrics.decode_spec_tree(self._deployment, nodes, int(acc[i]))
                for ctx in seq.trace_ctxs:
                    vs = ctx.buf.begin("decode.verify", ctx.span.span_id, attrs, start_ns=t0)
                    ev = {"accepted": int(acc[i])}
                    if tree is not None:
                        ev["path_depth"] = int(acc[i])
                    vs.add_event("accept", ev)
                    vs.end(t1)
                for j in range(int(acc[i]) + 1):
                    seq.pos += 1
                    tok = self._emit(seq, int(out_t[i, j]))
                    emitted += 1
                    self.stat_spec_ride_emitted += int(riding)
                    if self._finished(seq, tok):
                        self._retire(i)
                        break
        self._rb_accepted = accepted
        self._rb_proposed = proposed
        self._metrics.decode_spec(self._deployment, proposed, accepted, emitted,
                                  mode="chain" if tree is None else "tree")
        self.stat_spec_proposed += proposed
        self.stat_spec_accepted += accepted
        self.stat_spec_emitted += emitted
        self.stat_spec_rides += int((limits > 0).sum())
        paths = [(int(acc[i]), int(limits[i])) for i in range(self.n_slots) if limits[i] > 0]
        self._adapt.update(accepted, proposed, paths=paths)

    async def _run(self) -> None:
        try:
            # the sampling profiler watches the loop's thread (a no-op
            # under ENGINE_DECODE_PROFILE=off)
            profile_mod.watch_decode_thread()
            # the round clock starts with the loop: warmup and idle time
            # before the first request are no decode bubble
            self._round_reset()
            while True:
                with self._phase(P_ADMIT):
                    self._admit()
                if self.active == 0:
                    if not self._waiting:
                        if self._closed:
                            return
                        self._wake.clear()
                        await self._wake.wait()
                        # the idle wait is the queue's silence, not bubble
                        self._round_reset()
                    continue
                if self._faults is not None:
                    # the chaos round hook: a hung round holds its slots on
                    # the loop; an induced OOM fails this round's page write
                    # through the loop's real error path
                    await self._chaos_round()
                await self._chunk_round()
                mode = await self._step_round()
                self._commit_round(mode or "chunk", step=mode is not None)
                # let ingress and admissions interleave with the loop
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - fail every waiter, not just one
            log.exception("decode loop failed")
            # the rounds leading up to the error are the diagnostic: dump
            # them into the span store before the ring rolls on
            self.flight.dump("round_error", force=True)
            for seq in list(self._slots) + list(self._waiting):
                if seq is None:
                    continue
                _end_spans(seq, error=True)
                if not seq.future.done():
                    seq.future.set_exception(APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, str(e)))
            self._slots = [None] * self.n_slots
            self._free = list(range(self.n_slots - 1, -1, -1))
            self._waiting.clear()
            self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Error-path rebuild: a fresh allocator and no index entry pointing
        into the old pool (the host tier's entries are bytes, and stay),
        then the pool and the draft cache rewritten to their initial bytes."""
        self._reset_host_state()
        with self._on_stream():
            self._reset_pool_bytes()

    def _reset_host_state(self) -> None:
        self.pool.reset_allocator()
        if self.feature_draft:
            self._draft_start[:] = 0
        if self.prefix_enabled:
            self._prefix_index.clear()

    def _reset_pool_bytes(self) -> None:
        self.pool.reset_bytes()
        if self.spec_enabled:
            # in place: the captured programs hold the cache's addresses
            with torch.inference_mode():
                self._dck.zero_()
                self._dcv.zero_()
                if self.feature_draft:
                    self._feat.zero_()

    async def close(self) -> None:
        """Drain: take no new work, finish everything in flight and queued,
        then stop the worker thread."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            try:
                await self._task
            except Exception:  # noqa: BLE001 - loop errors already went to the futures
                pass
            self._task = None
        self._worker.shutdown(wait=True)

    async def abort(self, timeout_s: float = 5.0) -> None:
        """Hard stop of an evicted fleet replica, whose loop may hang (a
        round asleep on the loop, or its worker stuck in a readback): cancel
        the loop mid-round and every unsettled future, reset the allocator
        and the index on the loop, so ``alloc.check()`` holds at once, and
        queue the pool's rewrite on the worker behind whatever holds it.
        Holds the event loop no longer than ``close()`` does: the rewrite is
        awaited at most ``timeout_s``, and the worker is shut down without
        waiting for a round that hangs."""
        self._closed = True
        self._wake.set()
        task, self._task = self._task, None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        for seq in list(self._slots) + list(self._waiting):
            if seq is None:
                continue
            _end_spans(seq, error=True)
            if not seq.future.done():
                seq.future.cancel()
        self._slots = [None] * self.n_slots
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._waiting.clear()
        self._reset_host_state()
        rewrite = asyncio.get_running_loop().run_in_executor(self._worker, self._on_worker, self._reset_pool_bytes)
        try:
            await asyncio.wait_for(asyncio.shield(rewrite), timeout=max(0.0, float(timeout_s)))
        except asyncio.TimeoutError:
            log.warning("decode replica %d: pool rewrite still queued behind a stuck worker after %.1fs",
                        self.replica_id, timeout_s)
        self._worker.shutdown(wait=False)

    # ------------------------------------------------- fleet health / chaos
    def health_probe(self) -> dict:
        """The fleet poller's in-process liveness probe (the twin of GET
        /decode/health on a replica of its own). Raises while a chaos drop
        is armed. ``ticks`` counts dispatches: active slots with no tick
        progress between two probes read as a hung loop, which the probe,
        being host-side, outlives."""
        if self._faults is not None and self._faults.health_drop():
            raise TimeoutError(f"chaos: dropped decode health response (replica {self.replica_id})")
        return {
            "replica_id": self.replica_id,
            "queue_depth": len(self._waiting),
            "active": self.active,
            "ticks": int(self._tick),
            "closed": bool(self._closed),
        }

    async def _chaos_round(self) -> None:
        """Apply this round's armed decode fault, at the top of the active
        round before any dispatch."""
        d = self._faults.round_decision()
        if d.action == "hang":
            log.warning("chaos: decode replica %d hanging for %.1fs", self.replica_id, d.delay_s)
            self._metrics.fault_injected(self._deployment, "decode", "hang")
            await asyncio.sleep(d.delay_s)
        elif d.action == "oom":
            log.warning("chaos: decode replica %d arming induced allocator OOM", self.replica_id)
            self._metrics.fault_injected(self._deployment, "decode", "oom")
            self.pool.alloc.chaos_oom_writes = 1

    # ----------------------------------------------------- message adapter
    def request_params_from_meta(self, meta: Meta) -> dict:
        """Per-request overrides from meta.tags: max_new_tokens, temperature,
        top_k, spec_k, spec_tree, cache_prefix, prefill_chunk, kv_tier
        (clamped to the deployment's caps at submit; spec_k, spec_tree,
        prefill_chunk and kv_tier only tighten)."""
        tags = meta.tags or {}
        out: dict = {}
        if "spec_tree" in tags:
            # per-depth widths ("2,1"), parsed against the deployment tree
            # at submit
            out["spec_tree"] = str(tags["spec_tree"])
        if "kv_tier" in tags:
            # "off" | "host": narrows the tiers a promotion may come from
            # (validated at submit)
            out["kv_tier"] = str(tags["kv_tier"])
        for key, cast in (
            ("max_new_tokens", int),
            ("temperature", float),
            ("top_k", int),
            ("spec_k", int),
            ("cache_prefix", int),
            ("prefill_chunk", int),
        ):
            if key in tags:
                try:
                    out[key] = cast(tags[key])
                except (TypeError, ValueError):
                    raise APIException(
                        ErrorCode.ENGINE_INVALID_JSON,
                        f"meta.tags.{key} must be a number, got {tags[key]!r}",
                    ) from None
        return out

    async def execute_message(self, msg: SeldonMessage) -> SeldonMessage:
        """Buffered serving entry: every row of the request is its own
        sequence. The response keeps the fused path's [b, seq + max_new]
        shape: rows that stopped at EOS are right-padded with the EOS id,
        and each row's generated length rides meta.tags.gen_lens."""
        arr = msg.array
        if arr is None:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, "generative predictor needs tensor token ids")
        rows = np.atleast_2d(np.asarray(arr)).astype(np.int32)
        overrides = self.request_params_from_meta(msg.meta)
        # with SLO targets, or a request under a deadline budget, each row's
        # met/breached verdict comes back in meta.tags.slo
        track_slo = bool(self.slo_ttft_s or self.slo_itl_s) or current_deadline() is not None
        slo_flags = [True] * len(rows)

        def sink(i: int):
            return (lambda ok: slo_flags.__setitem__(i, ok)) if track_slo else None

        # settle every row before failing the request, so no sibling row
        # keeps decoding detached
        outs = await asyncio.gather(
            *(self.submit(row, **overrides, _slo_sink=sink(i)) for i, row in enumerate(rows)),
            return_exceptions=True,
        )
        for o in outs:
            if isinstance(o, BaseException):
                raise o
        max_new = max(1, min(int(overrides.get("max_new_tokens", self.max_new_tokens)), self.max_new_tokens))
        full = np.full((len(outs), rows.shape[1] + max_new), self.eos_id if self.eos_id >= 0 else 0, np.int32)
        gen_lens = []
        for i, o in enumerate(outs):
            full[i, : len(o)] = o
            gen_lens.append(int(len(o) - rows.shape[1]))
        tags = {**msg.meta.tags, "gen_lens": gen_lens}
        if track_slo:
            tags["slo"] = ["met" if ok else "breached" for ok in slo_flags]
        meta = Meta(
            puid=msg.meta.puid,
            tags=tags,
            routing=dict(msg.meta.routing),
            request_path=dict(msg.meta.request_path),
        )
        return msg.with_array_meta(full, meta)


def _stalled(fn, stall_s: float):
    """``fn`` followed by the chaos readback stall, on the worker."""

    def run():
        out = fn()
        time.sleep(stall_s)
        return out

    return run


def _end_spans(seq: _Seq, *, tokens: int | None = None, error: bool = False) -> None:
    """Close a sequence's open generate spans (at retirement with its token
    count, or errored when the loop fails or is aborted)."""
    if not seq.gen_spans:
        return
    t = telemetry.now_ns()
    for sp in seq.gen_spans:
        if tokens is not None and sp.attrs is not None:
            sp.attrs["tokens"] = tokens
        sp.error = sp.error or error
        sp.end(t)
    seq.gen_spans = []


def _draft_for(runtime, tpu_spec) -> tuple:
    """(draft params on the runtime's device, spec_k, spec_tree) from the
    deployment's speculation knobs, or (None, 0, "") with a log line in
    the JAX package's warn-and-disable cases: a tree past MAX_TREE_NODES,
    a tree without a draft, a chain past the verify headroom, a draft that
    is not a decoder, and only one of the draft and the depth set. The
    draft takes the target's vocabulary and position table unless its URI
    pins them (a feature head also the target's hidden and FFN widths),
    and stays float32, as the JAX package keeps it."""
    from seldon_core_tpu_torch.models.convert import params_to_torch
    from seldon_core_tpu_torch.models.zoo import _parse_zoo_uri, get_model

    draft_uri = str(tpu_spec.decode_draft_model or "")
    spec_k = int(tpu_spec.decode_spec_k)
    spec_tree = str(tpu_spec.decode_spec_tree or "").strip()
    if spec_tree:
        try:
            if SpecTree.from_text(spec_tree).n_tree > MAX_TREE_NODES:
                raise ValueError(f"flattens past the {MAX_TREE_NODES}-node verify headroom")
        except ValueError as e:
            log.warning("decode_spec_tree=%r unservable (%s) — tree speculation disabled", spec_tree, e)
            spec_tree = ""
    if spec_tree and not draft_uri:
        log.warning("decode_spec_tree=%r needs decode_draft_model — tree speculation disabled", spec_tree)
        spec_tree = ""
    if not spec_tree and spec_k > MAX_TREE_NODES:
        log.warning("decode_spec_k=%s exceeds the %s-token verify headroom — speculation disabled",
                    spec_k, MAX_TREE_NODES)
        spec_k = 0
    if not (draft_uri and (spec_k > 0 or spec_tree)):
        if draft_uri or spec_k > 0:
            log.warning(
                "speculative decoding needs BOTH decode_draft_model and decode_spec_k > 0 (or "
                "decode_spec_tree) — got %r / %s — speculation disabled", draft_uri, spec_k,
            )
        return None, 0, ""
    name, kwargs = _parse_zoo_uri(draft_uri) if draft_uri.startswith("zoo://") else (draft_uri, {})
    dims = decoder_dims(runtime.params)
    kwargs = {"vocab": dims["vocab"], "max_len": dims["max_len"], **kwargs}
    if kwargs.get("features"):
        # a feature head's fuse consumes the target's hidden, and its FFN
        # defaults to the target's width
        kwargs = {"hidden": dims["hidden"], "ffn": int(runtime.params["layers"][0]["mlp_in"]["w"].shape[1]), **kwargs}
    spec = get_model(name, **kwargs)
    if not (isinstance(spec.params, dict) and "tok_emb" in spec.params):
        log.warning("decode_draft_model=%r is not a decoder (models/decoder.py layout) — speculation disabled",
                    draft_uri)
        return None, 0, ""
    return params_to_torch(spec.params, runtime.device), spec_k, spec_tree


def scheduler_for_executor(
    executor, tpu_spec, *, metrics: NullMetrics | None = None, deployment_name: str = "", mesh_devices=None
):
    """A DecodeScheduler for a predictor whose graph is ONE generative model
    node and whose deployment opted in (tpu.decode_slots > 0), or, with
    ``decode_replicas`` or ``decode_autoscale_replicas`` above 1, a
    ``ReplicatedDecodeScheduler`` of them; None otherwise, with a log line
    when an opt-in is ignored. A multi-node graph keeps the fused path: the
    scheduler owns the whole device loop. ``decode_mesh_axes`` decodes
    tensor-parallel over ``mesh_devices`` (the positions the server's
    caller asked for, which may repeat a device), else over the host's
    cards; an unservable request serves on one device with a warning."""
    if tpu_spec.decode_slots <= 0:
        return None
    root = executor.root
    runtime = getattr(root.unit, "runtime", None)
    gen = getattr(runtime, "generative", None)
    if root.children or gen is None:
        log.warning(
            "decode_slots=%s set but the graph is not a single generative "
            "model node — serving the fused whole-batch path",
            tpu_spec.decode_slots,
        )
        return None
    draft_params, spec_k, spec_tree = _draft_for(runtime, tpu_spec)
    mesh_axes = dict(tpu_spec.decode_mesh_axes or {})
    if mesh_axes:
        # the spec-mode precedent: an unservable opt-in degrades to the
        # working config with a log line, instead of failing the boot —
        # here that means single-device dispatch when the mesh request
        # exceeds the positions at hand or the decoder's head/FFN geometry
        # isn't divisible by the tensor-parallel width
        problems = decode_mesh_problems(mesh_axes, runtime.params, draft_params, mesh_devices)
        if problems:
            log.warning(
                "decode_mesh_axes=%s unservable (%s) — tensor-parallel decode disabled, running single-device",
                mesh_axes, "; ".join(problems),
            )
            mesh_axes = {}
    kv_store, kv_store_url = None, str(tpu_spec.decode_kv_store_tier or "")
    if kv_store_url:
        # made once, here: through serving a bad URL disables the store
        # tier alone, with a log line
        try:
            kv_store = make_state_store(kv_store_url)
        except ValueError as e:
            log.warning("decode_kv_store_tier=%r unservable (%s) — store tier disabled, host tier only",
                        kv_store_url, e)
    sched_kwargs = dict(
        seq_len=int(gen["seq"]),
        max_new_tokens=int(gen["max_new_tokens"]),
        n_slots=int(tpu_spec.decode_slots),
        eos_id=int(tpu_spec.decode_eos_id),
        temperature=float(tpu_spec.decode_temperature),
        top_k=int(tpu_spec.decode_top_k),
        seed=int(tpu_spec.decode_seed),
        queue_timeout_s=float(tpu_spec.queue_timeout_ms) / 1000.0,
        draft_params=draft_params,
        spec_k=spec_k,
        spec_tree=spec_tree,
        spec_accept_floor=float(tpu_spec.decode_spec_accept_floor),
        prefix_slots=int(tpu_spec.decode_prefix_slots),
        prefix_ctx=int(tpu_spec.decode_prefix_ctx),
        prefill_chunk=int(tpu_spec.decode_prefill_chunk),
        kv_page_size=int(tpu_spec.decode_kv_page_size),
        kv_pages=int(tpu_spec.decode_kv_pages),
        kv_dtype=str(tpu_spec.decode_kv_dtype),
        kv_host_bytes=int(tpu_spec.decode_kv_host_bytes),
        kv_store=kv_store,
        dtype=runtime.dtype,
        cuda_graphs=runtime.cuda_graphs,
        metrics=metrics,
        slo_ttft_ms=float(tpu_spec.decode_slo_ttft_ms),
        slo_itl_ms=float(tpu_spec.decode_slo_itl_ms),
    )
    replicas = max(1, int(tpu_spec.decode_replicas))
    autoscale_max = int(tpu_spec.decode_autoscale_replicas)
    if max(replicas, autoscale_max) > 1 and mesh_axes:
        # refused at validation; a spec built past it serves one
        # tensor-parallel scheduler, the JAX package's warn-and-disable case
        log.warning("decode_replicas/decode_autoscale_replicas with decode_mesh_axes is not supported yet — "
                    "running one tensor-parallel scheduler")
        replicas, autoscale_max = 1, 0
    if max(replicas, autoscale_max) <= 1:
        return DecodeScheduler(runtime.params, deployment_name=deployment_name, mesh_axes=mesh_axes,
                               devices=mesh_devices if mesh_axes else None, **sched_kwargs)

    # the fleet on one card: every replica decodes with the runtime's own
    # parameter tensors (no copy) and owns its pool, prefix index, graph
    # cache, stream and worker thread
    from seldon_core_tpu_torch.serving.affinity_router import ReplicatedDecodeScheduler
    from seldon_core_tpu_torch.utils.env import PERSISTENCE_STORE

    base_name = deployment_name or "decode"

    def replica(i: int) -> DecodeScheduler:
        return DecodeScheduler(runtime.params, deployment_name=f"{base_name}/r{i}", replica_id=i, **sched_kwargs)

    store_factory = None
    if autoscale_max > replicas:
        # the microservice's unit-state default, so a restart boots from the
        # payload the last scale-up wrote; made at the first spill (a file
        # store makes its directory)
        spill_url = os.environ.get(PERSISTENCE_STORE, "file://./.seldon_state")

        def store_factory():
            try:
                return make_state_store(spill_url)
            except ValueError:
                log.warning("PERSISTENCE_STORE %r unusable — replica spill stays in-process", spill_url)
                return None

    return ReplicatedDecodeScheduler(
        replica,
        replicas,
        policy=str(tpu_spec.decode_router_policy or ""),
        affinity_block=int(tpu_spec.decode_kv_page_size) or 16,
        autoscale_replicas=autoscale_max,
        autoscale_queue_depth=int(tpu_spec.decode_autoscale_queue_depth),
        spill_store_factory=store_factory,
        health_poll_ms=float(tpu_spec.decode_health_poll_ms),
        health_miss_threshold=int(tpu_spec.decode_health_miss_threshold) or 3,
        drain_timeout_ms=float(tpu_spec.decode_drain_timeout_ms) or 5000.0,
        metrics=metrics,
        deployment_name=base_name,
        seed=int(tpu_spec.decode_seed),
    )
