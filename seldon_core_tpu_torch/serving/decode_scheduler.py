"""Continuous-batching decode scheduler for the generative tier.

Port of the serial loop of ``seldon_core_tpu/serving/decode_scheduler.py``
(Orca-style iteration-level scheduling over a vLLM-style paged KV pool):

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
- Tokens stream to the caller as they are chosen (``on_token``), which is
  what the SSE route forwards.

Device work runs off the event loop on one worker thread per scheduler.
Every (program, shape) key is one CUDA graph on the card (``ops/graphs.py``),
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

Not ported yet, and refused by name at deployment build
(``graph/defaulting.py::decode_problems``): the host/store KV tiers,
tensor-parallel decode, the replicated fleet and SLO targets; the feature
draft (``zoo://draft?features=1``) and distilled drafts are refused by the
zoo. The pipelined rounds and the flight recorder have no knob and are
simply absent: the serial loop is the one whose greedy output the
pipelined one must equal. Deadlines wait for the resilience layer; the
queue timeout is honoured.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_device
from seldon_core_tpu_torch.models.decoder import (
    STREAM_DRAFT,
    STREAM_VERIFY,
    decoder_dims,
    draft_propose,
    draft_propose_tree,
    draft_tree_commit,
    init_slot_cache,
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
    _tree_tables,
)
from seldon_core_tpu_torch.models.spec_tree import MAX_TREE_NODES, SpecTree, parse_spec_tree
from seldon_core_tpu_torch.ops.graphs import GraphCache
from seldon_core_tpu_torch.serving.kv_pool import PagedKVPool

log = logging.getLogger(__name__)

OnToken = Callable[[int, int], None]  # (token_id, index within the generation)


def _sample(logits, temps: np.ndarray, topks: np.ndarray, seed: int, tick: int) -> torch.Tensor:
    """Eager sampling after a program's logits: the greedy argmax, or draws
    from the (seed, tick) generator when any slot samples."""
    if not (temps > 0).any():
        return torch.argmax(logits, dim=-1).to(torch.int32)
    dev = logits.device
    return sample_tokens(logits, to_device(temps, dev), to_device(topks, dev), sampling_generator(seed, tick, dev))


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
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        sel = new.index_select(1, row_for_slot).to(cache.dtype)  # [L, n_slots, h, s, hd]
        cache[:, :, :, :s] = torch.where(mask, sel, cache[:, :, :, :s])
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


def usable_prefix_len(length: int, seq_len: int) -> int:
    """The longest reusable span of a matched prefix: at most seq_len - 1,
    since the last prompt position's logits give the first generated
    token and must be computed."""
    return max(0, min(int(length), int(seq_len) - 1))


def capture_prefix_len(length: int, prefix_ctx: int, seq_len: int) -> int:
    """The span a slot may capture into the prefix index: the request
    clamped to the prefix window and the prompt. 0: nothing capturable."""
    return max(0, min(int(length), int(prefix_ctx), int(seq_len)))


class _PrefixEntry:
    """One cached prefix: its tokens and a reference to the pool pages that
    hold its K/V (a kv_pool pin id)."""

    __slots__ = ("tokens", "pages", "pin_id", "last_use")

    def __init__(self, tokens: np.ndarray, pages: list[int], pin_id: int):
        self.tokens = np.asarray(tokens, np.int32)
        self.pages = list(pages)
        self.pin_id = pin_id
        self.last_use = 0


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
        return ent, depth

    def insert(self, tokens, pages: list[int], pin_id: int) -> tuple["_PrefixEntry", "_PrefixEntry | None"]:
        """Index a captured prefix; returns (entry, evicted), ``evicted``
        being the LRU entry the cap pushed out (the caller releases its
        pin) or None."""
        evicted = None
        if len(self.entries) >= self.max_entries:
            evicted = min(self.entries.values(), key=lambda e: e.last_use)
            self.remove(evicted)
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

    def remove_by_pins(self, pin_ids) -> None:
        """Pool-pressure reclaim callback: drop the entries whose pins the
        allocator dropped, with one trie rebuild."""
        dropped = [pin_id for pin_id in pin_ids if self.entries.pop(pin_id, None) is not None]
        if dropped:
            self._rebuild()

    def clear(self) -> None:
        self.entries.clear()
        self._root = {}


class _Seq:
    """One in-flight generation request."""

    __slots__ = (
        "prompt", "max_new", "temperature", "top_k", "spec_k", "tree_widths",
        "on_token", "future", "tokens", "pos", "deadline", "prefilling",
        "prefill_pos", "chunk_cap", "cache_prefix",
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
        self.tokens: list[int] = []
        self.pos = 0
        self.deadline = 0.0  # admission deadline (perf_counter; 0: none)
        # incremental prefill: prefill_pos is the next prompt position to
        # compute (it starts past the span reused from the prefix pool)
        self.prefilling = False
        self.prefill_pos = 0
        self.chunk_cap = 0  # per-round prefill token cap (0: the whole suffix)
        self.cache_prefix = 0  # meta.tags.cache_prefix capture hint


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
        dtype: torch.dtype | None = None,
        cuda_graphs: bool = True,
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
        self.eos_id = int(eos_id)
        self.default_temperature = float(temperature)
        self.default_top_k = int(top_k)
        # how long a request may wait un-admitted before REQUEST_TIMEOUT
        self.queue_timeout_s = float(queue_timeout_s)
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
        # the greedy round pair's temperatures and top-k: a round with no
        # generator reads neither
        self._zf = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        self._zi = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.stat_eager_rounds = 0  # sampled round pairs, run eagerly
        if self.spec_enabled:
            self._dck, self._dcv = init_slot_cache(self.draft_params, n_slots, self._cache_ctx, dtype)
            if self.spec_tree is not None:
                # the tree's constant tables go to the device now, never
                # inside a program (a capture refuses an upload)
                _tree_tables(self.spec_tree, dev)
        if self.prefix_enabled:
            self._prefix_index = PrefixIndex(self.prefix_slots)
            self.pool.alloc.on_pins_reclaimed = self._on_pins_reclaimed
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
        # wave buckets of the draft's prompt prefill (one dispatch for the
        # slots whose target prefill completed in a round)
        buckets, b = [], 1
        while b < self.n_slots:
            buckets.append(b)
            b *= 2
        self.admit_buckets = tuple(buckets) + (self.n_slots,)

    # ------------------------------------------------------------ dispatch
    # Each method runs on the worker thread; the round's block tables are
    # already in ``pool.bt_device`` (``pool.load_block_tables``).
    def _step(self, toks, pos, temps, topks, tick) -> np.ndarray:
        n = len(toks)
        params, pool, bt = self.params, self.pool.state, self.pool.bt_device
        entry = self.graphs.entry(("step", n), lambda t, p: _step_logits(params, pool, bt, t, p),
                                  [((n,), torch.int32), ((n,), torch.int32)])
        return entry.run(toks, pos, post=lambda logits: _sample(logits, temps, topks, self._seed, tick)).cpu().numpy()

    def _chunk(self, ids, pos, counts, temps, topks, tick) -> np.ndarray:
        n = len(pos)
        params, pool, bt = self.params, self.pool.state, self.pool.bt_device
        entry = self.graphs.entry(("chunk",) + ids.shape,
                                  lambda i, p, c: _chunk_logits(params, pool, bt, i, p, c),
                                  [(ids.shape, torch.int32), ((n,), torch.int32), ((n,), torch.int32)])
        return entry.run(ids, pos, counts, post=lambda logits: _sample(logits, temps, topks, self._seed, tick)
                         ).cpu().numpy()

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
        inputs: last tokens, positions) and the verify program (static
        input: the per-slot limits, or width limits on a tree), which reads
        the draft's inputs and outputs where they lie."""
        dparams, params, dck, dcv = self.draft_params, self.params, self._dck, self._dcv
        pool, bt, zf, zi, tree, k = self.pool.state, self.pool.bt_device, self._zf, self._zi, self.spec_tree, self.spec_k
        ins = [((n,), torch.int32), ((n,), torch.int32)]
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

    def _spec(self, toks, pos, temps, topks, limits, wlimits, tick) -> tuple[np.ndarray, np.ndarray]:
        """One speculative round pair, draft then widened verify, and its one
        readback: (out_tokens [n, spec_k + 1], n_accepted [n]). Every input
        is uploaded before the draft is queued, and nothing between the two
        programs waits on the card. ``wlimits`` (tree deployments) replaces
        ``limits`` as the verify's per-slot mask. A greedy round replays the
        captured pair; a round with a sampled slot runs it eagerly."""
        lim = limits if wlimits is None else wlimits
        if (temps > 0).any():
            out, acc = self._spec_sampled(toks, pos, temps, topks, lim, tick)
            res = torch.cat([out, acc[:, None]], dim=1)
        else:
            draft, verify = self._spec_entries(len(toks))
            with draft.lock, verify.lock:
                draft.load(toks, pos)
                verify.load(lim)
                draft.replay()
                out, acc = verify.replay()
                res = torch.cat([out, acc[:, None]], dim=1)  # off the static outputs
        res = res.cpu().numpy()
        return res[:, :-1], res[:, -1]

    def _spec_sampled(self, toks, pos, temps, topks, lim, tick) -> tuple:
        """The eager round pair: the draft's draws from stream 1 and the
        acceptance's from stream 2 of the tick's generator."""
        self.stat_eager_rounds += 1
        dev = self.pool.device
        toks_d, pos_d, temps_d, topks_d, lim_d = (to_device(a, dev) for a in (toks, pos, temps, topks, lim))
        toks_d, pos_d, bt_d = toks_d.long(), pos_d.long(), self.pool.bt_device
        g_draft = sampling_generator(self._seed, tick, dev, STREAM_DRAFT)
        g_verify = sampling_generator(self._seed, tick, dev, STREAM_VERIFY)
        tree = self.spec_tree
        if tree is None:
            drafts, dlogits = _fused_draft(self.draft_params, self._dck, self._dcv, toks_d, pos_d, temps_d, topks_d,
                                           g_draft, self.spec_k)
            return _fused_verify(self.params, self.pool.state, bt_d, toks_d, drafts, dlogits, pos_d, lim_d,
                                 temps_d, topks_d, g_verify)
        node_toks, blogits, nk, nv = _fused_draft_tree(self.draft_params, self._dck, self._dcv, toks_d, pos_d,
                                                       temps_d, topks_d, g_draft, tree)
        return _fused_tree_verify(self.params, self.pool.state, bt_d, toks_d, node_toks, blogits, nk, nv,
                                  self._dck, self._dcv, pos_d, lim_d, temps_d, topks_d, g_verify, tree)

    def _on_worker(self, fn):
        with torch.inference_mode():
            return fn()

    async def _device_call(self, fn):
        """Run a device dispatch and its readback on the worker thread."""
        return await asyncio.get_running_loop().run_in_executor(self._worker, self._on_worker, fn)

    def warmup(self) -> None:
        """Build (on the card: capture) every (program, shape) key serving
        can need — each chunk bucket, the step, the copy ladder and, with
        speculation, the draft admit per wave bucket and the greedy round
        pair — on the worker thread, with all-zero block tables, counts and
        limits, so every pool write lands in junk page 0 (the draft cache's
        junk is overwritten by each admission). compile_counts() after this
        is the baseline."""

        def run():
            z = np.zeros(self.n_slots, np.int32)
            zf = np.zeros(self.n_slots, np.float32)
            self.pool.load_block_tables(self.pool.block_tables())
            for c in self.chunk_buckets:
                self._chunk(np.zeros((self.n_slots, c), np.int32), z, z, zf, z, 0)
            self.pool.warmup()
            self._step(z, z, zf, z, 0)
            if self.spec_enabled:
                for b in self.admit_buckets:
                    self._draft_admit(np.zeros((b, self.seq_len), np.int32), z, np.zeros(self.n_slots, bool))
                wl0 = None if self.spec_tree is None else np.zeros((self.n_slots, self.spec_k), np.int32)
                self._spec(z, z, zf, z, z, wl0, 0)

        self._worker.submit(self._on_worker, run).result()
        self._warmup_keys = sum(self.compile_counts().values())

    def compile_counts(self) -> dict[str, int]:
        """(program, shape) keys built, per program, under the JAX
        scheduler's names: on the card each is one captured CUDA graph."""
        names = ["step", "chunk", "copy"]
        if self.spec_enabled:
            names += ["draft_admit"] + (["draft", "verify"] if self.spec_tree is None else ["draft_tree", "tree_verify"])
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
        on_token: OnToken | None = None,
    ) -> np.ndarray:
        """Generate for one prompt [seq_len]; resolves with the int32
        sequence (prompt echoed, generated ids appended). ``on_token`` is
        called from the loop per generated token: keep it cheap.
        ``spec_k`` tightens (never widens) the deployment's speculation
        depth, 0 opting this request out; ``spec_tree`` ("2,1") tightens a
        tree deployment's per-depth widths (ignored elsewhere).
        ``cache_prefix`` hints how many leading tokens are worth capturing
        into the prefix pool; ``prefill_chunk`` tightens (never widens) the
        deployment's chunk cap."""
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
        if self.queue_timeout_s > 0:
            seq.deadline = time.perf_counter() + self.queue_timeout_s
        self._waiting.append(seq)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())
        self._wake.set()
        return await seq.future

    # ---------------------------------------------------------------- loop
    def _emit(self, seq: _Seq, tok: int) -> None:
        seq.tokens.append(tok)
        if seq.on_token is not None:
            try:
                seq.on_token(tok, len(seq.tokens) - 1)
            except Exception:  # noqa: BLE001 - a broken consumer must not kill the loop
                log.exception("on_token callback failed")

    def _finished(self, seq: _Seq, tok: int) -> bool:
        return tok == self.eos_id or len(seq.tokens) >= seq.max_new

    def _on_pins_reclaimed(self, pin_ids: list[int]) -> None:
        """Allocator callback: pool pressure reclaimed prefix pins; drop the
        index entries that held them."""
        self._prefix_index.remove_by_pins(pin_ids)

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
            self.pool.alloc.release(evicted.pin_id)

    def _retire(self, slot: int) -> None:
        seq = self._slots[slot]
        self._slots[slot] = None
        self._free.append(slot)
        self.stat_retired += 1
        if seq is None:
            return
        # automatic capture: the full prompt of every request that gave no
        # cache_prefix hint (a hinted one captured at prefill completion);
        # a request cancelled mid-prefill has incomplete K/V
        if self.prefix_enabled and not seq.prefilling and seq.cache_prefix == 0:
            self._maybe_capture(seq, slot, self.seq_len)
        self.pool.alloc.retire(slot)
        if not seq.future.done():
            seq.future.set_result(np.concatenate([seq.prompt, np.asarray(seq.tokens, np.int32)]))

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    async def _run_copies(self, copies: list[tuple[int, int]]) -> None:
        """The round's copy-on-write page copies, before its write dispatch."""
        if copies:
            await self._device_call(lambda: self.pool.run_copies(copies))

    def _admit_decide(self, seq: _Seq, slot: int) -> tuple:
        """Longest-prefix match, the cache_prefix boundary-page reserve and
        the allocator's worst-case reservation (``try_admit`` maps shared
        pages into the slot's block table). Returns (entry, reuse,
        admitted)."""
        entry, reuse = None, 0
        if self.prefix_enabled:
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
        admitted = self.pool.alloc.try_admit(slot, entry.pages if entry is not None else (), reuse, extra)
        return entry, reuse, admitted

    def _install_admit(self, seq: _Seq, slot: int, entry, reuse: int) -> None:
        seq.prefilling = True
        self._slots[slot] = seq
        self.stat_admitted += 1
        if self.prefix_enabled:
            if entry is not None:
                self.pool.alloc.touch(entry.pin_id)
                self.stat_prefix_hits += 1
                self.stat_prefix_tokens_saved += reuse
            else:
                self.stat_prefix_misses += 1
        seq.prefill_pos = reuse
        self.stat_peak_active = max(self.stat_peak_active, self.active)

    def _admit(self) -> None:
        """Move waiting sequences into free slots, FIFO: host work only
        (slot assignment, prefix match, page reservation). The head waits
        when the pool cannot guarantee its pages."""
        while self._waiting and self._free:
            seq = self._waiting[0]
            if seq.future.cancelled():
                self._waiting.popleft()
                continue
            slot = self._free[-1]
            entry, reuse, admitted = self._admit_decide(seq, slot)
            if not admitted:
                self.stat_admit_blocked_rounds += 1
                break
            self._waiting.popleft()
            self._free.pop()
            self._install_admit(seq, slot, entry, reuse)
        self._expire_waiting()

    def _expire_waiting(self) -> None:
        """Fail waiting requests past the queue deadline (REQUEST_TIMEOUT)."""
        now = time.perf_counter()
        for seq in [s for s in self._waiting if s.deadline and s.deadline < now]:
            self._waiting.remove(seq)
            if not seq.future.done():
                seq.future.set_exception(
                    APIException(ErrorCode.REQUEST_TIMEOUT, "request timed out waiting for a decode slot")
                )

    def _chunk_input_arrays(self, rows: list) -> tuple:
        """(bucket, ids, pos, counts, temps, topks) of a chunk round from
        (slot, prefill_pos, count, seq) rows."""
        bucket = next(b for b in self.chunk_buckets if b >= max(r[2] for r in rows))
        ids = np.zeros((self.n_slots, bucket), np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        counts = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        topks = np.zeros(self.n_slots, np.int32)
        for slot, pp, c, seq in rows:
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
        rows = []
        for i, seq in enumerate(self._slots):
            if seq is None or not seq.prefilling:
                continue
            if seq.future.cancelled():
                self._retire(i)
                continue
            rem = self.seq_len - seq.prefill_pos
            rows.append((i, seq.prefill_pos, min(rem, seq.chunk_cap or rem), seq))
        if not rows:
            return
        bucket, ids, pos, counts, temps, topks = self._chunk_input_arrays(rows)
        copies: list[tuple[int, int]] = []
        for i, pp, c, _ in rows:
            # allocate fresh pages, copy-on-write a shared boundary page
            copies += self.pool.alloc.prepare_write(i, pp, c)
        await self._run_copies(copies)
        bt = self.pool.block_tables()
        tick = self._next_tick()
        # the slots whose prompt completes this round also prefill the
        # draft's cache with their full prompt, in the same worker call
        finishing = [i for i, pp, c, _ in rows if pp + c >= self.seq_len]
        admit = self._draft_admit_arrays(finishing) if self.spec_enabled and finishing else None

        def run():
            self.pool.load_block_tables(bt)
            toks = self._chunk(ids, pos, counts, temps, topks, tick)
            if admit is not None:
                self._draft_admit(*admit)
            return toks

        toks = await self._device_call(run)
        self.stat_chunk_dispatches += 1
        for i, _, c, seq in rows:
            seq.prefill_pos += c
            if seq.prefill_pos < self.seq_len:
                continue
            seq.prefilling = False
            seq.pos = self.seq_len
            if self.prefix_enabled and seq.cache_prefix > 0:
                # hinted capture: the span's pages are pinned from now on
                self._maybe_capture(seq, i, seq.cache_prefix)
            tok = int(toks[i])
            self._emit(seq, tok)
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
        depth, tuned, _ = self._adapt.decide()
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

    async def _step_round(self) -> None:
        """One decode round for every generating slot: a speculative round
        pair when any slot may speculate, else the plain step."""
        toks = np.zeros(self.n_slots, np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        topks = np.zeros(self.n_slots, np.int32)
        gen = []
        for i, seq in enumerate(self._slots):
            if seq is None:
                continue
            if seq.future.cancelled():
                # the client vanished (a stream closed): free the slot
                self._retire(i)
                continue
            if seq.prefilling:
                # ride the step like a free slot, its junk write parked at
                # its own prefill cursor, which the next chunk overwrites
                pos[i] = seq.prefill_pos
                continue
            toks[i] = seq.tokens[-1]
            pos[i] = seq.pos
            temps[i] = seq.temperature
            topks[i] = seq.top_k
            gen.append(i)
        if not gen:
            return
        limits, wlimits = self._spec_limits()
        spec_round = limits is not None and bool(limits.any())
        # page residency for the round's writes: one token per generating
        # slot on the plain step, the whole [k+1]-wide block on a
        # speculative round (prefilling slots' junk parks in pages they own
        # or in the junk page)
        width = self.spec_k + 1 if spec_round else 1
        copies: list[tuple[int, int]] = []
        for i in gen:
            copies += self.pool.alloc.prepare_write(i, self._slots[i].pos, width)
        await self._run_copies(copies)
        bt = self.pool.block_tables()
        tick = self._next_tick()
        if spec_round:

            def spec():
                self.pool.load_block_tables(bt)
                return self._spec(toks, pos, temps, topks, limits, wlimits, tick)

            out_t, acc = await self._device_call(spec)
            self._consume_spec(out_t, acc, limits)
            return

        def step():
            self.pool.load_block_tables(bt)
            return self._step(toks, pos, temps, topks, tick)

        nxt = await self._device_call(step)
        self.stat_steps += 1
        for i in gen:
            seq = self._slots[i]
            seq.pos += 1
            tok = int(nxt[i])
            self._emit(seq, tok)
            if self._finished(seq, tok):
                self._retire(i)

    def _consume_spec(self, out_t: np.ndarray, acc: np.ndarray, limits: np.ndarray) -> None:
        """The readback half of a speculative round: every generating slot
        emits out_t[i, :acc[i] + 1] token by token (EOS and budget retire
        mid-burst, streaming sees each token), then the attribution and the
        controller's update. Limit-0 slots emit exactly their plain-step
        token."""
        self.stat_steps += 1
        self.stat_spec_dispatches += 1
        proposed, accepted, emitted = int(limits.sum()), int(acc.sum()), 0
        for i, seq in enumerate(list(self._slots)):
            if seq is None or seq.prefilling:
                continue
            riding = int(limits[i]) > 0
            for j in range(int(acc[i]) + 1):
                seq.pos += 1
                tok = int(out_t[i, j])
                self._emit(seq, tok)
                emitted += 1
                self.stat_spec_ride_emitted += int(riding)
                if self._finished(seq, tok):
                    self._retire(i)
                    break
        self.stat_spec_proposed += proposed
        self.stat_spec_accepted += accepted
        self.stat_spec_emitted += emitted
        self.stat_spec_rides += int((limits > 0).sum())
        paths = [(int(acc[i]), int(limits[i])) for i in range(self.n_slots) if limits[i] > 0]
        self._adapt.update(accepted, proposed, paths=paths)

    async def _run(self) -> None:
        try:
            while True:
                self._admit()
                if self.active == 0:
                    if not self._waiting:
                        if self._closed:
                            return
                        self._wake.clear()
                        await self._wake.wait()
                    continue
                await self._chunk_round()
                await self._step_round()
                # let ingress and admissions interleave with the loop
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - fail every waiter, not just one
            log.exception("decode loop failed")
            for seq in list(self._slots) + list(self._waiting):
                if seq is not None and not seq.future.done():
                    seq.future.set_exception(APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, str(e)))
            self._slots = [None] * self.n_slots
            self._free = list(range(self.n_slots - 1, -1, -1))
            self._waiting.clear()
            self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Error-path rebuild: a fresh pool and allocator (and draft cache),
        and no index entry pointing into the old one."""
        self.pool.reset()
        if self.spec_enabled:
            # in place: the captured programs hold the cache's addresses
            with torch.inference_mode():
                self._dck.zero_()
                self._dcv.zero_()
        if self.prefix_enabled:
            self._prefix_index.clear()

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

    async def abort(self) -> None:
        """Hard stop: cancel the loop mid-round and every unsettled future,
        then rebuild the pool so the allocator is consistent again."""
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
            if seq is not None and not seq.future.done():
                seq.future.cancel()
        self._slots = [None] * self.n_slots
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._waiting.clear()
        self._worker.submit(self._reset_device_state).result()
        self._worker.shutdown(wait=True)

    # ----------------------------------------------------- message adapter
    def request_params_from_meta(self, meta: Meta) -> dict:
        """Per-request overrides from meta.tags: max_new_tokens, temperature,
        top_k, spec_k, spec_tree, cache_prefix, prefill_chunk (clamped to
        the deployment's caps at submit; spec_k, spec_tree and prefill_chunk
        only tighten)."""
        tags = meta.tags or {}
        out: dict = {}
        if "spec_tree" in tags:
            # per-depth widths ("2,1"), parsed against the deployment tree
            # at submit
            out["spec_tree"] = str(tags["spec_tree"])
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
        # settle every row before failing the request, so no sibling row
        # keeps decoding detached
        outs = await asyncio.gather(*(self.submit(row, **overrides) for row in rows), return_exceptions=True)
        for o in outs:
            if isinstance(o, BaseException):
                raise o
        max_new = max(1, min(int(overrides.get("max_new_tokens", self.max_new_tokens)), self.max_new_tokens))
        full = np.full((len(outs), rows.shape[1] + max_new), self.eos_id if self.eos_id >= 0 else 0, np.int32)
        gen_lens = []
        for i, o in enumerate(outs):
            full[i, : len(o)] = o
            gen_lens.append(int(len(o) - rows.shape[1]))
        meta = Meta(
            puid=msg.meta.puid,
            tags={**msg.meta.tags, "gen_lens": gen_lens},
            routing=dict(msg.meta.routing),
            request_path=dict(msg.meta.request_path),
        )
        return msg.with_array_meta(full, meta)


def _draft_for(runtime, tpu_spec) -> tuple:
    """(draft params on the runtime's device, spec_k, spec_tree) from the
    deployment's speculation knobs, or (None, 0, "") with a log line in
    the JAX package's warn-and-disable cases: a tree past MAX_TREE_NODES,
    a tree without a draft, a chain past the verify headroom, a draft that
    is not a decoder, and only one of the draft and the depth set. The
    draft takes the target's vocabulary and position table unless its URI
    pins them, and stays float32, as the JAX package keeps it."""
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
    spec = get_model(name, **{"vocab": dims["vocab"], "max_len": dims["max_len"], **kwargs})
    if not (isinstance(spec.params, dict) and "tok_emb" in spec.params):
        log.warning("decode_draft_model=%r is not a decoder (models/decoder.py layout) — speculation disabled",
                    draft_uri)
        return None, 0, ""
    return params_to_torch(spec.params, runtime.device), spec_k, spec_tree


def scheduler_for_executor(executor, tpu_spec) -> DecodeScheduler | None:
    """A DecodeScheduler for a predictor whose graph is ONE generative model
    node and whose deployment opted in (tpu.decode_slots > 0); None
    otherwise, with a log line when an opt-in is ignored. A multi-node
    graph keeps the fused path: the scheduler owns the whole device loop."""
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
    return DecodeScheduler(
        runtime.params,
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
        dtype=runtime.dtype,
        cuda_graphs=runtime.cuda_graphs,
    )
