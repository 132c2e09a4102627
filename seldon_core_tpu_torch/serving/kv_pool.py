"""Paged KV memory for the generative tier.

Port of ``seldon_core_tpu/serving/kv_pool.py`` (vLLM-style block-table
paging, Kwon et al., SOSP 2023):

- ONE device-resident page pool ``[L, n_pages, h, page_size, hd]`` that
  live slots and the prefix cache allocate from (``models/decoder.py``
  ``paged_kv_init`` / ``paged_copy`` own the device layout; the paged
  attention steps gather K/V through per-slot block tables);
- a host-side allocator (``PageAllocator``, copied from the JAX package):
  free list, per-page refcounts, copy-on-write on the first divergent
  write into a shared page, and LRU reclaim of prefix pins when the free
  list runs dry;
- block tables carried as a static-shape ``[n_slots, max_pages]`` int32
  array on the host, and as ONE device tensor of that shape
  (``bt_device``) that the decode programs read, written in place from the
  host table before each round (a CUDA graph holds its address);
- reservation-based admission: a sequence admits only when the pool can
  guarantee its worst-case EXCLUSIVE page need, so admission throttles
  instead of deadlocking mid-decode.

Physical page 0 is a reserved junk sink: free slots' block tables are all
zero and masked-off writes land there. Page 0 is never allocated.
``preseed_pin`` takes free pages straight into a prefix pin: the host KV
tier's promotions land there (``serving/kv_host_tier.py``), and so does a
replica's warm boot. ``read_pages`` and ``write_pages`` move whole page
columns of every pool component between the card and the host, bytes
verbatim. ``PageAllocator.chaos_oom_writes`` is the chaos harness's
induced OOM (``engine/faults.py``'s ``oom`` decode fault): the next
``prepare_write`` raises as if the page budget ran out, which exercises the
decode loop's error path without corrupting the accounting.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from seldon_core_tpu_torch.models.decoder import paged_copy, paged_kv_init
from seldon_core_tpu_torch.ops.graphs import GraphCache, StaticBuffer
from seldon_core_tpu_torch.parallel.tp import Placed

log = logging.getLogger(__name__)


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(np.int16) if dtype == torch.bfloat16 else torch.empty(0, dtype=dtype).numpy().dtype


def _as_host_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


class PoolPin:
    """One prefix-cache pin: a refcount held on a page list (plus LRU age).
    The radix index entry that owns it stores the pin_id; eviction drops
    the refs and frees whatever nothing else references."""

    __slots__ = ("pin_id", "pages", "last_use")

    def __init__(self, pin_id: int, pages: list[int]):
        self.pin_id = pin_id
        self.pages = list(pages)
        self.last_use = 0


class PageAllocator:
    """Host-side page accounting. Pure host state — the only device work it
    ever ASKS for is the (src, dst) page-copy list ``prepare_write``
    returns, which the caller batches through the pool's copy ladder
    BEFORE its write dispatch.

    Invariant (what makes admission deadlock-free): at all times
    ``free + reclaimable >= sum(outstanding reservations)``, where
    reclaimable counts pages whose only references are prefix pins.
    ``try_admit`` refuses any admission that would break it; ``_alloc``
    only spends reservation the slot holds."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int, pages_per_slot: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        floor = max(pages_per_slot + 2, n_slots + 1)
        if n_pages < floor:
            raise ValueError(
                f"decode_kv_pages={n_pages} is below the minimal residency "
                f"for n_slots={n_slots} at {pages_per_slot} pages/slot "
                f"(need >= {floor}: junk page + one slot's full context + "
                "one page of slack) — admission would deadlock, erroring "
                "instead"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.refs = np.zeros(n_pages, np.int32)
        self.refs[0] = 1  # page 0: reserved junk sink, never allocated
        self.pin_count = np.zeros(n_pages, np.int32)
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self.block_tables = np.zeros((n_slots, pages_per_slot), np.int32)
        self._mapped = np.zeros(n_slots, np.int32)  # logical pages mapped
        self._reserved = np.zeros(n_slots, np.int64)  # pages still claimable
        self._pins: dict[int, PoolPin] = {}
        self._next_pin = 0
        self._clock = 0
        # called ONCE per reclaim wave with the list of reclaimed pin ids
        # (batched so the owner — the prefix index — rebuilds its trie
        # once, not once per pin, on the hot decode path)
        self.on_pins_reclaimed = None
        # the chaos harness's induced OOM: the next prepare_write raises
        self.chaos_oom_writes = 0
        self.stat_chaos_ooms = 0
        self.stat_pages_shared = 0
        self.stat_cow_copies = 0
        self.stat_reclaimed_pages = 0
        self.stat_pin_reclaims = 0

    # ------------------------------------------------------- introspection
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def prefix_pages(self) -> int:
        """Pages whose only references are prefix pins (reclaimable)."""
        return int(np.sum((self.pin_count > 0) & (self.refs == self.pin_count)))

    @property
    def live_pages(self) -> int:
        """Pages referenced by at least one live slot (shared or not)."""
        return self.n_pages - 1 - self.free_pages - self.prefix_pages

    def reserved_total(self) -> int:
        return int(self._reserved.sum())

    def snapshot(self) -> dict:
        """One host-side read of the pool's occupancy and event counters."""
        return {
            "free": self.free_pages,
            "live": self.live_pages,
            "prefix": self.prefix_pages,
            "reserved": self.reserved_total(),
            "shared_total": self.stat_pages_shared,
            "cow_total": self.stat_cow_copies,
            "pin_reclaims": self.stat_pin_reclaims,
        }

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def slot_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self.block_tables[slot, : int(self._mapped[slot])]]

    def _reclaimable(self, exclude=()) -> int:
        mask = (self.pin_count > 0) & (self.refs == self.pin_count)
        cnt = int(mask.sum())
        for p in set(exclude):
            if mask[p]:
                cnt -= 1
        return cnt

    def check(self) -> None:
        """Internal-consistency audit (tests): every page is exactly one of
        {junk sink, free, referenced}; refs reconcile with block tables +
        pins; no free page is referenced or mapped."""
        refs = np.zeros(self.n_pages, np.int64)
        refs[0] = 1
        for s in range(self.n_slots):
            for p in self.slot_pages(s):
                refs[p] += 1
        pins = np.zeros(self.n_pages, np.int64)
        for pin in self._pins.values():
            for p in pin.pages:
                refs[p] += 1
                pins[p] += 1
        if not np.array_equal(refs, self.refs):
            raise AssertionError("refcounts diverged from block tables + pins")
        if not np.array_equal(pins, self.pin_count):
            raise AssertionError("pin counts diverged from pins")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("double-free: duplicate page in free list")
        if 0 in free:
            raise AssertionError("junk page 0 leaked into the free list")
        for p in free:
            if self.refs[p] != 0:
                raise AssertionError(f"free page {p} still referenced")
        for p in range(1, self.n_pages):
            if self.refs[p] == 0 and p not in free:
                raise AssertionError(f"page {p} leaked (unreferenced, not free)")
        if self.free_pages + self._reclaimable() < self.reserved_total():
            raise AssertionError("reservation invariant broken")

    # ----------------------------------------------------------- admission
    def try_admit(self, slot: int, shared_pages, reuse: int, extra_reserve: int = 0) -> bool:
        """Admit a sequence into ``slot``: map its matched prefix pages
        (refcount bump — the copy-free share) and reserve its worst-case
        exclusive page need. Returns False — mapping nothing — when the
        pool cannot GUARANTEE the reservation; the caller leaves the
        request queued until retirements free pages.

        ``reuse`` is the matched token span; only its fully-covered pages
        are exempt from the reservation (the partial boundary page will be
        copy-on-written at the first divergent write). ``extra_reserve``
        covers CoW the caller knows is coming (a cache_prefix capture hint
        pinning pages mid-generation)."""
        if self._mapped[slot] or self._reserved[slot]:
            raise RuntimeError(f"slot {slot} admitted while still mapped")
        n_map = self.pages_for(reuse) if reuse > 0 else 0
        shared = [int(p) for p in list(shared_pages)[:n_map]]
        if len(shared) < n_map:
            raise ValueError("matched entry holds fewer pages than reuse needs")
        need = self.pages_per_slot - (int(reuse) // self.page_size) + int(extra_reserve)
        avail = self.free_pages + self._reclaimable(exclude=shared)
        if avail - self.reserved_total() < need:
            return False
        for lp, p in enumerate(shared):
            self.block_tables[slot, lp] = p
            self.refs[p] += 1
        self._mapped[slot] = n_map
        self._reserved[slot] = need
        self.stat_pages_shared += n_map
        return True

    # ---------------------------------------------------------- allocation
    def _alloc(self, slot: int) -> int:
        if self._reserved[slot] <= 0:
            raise RuntimeError(
                f"slot {slot} allocating past its reservation — the "
                "no-deadlock invariant would be void"
            )
        if not self._free:
            self._reclaim_until_free()
        p = self._free.pop()
        self.refs[p] = 1
        self._reserved[slot] -= 1
        return p

    def _reclaim_until_free(self) -> None:
        reclaimed: list[int] = []
        while not self._free and self._pins:
            # prefer the LRU pin that actually FREES a page (one whose
            # pages include a refs==1 page): dropping a pin whose pages
            # live readers still map would destroy a prefix entry without
            # relieving any pressure. Fall back to plain LRU when no
            # single pin frees anything (e.g. a page held by two pins
            # needs both dropped — still progress).
            freeing = [
                p for p in self._pins.values()
                if any(self.refs[pg] == 1 for pg in p.pages)
            ]
            pin = min(freeing or self._pins.values(), key=lambda q: q.last_use)
            self._drop_pin(pin, reclaim=True)
            reclaimed.append(pin.pin_id)
        if reclaimed and self.on_pins_reclaimed is not None:
            self.on_pins_reclaimed(reclaimed)
        if not self._free:
            raise RuntimeError(
                "kv page pool exhausted with nothing reclaimable — "
                "reservation invariant broken (bug)"
            )

    def prepare_write(self, slot: int, start: int, count: int) -> list[tuple[int, int]]:
        """Make positions [start, start + count) writable by ``slot``:
        allocate not-yet-mapped logical pages and copy-on-write shared
        ones. Returns the (src, dst) page copies the caller MUST dispatch
        (through the pool's copy ladder) before its write dispatch.
        Positions beyond the slot's virtual length are ignored — the
        device-side write mask junk-redirects them to page 0."""
        ps = self.page_size
        end = min(int(start) + int(count), self.pages_per_slot * ps)
        if count <= 0 or start >= end:
            return []
        if self.chaos_oom_writes > 0:
            self.chaos_oom_writes -= 1
            self.stat_chaos_ooms += 1
            raise RuntimeError(
                "chaos: induced allocator OOM (page budget exhausted by "
                f"fault injection) preparing write for slot {slot}"
            )
        copies: list[tuple[int, int]] = []
        bt = self.block_tables
        for lp in range(int(start) // ps, (end - 1) // ps + 1):
            if lp >= self._mapped[slot]:
                for lpn in range(int(self._mapped[slot]), lp + 1):
                    bt[slot, lpn] = self._alloc(slot)
                self._mapped[slot] = lp + 1
            else:
                p = int(bt[slot, lp])
                if self.refs[p] > 1:
                    fresh = self._alloc(slot)
                    copies.append((p, fresh))
                    bt[slot, lp] = fresh
                    self.refs[p] -= 1
                    self.stat_cow_copies += 1
        return copies

    # ---------------------------------------------------------- retirement
    def retire(self, slot: int) -> None:
        """Return the slot's page references to the pool: pages nothing
        else references go back to the free list; pages pinned as prefix
        entries (or shared with other readers) survive."""
        for lp in range(int(self._mapped[slot])):
            p = int(self.block_tables[slot, lp])
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
        self.block_tables[slot, :] = 0
        self._mapped[slot] = 0
        self._reserved[slot] = 0

    # -------------------------------------------------------- prefix pins
    def capture(self, slot: int, length: int) -> PoolPin | None:
        """Pin the pages covering the slot's leading ``length`` tokens as a
        prefix entry — a refcount bump, NO copy (the old capture dispatch
        is gone). Returns None if the span isn't materialized yet."""
        n = self.pages_for(length)
        if n < 1 or n > self._mapped[slot]:
            return None
        pin = PoolPin(self._next_pin, self.slot_pages(slot)[:n])
        self._next_pin += 1
        self._clock += 1
        pin.last_use = self._clock
        for p in pin.pages:
            self.refs[p] += 1
            self.pin_count[p] += 1
        self._pins[pin.pin_id] = pin
        return pin

    def preseed_pin(self, n: int) -> PoolPin | None:
        """Allocate ``n`` free pages directly into a prefix pin (a promotion
        from the host tier, or a warm boot's preseed). Returns None when
        the free list cannot cover it. The reservation invariant holds
        unchanged: the pages leave the free list but enter the pin-only
        (reclaimable) set, so ``free + reclaimable`` is constant."""
        n = int(n)
        if n < 1 or n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        pin = PoolPin(self._next_pin, pages)
        self._next_pin += 1
        self._clock += 1
        pin.last_use = self._clock
        for p in pages:
            self.refs[p] = 1
            self.pin_count[p] = 1
        self._pins[pin.pin_id] = pin
        return pin

    def touch(self, pin_id: int) -> None:
        pin = self._pins.get(pin_id)
        if pin is not None:
            self._clock += 1
            pin.last_use = self._clock

    def release(self, pin_id: int) -> None:
        """Drop a pin its owner no longer wants (index-cap eviction)."""
        pin = self._pins.get(pin_id)
        if pin is not None:
            self._drop_pin(pin, reclaim=False)

    def _drop_pin(self, pin: PoolPin, reclaim: bool) -> None:
        del self._pins[pin.pin_id]
        freed = 0
        for p in pin.pages:
            self.pin_count[p] -= 1
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed += 1
        if reclaim:
            self.stat_reclaimed_pages += freed
            self.stat_pin_reclaims += 1


class PagedKVPool:
    """Device pool state + host allocator + the copy-on-write copy ladder.

    ``cache_ctx`` is the per-slot virtual context (seq + max_new).
    ``n_pages=0`` sizes the pool to the flat-equivalent capacity (every slot
    can hold its full context with no sharing); smaller explicit budgets
    are where paging pays. ``graphs`` is the scheduler's graph cache: each
    copy bucket is one of its dispatch keys (``copy``), one captured graph
    on the card."""

    def __init__(
        self,
        params,
        *,
        n_slots: int,
        cache_ctx: int,
        page_size: int = 0,
        n_pages: int = 0,
        kv_dtype: str = "",
        dtype=torch.float32,
        graphs: GraphCache | None = None,
    ):
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                f"decode_kv_dtype {kv_dtype!r} unsupported (want '' or 'int8')"
            )
        self.page_size = int(page_size) or 16
        self.pages_per_slot = -(-int(cache_ctx) // self.page_size)
        self.n_pages = int(n_pages) or (n_slots * self.pages_per_slot + 2)
        self.kv_dtype = kv_dtype
        self._params = params
        self._dtype = dtype
        # the lead position's device over a decode mesh: the block tables,
        # index uploads and the host tier's transfers are staged there
        self.device = params["tok_emb"].device
        self.n_slots = int(n_slots)
        self.graphs = graphs if graphs is not None else GraphCache(self.device)
        self.alloc = PageAllocator(
            self.n_pages, self.page_size, self.n_slots, self.pages_per_slot
        )
        # the pool's tensors keep their addresses for the scheduler's life:
        # captured graphs write and read them in place. Over a decode mesh
        # each component is ``Placed`` (parallel/tp.py): a head shard of
        # each payload per position, the int8 planes once per device
        self.state = paged_kv_init(params, self.n_pages, self.page_size, dtype, kv_dtype)
        self._bt = StaticBuffer(self.alloc.block_tables.shape, torch.int32, self.device)
        buckets, b = [], 1
        while b < self.n_slots:
            buckets.append(b)
            b *= 2
        self.copy_buckets = tuple(buckets) + (self.n_slots,)
        self.stat_copy_dispatches = 0

    @property
    def virtual_ctx(self) -> int:
        return self.pages_per_slot * self.page_size

    def block_tables(self) -> np.ndarray:
        """Fresh host copy of the block tables for one round."""
        return self.alloc.block_tables.copy()

    @property
    def bt_device(self) -> torch.Tensor:
        """The device block tables every decode program reads."""
        return self._bt.tensor

    def load_block_tables(self, bt: np.ndarray) -> None:
        """Write a round's host block tables into ``bt_device``, in place,
        ahead of the round's programs on the current stream."""
        self._bt.write(bt)

    def host_layout(self) -> list[tuple[tuple, np.dtype]]:
        """(shape without the page axis, numpy dtype) of each component as
        ``read_pages`` gives it: a bfloat16 component travels as its int16
        bit pattern (numpy has no bfloat16)."""
        return [((a.shape[0], *a.shape[2:]), _host_dtype(a.dtype)) for a in self.state]

    def read_pages(self, pages) -> list[np.ndarray]:
        """Every component's columns at ``pages`` on the host, bytes
        verbatim ([L, len(pages), ...] each; over a decode mesh every
        position's heads gathered into the full page). Queued on the current
        stream and waited for: the caller reads while the pages still hold
        them."""
        pages = np.asarray(pages, np.int64)
        with torch.inference_mode():
            out = []
            for a in self.state:
                if isinstance(a, Placed):
                    a = a.gather(lambda t: t.index_select(1, torch.as_tensor(pages, device=t.device)), 2,
                                 self.device)
                else:
                    a = a.index_select(1, torch.as_tensor(pages, device=self.device))
                out.append(_as_host_bits(a).cpu().numpy())
            return out

    def write_pages(self, pages, comps: list[np.ndarray]) -> None:
        """Write host columns (``read_pages``' layout) into ``pages`` of every
        component, in place on the current stream: a byte move, no
        conversion (over a decode mesh each position takes its heads).
        Nothing here waits for the stream: the bytes go up from pinned
        copies, asynchronously, so a write queued behind an in-flight round
        returns at once."""
        pages = np.asarray(pages, np.int64)
        with torch.inference_mode():
            for a, src in zip(self.state, comps):
                vals = self._upload(src)

                def put(t, i, a=a, vals=vals):
                    v = a.block(i, vals, 2) if isinstance(a, Placed) else vals
                    idx = self._upload(pages, t.device)
                    t.index_copy_(1, idx, v.view(t.dtype) if t.dtype == torch.bfloat16 else v)

                if isinstance(a, Placed):
                    a.each_part(put)
                else:
                    put(a, 0)

    def _upload(self, array: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return t
        # a blocking upload from pageable memory would wait for the stream;
        # the pinned block is kept by the host allocator until its copy ran
        return t.pin_memory().to(device, non_blocking=True)

    def _copy(self, src: np.ndarray, dst: np.ndarray) -> None:
        state = self.state
        entry = self.graphs.entry(("copy", len(src)), lambda s, d: paged_copy(state, s, d),
                                  [(src.shape, torch.int64), (dst.shape, torch.int64)])
        entry.run(src, dst, post=lambda _: None)

    def run_copies(self, copies: list[tuple[int, int]]) -> None:
        """Run the round's copy-on-write page copies through the bucket
        ladder (padding entries copy junk page 0 onto itself)."""
        i = 0
        while i < len(copies):
            batch = copies[i : i + self.copy_buckets[-1]]
            bucket = next(b for b in self.copy_buckets if b >= len(batch))
            src = np.zeros(bucket, np.int64)
            dst = np.zeros(bucket, np.int64)
            for j, (s, d) in enumerate(batch):
                src[j] = s
                dst[j] = d
            self._copy(src, dst)
            self.stat_copy_dispatches += 1
            i += len(batch)

    def warmup(self) -> None:
        """Run every copy bucket once (page-0 self-copies touch no live
        bytes)."""
        for b in self.copy_buckets:
            self._copy(np.zeros(b, np.int64), np.zeros(b, np.int64))

    def reset_allocator(self) -> None:
        """Post-failure recovery, host half: a fresh allocator, its reclaim
        callback kept."""
        on_reclaimed = self.alloc.on_pins_reclaimed
        self.alloc = PageAllocator(
            self.n_pages, self.page_size, self.n_slots, self.pages_per_slot
        )
        self.alloc.on_pins_reclaimed = on_reclaimed

    def reset_bytes(self) -> None:
        """Post-failure recovery, device half: the pool's tensors rewritten
        in place to their initial bytes on the current stream (captured
        graphs keep their addresses)."""
        fresh = paged_kv_init(self._params, self.n_pages, self.page_size, self._dtype, self.kv_dtype)
        with torch.inference_mode():
            for a, f in zip(self.state, fresh):
                a.copy_(f)  # a Placed buffer copies part by part
