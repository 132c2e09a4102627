"""Host-RAM and persistence-store prefix-page tiers: the demand-paged KV
hierarchy below the device pool.

Port of ``seldon_core_tpu/serving/kv_host_tier.py``, unchanged but for its
imports. The device page pool (``serving/kv_pool.py``) is the fast tier.
Prefix entries the device evicts (allocator pin reclaim, the index's LRU
cap) demote here with their bytes exactly as the pool holds them (an int8
pool's quantized planes and its scale and zero point verbatim, so a
promotion is a pure byte move with no quantization round trip), and the
host pool's own LRU spills its coldest entries to the persistence store
(``persistence/state.py``). A device-pool miss at admission consults this
tier (then the store) and promotes the hit back into
``preseed_pin``-pinned free pages. Everything below the device is host
numpy state: no dispatch key changes, and promoted output is bit-identical
to a cold prefill's (the bytes are the bytes).

Store outages degrade (skip the store tier) and never abort: the stores
swallow transport errors, and a corrupt payload drops its index entry with
a warning.
"""

from __future__ import annotations

import hashlib
import logging
import pickle

import numpy as np

from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch.persistence.state import state_key

log = logging.getLogger(__name__)

# store unit-id prefix for demoted entries (rides state_key, so the store
# namespace matches the unit-persistence / spill keys)
STORE_UNIT_PREFIX = "kvtier_"


def tier_store_key(deployment_id: str, tokens) -> str:
    """Per-entry store key: the RAW token bytes digested (not the tokens
    themselves — a store key must stay bounded and collision-free no
    matter the span length)."""
    digest = hashlib.blake2b(
        np.asarray(tokens, np.int32).tobytes(), digest_size=16
    ).hexdigest()
    return state_key(deployment_id or "decode", STORE_UNIT_PREFIX + digest)


class _HostEntry:
    """One demoted prefix span: its token key plus the pool-component
    slices read back from the device pages, verbatim."""

    __slots__ = ("tokens", "components", "nbytes", "last_use", "hits")

    def __init__(self, tokens: np.ndarray, components: list[np.ndarray]):
        self.tokens = np.asarray(tokens, np.int32)
        self.components = components
        self.nbytes = int(sum(int(c.nbytes) for c in components))
        self.last_use = 0
        self.hits = 0


class KVHostTier:
    """Bounded byte-budget host pool of demoted prefix entries, keyed by
    token span, with an LRU spilling the coldest entries to the
    persistence store.

    Single-writer like the prefix index: every call happens on the event
    loop (scheduler admission/eviction paths), so no locking. Lookup is
    longest-entry-that-prefixes-the-prompt — entries are page-aligned
    spans, and causal K/V makes any covering prefix fully reusable (the
    radix index's LCP argument, restated for whole entries)."""

    def __init__(
        self,
        budget_bytes: int,
        *,
        page_size: int,
        kv_dtype: str = "",
        store=None,
        deployment: str = "",
        metrics: NullMetrics | None = None,
    ):
        self.budget_bytes = int(budget_bytes)
        self.page_size = int(page_size)
        self.kv_dtype = str(kv_dtype or "")
        self.store = store
        self.deployment = deployment or "decode"
        self._metrics = metrics or NullMetrics()
        self._entries: dict[tuple, _HostEntry] = {}
        # what this process spilled to the store: key tuple -> (store key,
        # nbytes). Host-side — the store itself is a dumb byte bag, and a
        # store probe must stay O(index), not a network round-trip.
        self._store_index: dict[tuple, tuple[str, int]] = {}
        self.host_bytes = 0
        self.store_bytes = 0
        self._clock = 0
        self.stat_demotions_host = 0
        self.stat_demotions_store = 0
        self.stat_promotions_host = 0
        self.stat_promotions_store = 0
        self.stat_evictions = 0  # host-LRU entries dropped (no store)
        self.stat_store_drops = 0  # corrupt/failed store round-trips

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def store_entries(self) -> int:
        return len(self._store_index)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _gauges(self) -> None:
        self._metrics.decode_kv_tier_bytes(self.deployment, "host", self.host_bytes)
        self._metrics.decode_kv_tier_bytes(self.deployment, "store", self.store_bytes)

    # ------------------------------------------------------------- demotion
    def put(self, tokens, components: list[np.ndarray]) -> bool:
        """Demote one evicted device entry (page-aligned token span + its
        pool-component bytes) into the host pool. Covered spans are
        skipped (a resident entry at least as deep already serves every
        prompt this one could); LRU entries spill to the store when the
        byte budget overflows. Returns whether the entry was admitted."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        length = (int(tokens.shape[0]) // self.page_size) * self.page_size
        if length < 1:
            return False
        key = tuple(int(t) for t in tokens[:length])
        covered = self._probe_host(key)
        if covered >= length:
            hit = self._best_host(key)
            if hit is not None:
                hit.last_use = self._tick()
            return False
        entry = _HostEntry(tokens[:length], [np.asarray(c) for c in components])
        if self.budget_bytes <= 0 or entry.nbytes > self.budget_bytes:
            # too big for the host pool at all — straight to the store
            self._spill(key, entry)
            self._gauges()
            return False
        self._entries[key] = entry
        entry.last_use = self._tick()
        self.host_bytes += entry.nbytes
        self.stat_demotions_host += 1
        self._metrics.decode_kv_demotion(self.deployment, "host", 1)
        while self.host_bytes > self.budget_bytes and len(self._entries) > 1:
            coldest = min(self._entries, key=lambda k: self._entries[k].last_use)
            self._spill(coldest, self._entries[coldest])
        self._gauges()
        return True

    def _spill(self, key: tuple, entry: _HostEntry) -> None:
        """Push one host entry down to the persistence store (or drop it
        when no store tier is configured). Store failures degrade: the
        entry is lost, serving is not."""
        if key in self._entries:
            self.host_bytes -= self._entries[key].nbytes
        self._entries.pop(key, None)
        self.host_bytes = max(self.host_bytes, 0)
        if self.store is None:
            self.stat_evictions += 1
            return
        skey = tier_store_key(self.deployment, entry.tokens)
        payload = pickle.dumps(
            {
                "page_size": self.page_size,
                "kv_dtype": self.kv_dtype,
                "tokens": entry.tokens,
                "components": entry.components,
            }
        )
        try:
            self.store.save(skey, payload)
        except Exception as e:  # noqa: BLE001 - store outage degrades, never aborts
            self.stat_store_drops += 1
            log.warning("kv store-tier save failed (entry dropped): %s", e)
            return
        if key not in self._store_index:
            self.store_bytes += entry.nbytes
            self.stat_demotions_store += 1
            self._metrics.decode_kv_demotion(self.deployment, "store", 1)
        self._store_index[key] = (skey, entry.nbytes)

    # ------------------------------------------------------------ promotion
    def _best_host(self, prompt_key: tuple) -> _HostEntry | None:
        best = None
        for key, entry in self._entries.items():
            if len(key) <= len(prompt_key) and prompt_key[: len(key)] == key:
                if best is None or len(key) > best[0]:
                    best = (len(key), entry)
        return best[1] if best is not None else None

    def _probe_host(self, prompt_key: tuple) -> int:
        e = self._best_host(prompt_key)
        return int(e.tokens.shape[0]) if e is not None else 0

    def _best_store_key(self, prompt_key: tuple) -> tuple | None:
        best = None
        for key in self._store_index:
            if len(key) <= len(prompt_key) and prompt_key[: len(key)] == key:
                if best is None or len(key) > len(best):
                    best = key
        return best

    def probe(self, prompt, *, include_store: bool = True) -> int:
        """The deepest span this tier (host pool, plus the store index
        when allowed) could serve for ``prompt`` — host-only metadata, no
        byte movement. What admission and the sibling-pull guard consult
        before deciding a transfer is worth anything."""
        pk = tuple(int(t) for t in prompt)
        depth = self._probe_host(pk)
        if include_store:
            sk = self._best_store_key(pk)
            if sk is not None:
                depth = max(depth, len(sk))
        return depth

    def fetch(
        self, prompt, *, min_depth: int = 0, include_store: bool = True
    ) -> tuple[np.ndarray, list[np.ndarray], str] | None:
        """Best covering entry deeper than ``min_depth``, for promotion:
        ``(tokens, components, tier)`` with tier "host" | "store", or None.
        A store hit is re-admitted into the host pool on the way up (the
        ladder promotes THROUGH tiers, so the next miss on this span is a
        host hit); corrupt or vanished store payloads drop their index
        entry and degrade to the next tier down (then cold)."""
        pk = tuple(int(t) for t in prompt)
        hit = self._best_host(pk)
        if hit is not None and int(hit.tokens.shape[0]) > min_depth:
            hit.last_use = self._tick()
            hit.hits += 1
            self.stat_promotions_host += 1
            return hit.tokens, hit.components, "host"
        if not include_store or self.store is None:
            return None
        skey = self._best_store_key(pk)
        if skey is None or len(skey) <= min_depth:
            return None
        entry = self._load_store(skey)
        if entry is None:
            return None
        self.stat_promotions_store += 1
        # re-admit into the host pool so the NEXT miss is one tier closer
        # (put() skips it as covered only if something deeper arrived)
        self.put(entry.tokens, entry.components)
        return entry.tokens, entry.components, "store"

    def _load_store(self, key: tuple) -> _HostEntry | None:
        skey, nbytes = self._store_index[key]
        raw = None
        try:
            raw = self.store.load(skey)
        except Exception as e:  # noqa: BLE001 - store outage degrades, never aborts
            log.warning("kv store-tier load failed: %s", e)
        if raw is None:
            self._drop_store(key)
            return None
        try:
            payload = pickle.loads(raw)
            if (
                payload.get("page_size") != self.page_size
                or payload.get("kv_dtype") != self.kv_dtype
            ):
                raise ValueError("geometry mismatch")
            tokens = np.asarray(payload["tokens"], np.int32).reshape(-1)
            comps = [np.asarray(c) for c in payload["components"]]
            if tuple(int(t) for t in tokens) != key:
                raise ValueError("token key mismatch")
            return _HostEntry(tokens, comps)
        except Exception as e:  # noqa: BLE001 - corrupt payload must not abort serving
            self.stat_store_drops += 1
            log.warning("corrupt kv store-tier entry dropped: %s", e)
            self._drop_store(key)
            return None

    def _drop_store(self, key: tuple) -> None:
        _, nbytes = self._store_index.pop(key, (None, 0))
        self.store_bytes = max(self.store_bytes - nbytes, 0)
        self._gauges()

    # ------------------------------------------------------------- introspect
    def snapshot(self) -> dict:
        return {
            "host_entries": len(self._entries),
            "host_bytes": self.host_bytes,
            "store_entries": len(self._store_index),
            "store_bytes": self.store_bytes,
            "demotions_host": self.stat_demotions_host,
            "demotions_store": self.stat_demotions_store,
            "promotions_host": self.stat_promotions_host,
            "promotions_store": self.stat_promotions_store,
            "evictions": self.stat_evictions,
            "store_drops": self.stat_store_drops,
        }
