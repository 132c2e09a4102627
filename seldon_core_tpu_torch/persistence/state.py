"""State stores: the persistence tier's byte bags.

Port of the store half of ``seldon_core_tpu/persistence/state.py``, which
the host KV tier (``serving/kv_host_tier.py``) spills to: the reference's
key format (``persistence_{deployment}_{unit}``), one pickle file per key
under a directory (``file://``), or Redis (``redis://``, with ``redis``
imported only when such a store is made) with a bounded socket budget.
``StatePersister`` snapshots stateful units (those that define
``__getstate__`` and ``__setstate__``: the online fine-tuning unit,
``models/online.py``, a standalone microservice's user object) when
asked, and every ``period_s`` once started (the reference's
PersistenceThread, which ``serving/microservice.py --persistence``
starts), and restores them when attached, under the same keys.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import pickle
import threading
import weakref
from typing import Any, Iterable

log = logging.getLogger(__name__)


def state_key(deployment_id: str, unit_id: str) -> str:
    return f"persistence_{deployment_id}_{unit_id}"  # reference key format


class FileStateStore:
    """One pickle file per key under a directory; a relative directory is
    resolved against the working directory once, when the store is made."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        # sanitizing is lossy ("a/b" and "a_b" collide): a short digest of
        # the raw key keeps distinct keys in distinct files
        digest = hashlib.blake2b(key.encode(), digest_size=4).hexdigest()
        return os.path.join(self.directory, f"{safe}.{digest}.pkl")

    def save(self, key: str, payload: bytes) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._path(key))

    def load(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


class RedisStateStore:
    """Redis-backed store with a bounded socket budget: a hung Redis
    degrades to skip-store (save dropped, load misses, both logged) and
    never blocks the serving loop."""

    def __init__(self, url: str):
        import redis  # not in the base image

        from seldon_core_tpu_torch.utils.env import redis_timeout_s

        timeout = redis_timeout_s()
        self._errors = (redis.exceptions.ConnectionError, redis.exceptions.TimeoutError)
        self._r = redis.Redis.from_url(url, socket_timeout=timeout, socket_connect_timeout=timeout)

    def save(self, key: str, payload: bytes) -> None:
        try:
            self._r.set(key, payload)
        except self._errors as e:
            log.warning("redis save skipped (store unreachable): %s", e)

    def load(self, key: str) -> bytes | None:
        try:
            return self._r.get(key)
        except self._errors as e:
            log.warning("redis load skipped (store unreachable): %s", e)
            return None


def make_state_store(url: str):
    """The store a URL names (``file://<dir>``, the directory absolute or
    relative to the working directory, or ``redis://...``), None for
    an empty URL or when ``redis`` cannot be imported; another scheme
    raises ValueError."""
    if not url:
        return None
    if url.startswith("file://"):
        return FileStateStore(url[len("file://"):])
    if url.startswith("redis://"):
        try:
            return RedisStateStore(url)
        except ImportError:
            log.warning("redis not importable; state persistence disabled")
            return None
    raise ValueError(f"unknown state store url: {url}")


DEFAULT_PERIOD_S = 60.0


class StatePersister:
    """Snapshots stateful units (``persist_now``, and on a period between
    ``start`` and ``stop``); restores them at attach time. A unit is
    stateful when its own class hierarchy defines both ``__getstate__`` and
    ``__setstate__``."""

    def __init__(self, store, deployment_id: str, period_s: float = DEFAULT_PERIOD_S):
        self.store = store
        self.deployment_id = deployment_id
        self.period_s = period_s
        self._units: dict[str, Any] = {}
        self._thread: threading.Thread | None = None
        self._stop: threading.Event | None = None

    @staticmethod
    def is_stateful(unit: Any) -> bool:
        # object defines a default __getstate__ (3.11+): only an explicit
        # pair in the unit's own classes counts
        mro = [c for c in type(unit).__mro__ if c is not object]
        return any("__getstate__" in c.__dict__ for c in mro) and any("__setstate__" in c.__dict__ for c in mro)

    def attach(self, units: Iterable[Any], prefix: str = "") -> int:
        """Register stateful units and restore any saved state; returns the
        number restored. ``prefix`` (a predictor's name) namespaces the unit
        ids, so same-named units of two predictors never share a key."""
        restored = 0
        for unit in units:
            if not self.is_stateful(unit):
                continue
            name = getattr(unit, "name", None) or type(unit).__name__
            if prefix:
                name = f"{prefix}.{name}"
            self._units[name] = unit
            payload = self.store.load(state_key(self.deployment_id, name))
            if payload is not None:
                try:
                    unit.__setstate__(pickle.loads(payload))
                    restored += 1
                except Exception as e:  # noqa: BLE001 - stale or corrupt state
                    log.warning("could not restore state for %s: %s", name, e)
        return restored

    def persist_now(self) -> int:
        saved = 0
        for name, unit in self._units.items():
            try:
                self.store.save(state_key(self.deployment_id, name), pickle.dumps(unit.__getstate__()))
                saved += 1
            except Exception as e:  # noqa: BLE001
                log.warning("could not persist state for %s: %s", name, e)
        return saved

    def start(self) -> None:
        """Snapshot every ``period_s`` on a daemon thread (a thread, not an
        asyncio task, so it works whichever thread serves), as the
        reference's PersistenceThread (persistence.py:43-48) does."""
        if not self._units or self._thread is not None:
            return
        stop = self._stop = threading.Event()

        def loop():
            while not stop.wait(self.period_s):
                self.persist_now()

        self._thread = threading.Thread(target=loop, name=f"persist-{self.deployment_id}", daemon=True)
        self._thread.start()
        _RUNNING.add(self)

    def stop(self) -> None:
        """End the periodic snapshots and flush once more."""
        self._halt()
        self.persist_now()

    def _halt(self) -> None:
        """Stop the snapshot thread and join it (a snapshot in progress
        finishes first)."""
        _RUNNING.discard(self)
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None


# persisters whose thread runs: joined at exit where their owner never
# stopped them, since a daemon thread killed mid-snapshot while the
# interpreter finalises can abort the process
_RUNNING: "weakref.WeakSet[StatePersister]" = weakref.WeakSet()


@atexit.register
def _halt_at_exit() -> None:
    for persister in list(_RUNNING):
        persister._halt()
