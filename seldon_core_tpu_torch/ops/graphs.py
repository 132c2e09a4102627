"""One captured CUDA graph per dispatch key: the port's compiled programs.

The JAX package serves every forward as one compiled program per shape
(``jax.jit``'s cache, keyed on shapes and static arguments), and
``recompiles_since_warmup() == 0`` is its serving invariant. Eager PyTorch
runs the same forward as hundreds of kernel launches, each paid on the host.
The port's counterpart is a ``GraphCache``: one ``GraphEntry`` per dispatch
key, which holds

- static input tensors the caller copies its arguments into (from pinned
  host staging buffers when the argument is a host array);
- the ``torch.cuda.CUDAGraph`` captured over the function on those inputs;
- the static outputs the graph writes;
- the hand-written kernels' launches counted while it was captured.

A replay credits those launches back to the kernels' counters
(``ops/flash_attention.py::LAUNCHES``, ``ops/int8_matmul.py::LAUNCHES`` and
``LAUNCHES_BY_BODY``), so the counters read the same whether a path runs
captured or eager; a capture itself launches nothing and counts nothing.

The entries of one cache share one graph memory pool and one capture stream,
and replay on the caller's current stream, one after another. A lock per
entry serialises copy-in, replay and copy-out: two threads that run one key
at once would otherwise write the same static buffers. ``GraphEntry.run``
hands back clones (or what the caller's ``post`` makes of the static outputs)
before it releases the lock.

A key's first use runs the function once eagerly and then captures it
(the eager run loads the kernels and makes the library handles the capture
needs), so that call launches every kernel twice: ``warmup()`` pays it
before traffic.

On a CPU device, or with ``capture=False`` (the eager twin a caller asks for
by name), an entry runs the function eagerly on the same static buffers, so
the CPU tests run the code the card runs except for the capture itself. A
capture that fails raises: nothing falls back to eager.
"""

from __future__ import annotations

import collections
import gc
import time
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.ops import flash_attention, int8_matmul

# every launch counter a captured function can move
COUNTERS = (flash_attention.LAUNCHES, int8_matmul.LAUNCHES, *int8_matmul.LAUNCHES_BY_BODY.values())


def _counts() -> list[int]:
    return [c.count for c in COUNTERS]


def _structure_clone(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_structure_clone(o) for o in out)


class GraphCache:
    """Dispatch key -> ``GraphEntry`` for one runtime or scheduler: one graph
    memory pool, one capture stream, and the count of entries per program
    (``key[0]``), the port's form of ``jax.jit``'s cache sizes."""

    def __init__(self, device: torch.device, *, capture: bool = True):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.stream = torch.cuda.Stream(self.device) if self.capture else None
        self._entries: dict[tuple, GraphEntry] = {}
        self._lock = threading.Lock()  # one entry built (and captured) at a time
        self.stat_captures = 0
        self.stat_replays = 0

    def entry(self, key: tuple, fn: Callable, inputs: Sequence[tuple[tuple, torch.dtype]]) -> "GraphEntry":
        """The entry for ``key``, made on first use with static inputs of the
        given (shape, dtype) on the cache's device; its graph is captured on
        its first run."""
        e = self._entries.get(key)
        if e is None:
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    e = self._entries[key] = GraphEntry(self, fn, inputs)
        return e

    def build_seconds(self) -> dict[tuple, float]:
        """Seconds each built entry's first run took: its capture (with the
        eager run before it) on the card, its first eager run elsewhere."""
        return {k: e.build_s for k, e in list(self._entries.items()) if e.build_s is not None}

    def counts(self) -> dict[str, int]:
        """Entries per program name (``key[0]``)."""
        return dict(collections.Counter(k[0] for k in self._entries))

    def keys(self) -> list[tuple]:
        return list(self._entries)


class StaticBuffer:
    """A device tensor that keeps its address and takes each call's value in
    place: a host array goes through a pinned staging buffer by an
    asynchronous copy on the current stream, and the next write waits for
    that copy to leave the staging buffer first."""

    def __init__(self, shape: tuple, dtype: torch.dtype, device: torch.device):
        with torch.inference_mode():
            self.tensor = torch.zeros(tuple(shape), dtype=dtype, device=device)
        self._staging = torch.zeros(tuple(shape), dtype=dtype, pin_memory=True) if device.type == "cuda" else None
        self._uploaded: torch.cuda.Event | None = None

    def write(self, value) -> None:
        dst = self.tensor
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"a value of shape {tuple(value.shape)} for a static buffer of shape {tuple(dst.shape)}")
        with torch.inference_mode():  # the buffer is an inference tensor
            if isinstance(value, torch.Tensor):
                dst.copy_(value)
            elif self._staging is None:
                np.copyto(dst.numpy(), value, casting="same_kind")
            else:
                if self._uploaded is not None:
                    self._uploaded.synchronize()
                np.copyto(self._staging.numpy(), value, casting="same_kind")
                dst.copy_(self._staging, non_blocking=True)
                self._uploaded = torch.cuda.Event()
                self._uploaded.record()


class GraphEntry:
    """One dispatch key: static inputs, the captured graph, static outputs,
    and the kernel launches one replay stands for."""

    def __init__(self, cache: GraphCache, fn: Callable, inputs: Sequence[tuple[tuple, torch.dtype]]):
        self.cache = cache
        self.fn = fn
        self._buffers = [StaticBuffer(shape, dtype, cache.device) for shape, dtype in inputs]
        self.inputs = [b.tensor for b in self._buffers]
        self.lock = threading.Lock()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        self.launches = [0] * len(COUNTERS)
        self.build_s: float | None = None

    def load(self, *values) -> None:
        """Copy the call's arguments (host arrays or tensors, each exactly its
        static input's shape) into the static inputs, on the current stream."""
        if len(values) != len(self._buffers):
            raise ValueError(f"{len(values)} arguments for {len(self._buffers)} static inputs")
        for buf, v in zip(self._buffers, values):
            buf.write(v)

    def replay(self) -> Any:
        """Run the function on the static inputs: replay the graph (captured
        on the first call on the card), or call it eagerly. Returns the
        static outputs."""
        with torch.inference_mode():
            return self._replay()

    def _replay(self) -> Any:
        t0 = time.perf_counter() if self.build_s is None else 0.0
        if not self.cache.capture:
            self.outputs = self.fn(*self.inputs)
            if self.build_s is None:
                self.build_s = time.perf_counter() - t0
            return self.outputs
        if self.graph is None:
            self._capture()
            self.build_s = time.perf_counter() - t0
        self.graph.replay()
        for counter, n in zip(COUNTERS, self.launches):
            if n:
                counter.add(n)
        self.cache.stat_replays += 1
        return self.outputs

    def _capture(self) -> None:
        cache = self.cache
        with cache._lock:
            # one eager run on the capture stream first: it builds and loads
            # the kernels and makes the library handles and workspaces the
            # capture then finds in place
            cache.stream.wait_stream(torch.cuda.current_stream(cache.device))
            with torch.cuda.stream(cache.stream):
                self.fn(*self.inputs)
            torch.cuda.current_stream(cache.device).wait_stream(cache.stream)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection while capturing: a collection that
            # frees another, unreachable graph destroys it on this thread,
            # which invalidates the capture (torch.cuda.graph collects once
            # on entry, before the capture begins)
            gc_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=cache.pool, stream=cache.stream,
                                      capture_error_mode="thread_local"):
                    outputs = self.fn(*self.inputs)
            finally:
                if gc_enabled:
                    gc.enable()
            # a capture queues the launches without running them: what the
            # wrappers counted meanwhile is what each replay credits
            self.launches = [after - b for after, b in zip(_counts(), before)]
            for counter, n in zip(COUNTERS, self.launches):
                if n:
                    counter.add(-n)
            self.graph, self.outputs = graph, outputs
            cache.stat_captures += 1

    def run(self, *values, post: Callable[[Any], Any] | None = None) -> Any:
        """Load, replay and copy out under the entry's lock: ``post`` maps the
        static outputs to tensors the caller may keep (default: clones)."""
        with self.lock, torch.inference_mode():
            self.load(*values)
            out = self.replay()
            return post(out) if post is not None else _structure_clone(out)
