"""Request micro-batcher (port of ``seldon_core_tpu/serving/batcher.py``).

Concurrent requests for one predictor are coalesced along the batch axis:
collect until ``max_batch`` rows or a ``batch_timeout_ms`` deadline, run the
graph once on the merged batch (``GraphExecutor.execute_many``, which still
routes per request), then hand each request its own rows. Requests merge
only when their non-batch shape and dtype match.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Awaitable, Callable

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage

ExecuteFn = Callable[[SeldonMessage], Awaitable[SeldonMessage]]
ExecuteManyFn = Callable[[list], Awaitable[list]]


def make_batcher(tpu_spec, execute: ExecuteFn, *, execute_many: ExecuteManyFn) -> "MicroBatcher | None":
    """The batching policy of a predictor's TpuSpec: None when batching is
    pointless (max_batch <= 1)."""
    if tpu_spec.max_batch <= 1:
        return None
    return MicroBatcher(
        execute,
        execute_many=execute_many,
        max_batch=tpu_spec.max_batch,
        batch_timeout_ms=tpu_spec.batch_timeout_ms,
        queue_timeout_ms=tpu_spec.queue_timeout_ms,
    )


@dataclass
class _Pending:
    msg: SeldonMessage
    rows: int
    future: asyncio.Future


class MicroBatcher:
    """Coalesces SeldonMessages with tensor payloads for one executor."""

    def __init__(
        self,
        execute: ExecuteFn,
        *,
        execute_many: ExecuteManyFn,
        max_batch: int = 64,
        batch_timeout_ms: float = 3.0,
        queue_timeout_ms: float = 2000.0,
    ):
        self._execute = execute
        self._execute_many = execute_many
        self.max_batch = max_batch
        self.batch_timeout_s = batch_timeout_ms / 1000.0
        self.queue_timeout_s = queue_timeout_ms / 1000.0
        self._pending: dict[tuple, list[_Pending]] = {}
        self._pending_rows: dict[tuple, int] = {}
        self._flush_timers: dict[tuple, asyncio.TimerHandle] = {}
        self._inflight: set[asyncio.Task] = set()
        self._closed = False
        # what the batcher achieved: batches run and the rows in them
        self.stat_batches = 0
        self.stat_rows = 0

    async def submit(self, msg: SeldonMessage) -> SeldonMessage:
        """Submit one request; resolves with its own rows of the result."""
        if self._closed:
            raise APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, "batcher closed")
        arr = msg.array
        if arr is None:
            return await self._execute(msg)
        arr = np.asarray(arr)
        if arr.ndim < 2:
            arr = np.atleast_2d(arr)
            msg = msg.with_array(arr)
        rows = int(arr.shape[0])
        if rows >= self.max_batch:
            return await self._execute(msg)

        key = (arr.shape[1:], str(arr.dtype))
        loop = asyncio.get_running_loop()
        item = _Pending(msg=msg, rows=rows, future=loop.create_future())
        self._pending.setdefault(key, []).append(item)
        self._pending_rows[key] = self._pending_rows.get(key, 0) + rows
        if self._pending_rows[key] >= self.max_batch:
            self._cancel_timer(key)
            self._flush(key)
        elif key not in self._flush_timers:
            self._flush_timers[key] = loop.call_later(self.batch_timeout_s, self._flush, key)
        try:
            return await asyncio.wait_for(item.future, timeout=self.queue_timeout_s)
        except asyncio.TimeoutError:
            raise APIException(ErrorCode.REQUEST_TIMEOUT, "request timed out in batch queue") from None

    def _cancel_timer(self, key) -> None:
        t = self._flush_timers.pop(key, None)
        if t is not None:
            t.cancel()

    def _flush(self, key) -> None:
        self._flush_timers.pop(key, None)
        items = self._pending.pop(key, [])
        self._pending_rows.pop(key, None)
        if not items:
            return
        task = asyncio.ensure_future(self._run_batch(items))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, items: list[_Pending]) -> None:
        self.stat_batches += 1
        self.stat_rows += sum(i.rows for i in items)
        try:
            if len(items) == 1:
                outs = [await self._execute(items[0].msg)]
            else:
                outs = await self._execute_many([i.msg for i in items])
            for i, o in zip(items, outs):
                if not i.future.done():
                    i.future.set_result(o)
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            for i in items:
                if not i.future.done():
                    i.future.set_exception(e)

    async def close(self) -> None:
        """Flush queued requests, then await every in-flight batch so no
        caller is left with an unresolved future."""
        self._closed = True
        for key in list(self._pending):
            self._cancel_timer(key)
            self._flush(key)
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
