"""Request micro-batcher (port of ``seldon_core_tpu/serving/batcher.py``).

Concurrent requests for one predictor are coalesced along the batch axis:
collect until ``max_batch`` rows or a ``batch_timeout_ms`` deadline, run the
graph once on the merged batch (``GraphExecutor.execute_many``, which still
routes per request), then hand each request its own rows. Requests merge
only when their non-batch shape and dtype match. A generative predictor's
tensor requests bypass coalescing and ride its continuous-batching decode
scheduler instead (per-row slot admission). The merged walk runs under the
loosest deadline of its batch-mates (each request's own budget is enforced
at its ingress, so a tight mate cannot cancel the shared walk).

Every batch is observed in ``seldon_tpu_batch_size`` and every mate's wait
in ``seldon_tpu_batch_queue_wait_seconds``. A traced mate gets a
``batcher`` span, opened at its own enqueue with its ``queue_wait_ms``;
the merged walk runs under every mate's trace at once, so its unit spans
land in each mate's tree under that mate's batcher span.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.engine.resilience import DEADLINE, Deadline, current_deadline
from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch import telemetry

ExecuteFn = Callable[[SeldonMessage], Awaitable[SeldonMessage]]
ExecuteManyFn = Callable[[list], Awaitable[list]]


def make_batcher(
    tpu_spec,
    execute: ExecuteFn,
    *,
    execute_many: ExecuteManyFn,
    decode_scheduler=None,
    metrics: NullMetrics | None = None,
    deployment_name: str = "",
) -> "MicroBatcher | None":
    """The batching policy of a predictor's TpuSpec: None when batching is
    pointless (max_batch <= 1) or forbidden (``batch_across_requests``
    false: every request walks alone), except that a generative predictor's
    ``decode_scheduler`` always gets one, which hands it tensor requests."""
    if decode_scheduler is None and (tpu_spec.max_batch <= 1 or not tpu_spec.batch_across_requests):
        return None
    return MicroBatcher(
        execute,
        execute_many=execute_many,
        max_batch=tpu_spec.max_batch,
        batch_timeout_ms=tpu_spec.batch_timeout_ms,
        queue_timeout_ms=tpu_spec.queue_timeout_ms,
        decode_scheduler=decode_scheduler,
        metrics=metrics,
        deployment_name=deployment_name,
    )


@dataclass
class _Pending:
    msg: SeldonMessage
    rows: int
    future: asyncio.Future
    # the submitting request's deadline budget (DEADLINE at submit time)
    deadline: Deadline | None = None
    enqueued_at: float = 0.0  # perf_counter at submit
    # the submitter's trace contexts and enqueue time (the flush task runs
    # in whichever mate's context triggered it)
    trace_ctxs: tuple = ()
    enq_ns: int = 0


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
        decode_scheduler=None,
        metrics: NullMetrics | None = None,
        deployment_name: str = "",
    ):
        self._metrics = metrics or NullMetrics()
        self._deployment = deployment_name
        self._execute = execute
        self._execute_many = execute_many
        # generative tier: tensor requests ride the decode loop instead
        self._decode = decode_scheduler
        self.max_batch = max_batch
        self.batch_timeout_s = batch_timeout_ms / 1000.0
        self.queue_timeout_s = queue_timeout_ms / 1000.0
        self._pending: dict[tuple, list[_Pending]] = {}
        self._pending_rows: dict[tuple, int] = {}
        self._flush_timers: dict[tuple, asyncio.TimerHandle] = {}
        self._inflight: set[asyncio.Task] = set()
        self._closed = False
        # the loop the batcher serves on, recorded at the first submit, so a
        # thread off that loop can close it (close_nowait)
        self._loop: asyncio.AbstractEventLoop | None = None
        # what the batcher achieved: batches run and the rows in them
        self.stat_batches = 0
        self.stat_rows = 0

    async def submit(self, msg: SeldonMessage) -> SeldonMessage:
        """Submit one request; resolves with its own rows of the result."""
        if self._closed:
            raise APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, "batcher closed")
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        arr = msg.array
        if arr is None:
            return await self._execute(msg)
        if self._decode is not None:
            # iteration-level scheduling replaces shape-keyed coalescing:
            # every row admits into a KV slot as one frees
            return await self._decode.execute_message(msg)
        arr = np.asarray(arr)
        if arr.ndim < 2:
            arr = np.atleast_2d(arr)
            msg = msg.with_array(arr)
        rows = int(arr.shape[0])
        if rows >= self.max_batch:
            return await self._execute(msg)

        key = (arr.shape[1:], str(arr.dtype))
        loop = asyncio.get_running_loop()
        item = _Pending(
            msg=msg,
            rows=rows,
            future=loop.create_future(),
            deadline=current_deadline(),
            enqueued_at=time.perf_counter(),
            trace_ctxs=telemetry.current_contexts(),
            enq_ns=telemetry.now_ns(),
        )
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
        # the merged walk's budget: the loosest batch-mate's (none if any
        # mate has none). The flush task inherits the context of whichever
        # request triggered the flush; its budget alone would cancel the
        # work of looser mates.
        if any(i.deadline is None for i in items):
            DEADLINE.set(None)
        else:
            DEADLINE.set(max((i.deadline for i in items), key=lambda d: d.expires_at))
        total_rows = sum(i.rows for i in items)
        self.stat_batches += 1
        self.stat_rows += total_rows
        now = time.perf_counter()
        waits = [now - i.enqueued_at for i in items]
        self._metrics.batch(self._deployment, total_rows, waits)
        batch_spans = []
        walk_ctxs = []
        for i, w in zip(items, waits):
            if not i.trace_ctxs:
                continue
            ctxs, spans = telemetry.child_contexts(
                i.trace_ctxs,
                "batcher",
                {"rows": total_rows, "mates": len(items), "queue_wait_ms": round(w * 1e3, 3)},
                start_ns=i.enq_ns,
            )
            walk_ctxs.extend(ctxs)
            batch_spans.extend(spans)
        telemetry.TRACE.set(tuple(walk_ctxs))
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
            for s in batch_spans:
                s.error = True
        finally:
            t_end = telemetry.now_ns()
            for s in batch_spans:
                s.end(t_end)

    async def close(self) -> None:
        """Flush queued requests, then await every in-flight batch so no
        caller is left with an unresolved future."""
        self._closed = True
        for key in list(self._pending):
            self._cancel_timer(key)
            self._flush(key)
        # wait on the unfinished ones only: gather over finished tasks
        # returns without yielding, so a finished task whose discard
        # callback has not run yet would spin this loop forever
        while pending := [t for t in self._inflight if not t.done()]:
            await asyncio.gather(*pending, return_exceptions=True)

    def close_nowait(self, then: Callable[[], None] | None = None) -> None:
        """Shutdown callable from any thread (the reconciler drains a
        replaced or deleted deployment from a worker thread): the flag and
        the drain are both scheduled on the batcher's loop, so a request
        that found this batcher before the swap submits within the same
        loop step it looked it up in and is drained, never refused.
        ``then`` runs once the drain has ended (at once when the batcher
        never served)."""
        loop = self._loop
        if loop is None or loop.is_closed():
            self._closed = True
            if then is not None:
                then()
            return

        def _drain() -> None:
            self._closed = True
            task = asyncio.ensure_future(self.close())
            if then is not None:
                task.add_done_callback(lambda _: then())

        loop.call_soon_threadsafe(_drain)
