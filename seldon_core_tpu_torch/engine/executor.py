"""In-process graph executor — the data-plane core.

Port of ``seldon_core_tpu/engine/executor.py``, the plain graph walk:

    1. transform_input            (MODEL units: this IS predict)
    2. leaf -> return
    3. route                      (-1 = fan out to all children)
    4. children, concurrently
    5. aggregate                  (COMBINER; pass-through for single child)
    6. transform_output

meta merged per node, ROUTER choices recorded in meta.routing; feedback
walks the recorded routing back down to the units that learn from it.
``execute_many`` walks a coalesced batch: data nodes run once on the merged
rows, route nodes decide per request. A result that a model left on the
card is read back to the host in the compute pool, off the event loop,
before rows are scattered or the response is encoded.

Every unit call goes through the reference's resilience pipeline
(``engine/resilience.py``): deadline check -> breaker gate -> attempt ->
retry loop with backoff that never sleeps past the deadline (idempotent
methods only, never send_feedback). Breakers are kept per endpoint
(``host:port`` of a remote node, else the node name) and shared by the
nodes on one endpoint. A ROUTER with ``fallback_child`` serves that
branch when the chosen child's breaker is open or its subtree fails
transport-class; a COMBINER with ``quorum``
aggregates the children that survive. Degraded replies carry
``meta.tags["degraded"]`` and the branch actually served in meta.routing.

Each attempt of a unit call is one trace span (``telemetry``), named
``{unit}.{method}``, recorded into every trace the walk runs under, and
timed into the ``unit_call_hook``; a tensor the unit left on the card is
read back inside its span, so span and metric hold the device's time, not
the launch's. Retries, breaker fast-fails and transitions, deadline
exhaustion and degradation are span events as well as ``ResilienceEvents``.
A request tagged ``trace`` outside a served trace gets its unit spans back
in ``meta.tags["trace"]`` (``telemetry.local_trace(s)``).

A SHADOW router (``shadow_fanout``) serves its routed child and mirrors a
copy of the input to every other child as a detached task: no deadline,
no trace, failures logged and never raised. When a mirror finishes, its
answer is compared with the primary's (``_outputs_agree``) and the verdict
goes to the ``shadow_compare_hook``; ``drain_shadows`` awaits the mirrors
still in flight.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_host
from seldon_core_tpu_torch import telemetry
from seldon_core_tpu_torch.engine.resilience import (
    DEADLINE,
    HALF_OPEN,
    NULL_EVENTS,
    CircuitBreaker,
    ResilienceEvents,
    RetryState,
    breaker_open_error,
    current_deadline,
    deadline_exceeded,
    is_breaker_open_error,
    is_retryable,
)
from seldon_core_tpu_torch.engine.units import ROUTE_ALL, Unit, UnitRegistry, default_registry
from seldon_core_tpu_torch.graph.spec import (
    TYPE_METHODS,
    PredictiveUnit,
    PredictiveUnitMethod,
    PredictorSpec,
    ResilienceSpec,
)

# degradation marker written into meta.tags when a request was served by a
# fallback branch or a partial quorum instead of its nominal path
DEGRADED_TAG = "degraded"

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Node:
    """Runtime tree node. ``policy``: the node's resilience knobs, parsed
    from its CR parameters; their runtime state (breakers, retry RNGs) lives
    on the executor, keyed by node name."""

    spec: PredictiveUnit
    unit: Unit
    children: list["Node"]
    policy: ResilienceSpec = dataclasses.field(default_factory=ResilienceSpec)

    @property
    def name(self) -> str:
        return self.spec.name

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _has_method(node: Node, method: PredictiveUnitMethod) -> bool:
    spec = node.spec
    if spec.methods:
        return method in spec.methods
    if spec.type is not None:
        return method in TYPE_METHODS.get(spec.type, ())
    # implementation-only node: allow everything the unit implements
    return True


async def _gather_settled(*aws):
    """gather that lets every sibling settle before failing, so no branch
    keeps running detached for a request that already errored."""
    results = await asyncio.gather(*aws, return_exceptions=True)
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results


class GraphExecutor:
    """Executes one predictor graph."""

    def __init__(
        self,
        root: Node,
        resilience_events: ResilienceEvents | None = None,
        unit_call_hook: Callable[[str, str, float], None] | None = None,
        feedback_metrics_hook: Callable[[str, float], None] | None = None,
        shadow_compare_hook: Callable[[str, bool], None] | None = None,
    ):
        self.root = root
        self._events = resilience_events or NULL_EVENTS
        self._unit_hook = unit_call_hook
        self._feedback_hook = feedback_metrics_hook
        # (shadow unit, agree) per mirrored prediction
        self._shadow_hook = shadow_compare_hook
        # SHADOW mirror walks in flight, kept so drain_shadows can await them
        self._shadow_tasks: set[asyncio.Task] = set()
        self._retries: dict[str, RetryState] = {}
        # Breakers are keyed per endpoint (host:port for a node with a
        # declared endpoint, else the node's name) and shared by the nodes
        # on one endpoint, so a backend's health is tracked once; the first
        # node walked with a breaker spec governs it.
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_keys: dict[str, str] = {}
        shared: dict[str, CircuitBreaker] = {}
        shared_spec: dict[str, Any] = {}
        for n in root.walk():
            if n.policy.retry is not None:
                self._retries[n.name] = RetryState(n.policy.retry)
            if n.policy.breaker is None:
                continue
            key = endpoint_key(n.spec)
            cb = shared.get(key)
            if cb is None:
                cb = shared[key] = CircuitBreaker(
                    n.policy.breaker,
                    on_transition=lambda state, k=key: self._on_breaker_transition(k, state),
                )
                shared_spec[key] = n.policy.breaker
            elif n.policy.breaker != shared_spec[key]:
                log.warning(
                    "node '%s': breaker config conflicts with the one already governing endpoint '%s' "
                    "(first-declared wins)", n.name, key,
                )
            self._breakers[n.name] = cb
            self._breaker_keys[n.name] = key

    def _on_breaker_transition(self, key: str, state: str) -> None:
        """A transition fires inside some request's walk: it goes to the
        event sink and to that request's trace."""
        self._events.breaker_transition(key, state)
        telemetry.add_event("breaker_transition", {"endpoint": key, "state": state})

    def breaker_for(self, node_name: str) -> CircuitBreaker | None:
        """The breaker guarding a node's endpoint, if one is configured."""
        return self._breakers.get(node_name)

    def ready(self) -> bool:
        return all(n.unit.ready() for n in self.root.walk())

    # ------------------------------------------------------------- predict
    async def execute(self, msg: SeldonMessage) -> SeldonMessage:
        if "trace" in msg.meta.tags and not telemetry.active():
            # a request tagged {"trace": ...} outside a served trace still
            # gets its unit spans back, from a store-less local trace
            with telemetry.local_trace(puid=msg.meta.puid) as buf:
                out = await self._get_output(self.root, msg)
            return out.with_meta(out.meta.merged_with(Meta(tags={"trace": buf.tag_spans()})))
        return await self._get_output(self.root, msg)

    async def execute_many(self, msgs: list[SeldonMessage]) -> list[SeldonMessage]:
        """Vectorized walk for a coalesced batch; every message needs a
        tensor payload of one non-batch shape, anything else walks alone."""
        if not msgs:
            return []
        arrays = [m.array for m in msgs]
        if len(msgs) == 1 or any(a is None for a in arrays):
            return [await self.execute(m) for m in msgs]
        if len({tuple(a.shape[1:]) for a in arrays}) != 1:
            return [await self.execute(m) for m in msgs]
        tagged = [i for i, m in enumerate(msgs) if "trace" in m.meta.tags]
        if tagged and not telemetry.active():
            # one local trace per tagged request: the merged walk reports
            # the spans the scalar walk would
            with telemetry.local_traces([msgs[i].meta.puid for i in tagged]) as bufs:
                outs = await self._get_output_many(self.root, list(msgs))
            for buf, i in zip(bufs, tagged):
                outs[i] = outs[i].with_meta(outs[i].meta.merged_with(Meta(tags={"trace": buf.tag_spans()})))
            return outs
        return await self._get_output_many(self.root, list(msgs))

    @staticmethod
    def _merge_rows(msgs: list[SeldonMessage]) -> SeldonMessage:
        merged = np.concatenate([np.asarray(m.array) for m in msgs], axis=0)
        return msgs[0].with_array(merged)

    @staticmethod
    def _scatter_rows(
        msgs: list[SeldonMessage], out: SeldonMessage
    ) -> list[SeldonMessage]:
        """Give each request its own row slice of a merged result, with its
        own puid and routing winning over the merged call's meta."""
        rows = [int(np.atleast_2d(np.asarray(m.array)).shape[0]) for m in msgs]
        out_arr = None if out.array is None else np.asarray(out.array)
        splittable = out_arr is not None and out_arr.shape[0] == sum(rows)
        om = out.meta
        result = []
        offset = 0
        for m, r in zip(msgs, rows):
            mm = m.meta
            meta = Meta(
                puid=mm.puid or om.puid,
                tags={**mm.tags, **om.tags},
                routing={**om.routing, **mm.routing},
                request_path={**mm.request_path, **om.request_path},
            )
            if splittable:
                result.append(out.with_array_meta(out_arr[offset : offset + r], meta))
                offset += r
            else:  # the graph changed the batch dim: share the result
                result.append(out.with_meta(meta))
        return result

    @staticmethod
    async def _settle_to_host(out: SeldonMessage) -> SeldonMessage:
        """Read a tensor result back to host numpy. A tensor on the card is
        read in the compute pool: ``.cpu()`` waits for the device to finish
        the forward, and on the event loop that wait would stall the ingress
        and every other request for the whole device latency of the batch.
        ``np.asarray`` on a CUDA tensor raises, so this runs before any row
        scatter or encode."""
        arr = out.array
        if not isinstance(arr, torch.Tensor):
            return out
        if arr.device.type == "cpu":
            return out.with_array(to_host(arr))
        from seldon_core_tpu_torch.models.base import compute_pool

        host = await asyncio.get_running_loop().run_in_executor(compute_pool(), to_host, arr)
        return out.with_array(host)

    async def _merged_call(self, node, method, fn, msgs):
        out = await self._call(node, method, fn, self._merge_rows(msgs))
        return self._scatter_rows(msgs, out)

    # ---------------------------------------------------------- resilience
    @staticmethod
    def _counts_for_breaker(e: BaseException) -> bool:
        """Failures that indict the endpoint's health: all but our own
        budget exhaustion, breaker fast-fails, cancellation and answers the
        raiser marked deterministic."""
        if isinstance(e, asyncio.CancelledError):
            return False
        if isinstance(e, APIException):
            if e.error in (ErrorCode.REQUEST_DEADLINE_EXCEEDED, ErrorCode.ENGINE_BREAKER_OPEN):
                return False
            if e.retryable is False:
                # deterministic (a remote 4xx): the backend answered, and
                # counting it would open the breaker of a healthy endpoint
                return False
        return True

    async def _call(self, node: Node, method: str, fn, *args):
        """One unit-method call through the resilience pipeline:
        deadline check -> breaker gate -> attempt -> retry loop. Breaker
        outcomes are recorded per attempt, so a flapping node opens its
        breaker even while retries absorb the failures; a backoff never
        sleeps past the request's remaining budget. Each attempt is one
        span and one timed call, closed after the result's readback (a
        replay returns before the card has finished)."""
        d = current_deadline()
        if d is not None and d.expired():
            self._events.deadline_exceeded(node.name)
            telemetry.add_event("deadline_exceeded", {"unit": node.name})
            raise deadline_exceeded(f"unit '{node.name}'.{method}")
        breaker = self._breakers.get(node.name)
        took_probe = False
        if breaker is not None and method != "send_feedback":
            if not breaker.allow():
                telemetry.add_event("breaker_open", {"endpoint": self._breaker_keys[node.name]})
                raise breaker_open_error(self._breaker_keys[node.name], breaker)
            # allow() consumed a probe slot iff the breaker sits half-open
            took_probe = breaker.state == HALF_OPEN
        retry = self._retries.get(node.name)
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            span_handle = telemetry.begin_spans(
                f"{node.name}.{method}", {"unit": node.name, "method": method, "attempt": attempt}
            )
            try:
                result = await fn(*args)
                if isinstance(result, SeldonMessage):
                    result = await self._settle_to_host(result)
            except BaseException as e:
                telemetry.end_spans(span_handle, error=True)
                self._record_call(node, method, time.perf_counter() - t0)
                if breaker is not None:
                    if self._counts_for_breaker(e):
                        breaker.record_failure()
                    elif took_probe:
                        # no verdict (cancel / deadline): free the probe slot
                        # so the breaker cannot wedge in half-open
                        breaker.release_probe()
                # the backoff slept is the one validated against the budget
                backoff_s = retry.backoff(attempt) if retry is not None else 0.0
                if retry is not None and retry.should_retry(method, attempt, e, backoff_s):
                    self._events.retry(node.name, attempt)
                    telemetry.add_event("retry", {"unit": node.name, "attempt": attempt})
                    await asyncio.sleep(backoff_s)
                    if breaker is not None:
                        if not breaker.allow():
                            # the endpoint tripped open while we backed off
                            telemetry.add_event("breaker_open", {"endpoint": self._breaker_keys[node.name]})
                            raise breaker_open_error(self._breaker_keys[node.name], breaker) from e
                        took_probe = breaker.state == HALF_OPEN
                    continue
                raise
            telemetry.end_spans(span_handle)
            self._record_call(node, method, time.perf_counter() - t0)
            if breaker is not None:
                breaker.record_success()
            return result

    def _record_call(self, node: Node, method: str, dt: float) -> None:
        if self._unit_hook is not None:
            self._unit_hook(node.name, method, dt)

    def _degraded_event(self, node: Node, mode: str) -> None:
        self._events.degraded(node.name, mode)
        telemetry.add_event("degraded", {"unit": node.name, "mode": mode})

    def _fallback_branch(self, node: Node, chosen: int) -> int | None:
        """The router's configured degradation branch, when it is a real
        child other than the one routing chose."""
        fb = node.policy.fallback_child
        if fb is None or fb == chosen or not (0 <= fb < len(node.children)):
            return None
        return fb

    def _branch_breaker_open(self, node: Node, branch: int) -> bool:
        """Non-consuming peek at the chosen child's breaker: firmly open ->
        degrade without dispatching; a reset-elapsed breaker reads half-open
        so probe traffic still reaches the child."""
        breaker = self._breakers.get(node.children[branch].name)
        return breaker is not None and breaker.is_open()

    @staticmethod
    def _fallback_eligible(e: BaseException) -> bool:
        """A router degrades around the chosen child's breaker fast-failing
        or a transport/5xx-class failure in its subtree; never around an
        exhausted deadline."""
        return is_breaker_open_error(e) or is_retryable(e)

    @staticmethod
    def _degrade_meta(msg: SeldonMessage, node_name: str, branch: int, mode: str) -> SeldonMessage:
        """Restamp routing with the branch actually served (feedback replays
        down the real path) and the degradation marker."""
        return msg.with_meta(
            msg.meta.merged_with(Meta(routing={node_name: branch}, tags={DEGRADED_TAG: mode}))
        )

    async def _routed_walk(self, node: Node, branch: int, payload):
        """Walk the routed child with one message (or, in the batched walk,
        a list of the messages routed to it), degrading to the fallback
        branch when the child's breaker is open or its subtree fails
        transport-class."""
        walk = self._get_output_many if isinstance(payload, list) else self._get_output
        fb = self._fallback_branch(node, branch)
        if fb is None or not self._branch_breaker_open(node, branch):
            try:
                return await walk(node.children[branch], payload)
            except Exception as e:  # noqa: BLE001 - gated by _fallback_eligible
                if fb is None or not self._fallback_eligible(e):
                    raise
        self._degraded_event(node, "router_fallback")
        if isinstance(payload, list):
            payload = [self._degrade_meta(m, node.name, fb, "router_fallback") for m in payload]
        else:
            payload = self._degrade_meta(payload, node.name, fb, "router_fallback")
        return await walk(node.children[fb], payload)

    async def _settle_quorum(self, node: Node, aws: Sequence) -> tuple[list, bool]:
        """Settle every child walk. With a COMBINER quorum, a partial
        fan-out failure degrades to the surviving outputs; without one (or
        below it) the first failure re-raises once all have settled.
        Returns (outputs, degraded)."""
        results = await asyncio.gather(*aws, return_exceptions=True)
        failures = [r for r in results if isinstance(r, BaseException)]
        ok = [r for r in results if not isinstance(r, BaseException)]
        if not failures:
            return ok, False
        quorum = node.policy.quorum
        if (
            quorum is not None
            and _has_method(node, PredictiveUnitMethod.AGGREGATE)
            and len(ok) >= max(quorum, 1)
        ):
            self._degraded_event(node, "quorum")
            return ok, True
        raise failures[0]

    async def _get_output_many(
        self, node: Node, msgs: list[SeldonMessage]
    ) -> list[SeldonMessage]:
        unit = node.unit
        msgs = [
            m.with_meta(m.meta.merged_with(Meta(request_path={node.name: unit.image})))
            for m in msgs
        ]
        if _has_method(node, PredictiveUnitMethod.TRANSFORM_INPUT):
            msgs = await self._merged_call(node, "transform_input", unit.transform_input, msgs)
        if not node.children:
            return msgs

        shadow = getattr(unit, "shadow_fanout", False)
        if _has_method(node, PredictiveUnitMethod.ROUTE):
            branches = []
            for m in msgs:
                b = await self._call(node, "route", unit.route, m)
                if shadow and b == ROUTE_ALL:
                    b = 0  # a shadow router's primary, as in the single walk
                if b != ROUTE_ALL and not (0 <= b < len(node.children)):
                    raise APIException(
                        ErrorCode.ENGINE_INVALID_ROUTING,
                        f"unit '{node.name}' routed to {b} with {len(node.children)} children",
                    )
                branches.append(b)
            # mirror every message to each child that is not its primary
            mirrors = []
            if shadow:
                for i, child in enumerate(node.children):
                    idxs = [j for j, b in enumerate(branches) if b != i]
                    if idxs:
                        mirrors.append((child.name, self._spawn_shadow(child, [msgs[j] for j in idxs]), idxs))
            msgs = [
                m.with_meta(m.meta.merged_with(Meta(routing={node.name: b})))
                for m, b in zip(msgs, branches)
            ]
            groups: dict[int, list[int]] = {}
            for i, b in enumerate(branches):
                groups.setdefault(b, []).append(i)

            async def _run_group(b: int, idxs: list[int]):
                sub = [msgs[i] for i in idxs]
                if b == ROUTE_ALL:
                    return idxs, await self._fanout_many(node, sub)
                return idxs, await self._routed_walk(node, b, sub)

            results: list[Any] = [None] * len(msgs)
            for idxs, outs in await _gather_settled(
                *(_run_group(b, idxs) for b, idxs in groups.items())
            ):
                for i, o in zip(idxs, outs):
                    results[i] = o
            for name, task, idxs in mirrors:  # the primaries exist now
                self._attach_compare(name, task, [results[j] for j in idxs])
            out_msgs = results
        else:
            out_msgs = await self._fanout_many(node, msgs)

        if _has_method(node, PredictiveUnitMethod.TRANSFORM_OUTPUT):
            out_msgs = await self._merged_call(node, "transform_output", unit.transform_output, out_msgs)
        return out_msgs

    async def _fanout_many(
        self, node: Node, msgs: list[SeldonMessage]
    ) -> list[SeldonMessage]:
        """All-children fan-out for a batch: each child walks the whole
        batch, then AGGREGATE runs once on the row-aligned child outputs."""
        unit = node.unit
        child_outs, degraded = await self._settle_quorum(
            node, [self._get_output_many(c, msgs) for c in node.children]
        )
        if _has_method(node, PredictiveUnitMethod.AGGREGATE):
            merged_children = [self._merge_rows(co) for co in child_outs]
            out = await self._call(node, "aggregate", unit.aggregate, merged_children)
            if degraded:
                out = out.with_meta(out.meta.merged_with(Meta(tags={DEGRADED_TAG: "quorum"})))
            base = []
            for i, m in enumerate(msgs):
                meta = m.meta
                for co in child_outs:
                    meta = meta.merged_with(co[i].meta)
                base.append(m.with_meta(meta))
            return self._scatter_rows(base, out)
        if len(child_outs) == 1:
            return child_outs[0]
        raise APIException(
            ErrorCode.ENGINE_INVALID_ROUTING,
            f"unit '{node.name}' fanned out to {len(child_outs)} children without AGGREGATE",
        )

    async def _get_output(self, node: Node, msg: SeldonMessage) -> SeldonMessage:
        unit = node.unit
        msg = msg.with_meta(msg.meta.merged_with(Meta(request_path={node.name: unit.image})))
        if _has_method(node, PredictiveUnitMethod.TRANSFORM_INPUT):
            out = await self._call(node, "transform_input", unit.transform_input, msg)
            msg = out.with_meta(msg.meta.merged_with(out.meta))
        if not node.children:
            return msg

        branch = ROUTE_ALL
        if _has_method(node, PredictiveUnitMethod.ROUTE):
            branch = await self._call(node, "route", unit.route, msg)
            if branch != ROUTE_ALL and not (0 <= branch < len(node.children)):
                raise APIException(
                    ErrorCode.ENGINE_INVALID_ROUTING,
                    f"unit '{node.name}' routed to {branch} with {len(node.children)} children",
                )
            msg = msg.with_meta(msg.meta.merged_with(Meta(routing={node.name: branch})))
        degraded = False
        if getattr(unit, "shadow_fanout", False):
            # serve the routed (primary) child; mirror a copy to every other
            # child, detached: a slow shadow must not hold the response
            primary = 0 if branch == ROUTE_ALL else branch
            mirrors = [
                (child.name, self._spawn_shadow(child, msg))
                for i, child in enumerate(node.children)
                if i != primary
            ]
            child_outputs = [await self._get_output(node.children[primary], msg)]
            for name, task in mirrors:
                self._attach_compare(name, task, child_outputs[0])
        elif branch != ROUTE_ALL:
            child_outputs = [await self._routed_walk(node, branch, msg)]
        elif len(node.children) == 1:
            child_outputs = [await self._get_output(node.children[0], msg)]
        else:
            child_outputs, degraded = await self._settle_quorum(
                node, [self._get_output(c, msg) for c in node.children]
            )

        merged_meta = msg.meta
        for co in child_outputs:
            merged_meta = merged_meta.merged_with(co.meta)
        if _has_method(node, PredictiveUnitMethod.AGGREGATE):
            out = await self._call(node, "aggregate", unit.aggregate, child_outputs)
        elif len(child_outputs) == 1:
            out = child_outputs[0]
        else:
            raise APIException(
                ErrorCode.ENGINE_INVALID_ROUTING,
                f"unit '{node.name}' fanned out to {len(child_outputs)} children without AGGREGATE",
            )
        msg = out.with_meta(merged_meta.merged_with(out.meta))
        if degraded:
            msg = msg.with_meta(msg.meta.merged_with(Meta(tags={DEGRADED_TAG: "quorum"})))
        if _has_method(node, PredictiveUnitMethod.TRANSFORM_OUTPUT):
            out = await self._call(node, "transform_output", unit.transform_output, msg)
            msg = out.with_meta(msg.meta.merged_with(out.meta))
        return msg

    # -------------------------------------------------------------- shadow
    @staticmethod
    def _shadow_copy(msg: SeldonMessage) -> SeldonMessage:
        """A copy of the payload for a mirror walk: a candidate that writes
        into its input must not corrupt what the primary serves from."""
        if msg.array is not None:
            arr = msg.array
            arr = arr.clone() if isinstance(arr, torch.Tensor) else np.array(arr)
            return msg.with_array(arr, msg.names)
        if msg.json_data is not None:
            return dataclasses.replace(msg, json_data=copy.deepcopy(msg.json_data))
        return msg  # bytes and str are immutable

    def _spawn_shadow(self, child: Node, payload) -> asyncio.Task:
        """Detached mirror walk of ``child`` (a message, or a list of them
        for the batched walk). It runs with no deadline (a slow candidate
        would read as a disagreement, not as latency) and outside the
        request's trace (which has shipped before it ends); a failure is
        logged and the task returns None."""
        if isinstance(payload, list):
            payload = [self._shadow_copy(m) for m in payload]
        else:
            payload = self._shadow_copy(payload)

        async def _run():
            DEADLINE.set(None)
            telemetry.clear()
            try:
                if isinstance(payload, list):
                    return await self._get_output_many(child, payload)
                return await self._get_output(child, payload)
            except Exception as e:  # noqa: BLE001 - a shadow's failure is data, not an error
                log.warning("shadow child '%s' failed: %s", child.name, e)
                return None

        task = asyncio.ensure_future(_run())
        self._shadow_tasks.add(task)
        task.add_done_callback(self._shadow_tasks.discard)
        return task

    @staticmethod
    def _outputs_agree(primary: SeldonMessage | None, shadow: SeldonMessage | None) -> bool:
        """Did the candidate make the primary's call? Classifier outputs
        compare by rowwise argmax, other tensors by allclose (rtol 1e-3,
        atol 1e-5), bytes, str and JSON by equality. A failed shadow (None)
        or another payload kind disagrees."""
        if primary is None or shadow is None:
            return False
        if primary.array is not None and shadow.array is not None:
            x, y = to_host(primary.array), to_host(shadow.array)
            if x.shape != y.shape:
                return False
            if x.ndim >= 2 and x.shape[-1] > 1:
                return bool(np.array_equal(np.argmax(x, -1), np.argmax(y, -1)))
            return bool(np.allclose(x, y, rtol=1e-3, atol=1e-5))
        if primary.array is not None or shadow.array is not None:
            return False
        return bool(
            primary.bin_data == shadow.bin_data
            and primary.str_data == shadow.str_data
            and primary.json_data == shadow.json_data
        )

    def _attach_compare(self, shadow_name: str, task: asyncio.Task, primary_out) -> None:
        """When the mirror finishes, compare it with the primary's (already
        served) output and report the verdict. ``primary_out``: a message,
        or in the batched walk a list aligned with the mirrored messages."""
        if self._shadow_hook is None:
            return

        def _done(t: asyncio.Task) -> None:
            if t.cancelled():
                return
            out = t.result()
            try:
                if isinstance(primary_out, list):
                    shadows = out if isinstance(out, list) else [None] * len(primary_out)
                    for p, s in zip(primary_out, shadows):
                        self._shadow_hook(shadow_name, self._outputs_agree(p, s))
                else:
                    self._shadow_hook(shadow_name, self._outputs_agree(primary_out, out))
            except Exception as e:  # noqa: BLE001 - metrics must not break serving
                log.warning("shadow comparison for '%s' failed: %s", shadow_name, e)

        task.add_done_callback(_done)

    async def drain_shadows(self) -> None:
        """Await the mirror walks in flight (tests, shutdown). The set is
        drained explicitly: a finished task's discard callback may still be
        queued, and a gather of done tasks does not yield."""
        while self._shadow_tasks:
            pending = list(self._shadow_tasks)
            await asyncio.gather(*pending, return_exceptions=True)
            self._shadow_tasks.difference_update(pending)
            await asyncio.sleep(0)  # let queued done-callbacks run
        # a comparison attached to an already finished mirror is still
        # queued: one more yield runs it
        await asyncio.sleep(0)

    # ------------------------------------------------------------ feedback
    async def send_feedback(self, feedback: Feedback) -> None:
        await self._send_feedback(self.root, feedback)

    async def _send_feedback(self, node: Node, feedback: Feedback) -> None:
        """Down the branch each router took for the response (its
        meta.routing), into every unit that takes SEND_FEEDBACK."""
        routing_map = {}
        if feedback.response is not None:
            routing_map = dict(feedback.response.meta.routing)
        branch = int(routing_map.get(node.name, ROUTE_ALL))
        if _has_method(node, PredictiveUnitMethod.SEND_FEEDBACK):
            await node.unit.send_feedback(feedback, branch)
            if self._feedback_hook is not None:
                self._feedback_hook(node.name, feedback.reward)
        if not node.children:
            return
        if branch == ROUTE_ALL:
            await _gather_settled(*(self._send_feedback(c, feedback) for c in node.children))
            return
        if not (0 <= branch < len(node.children)):
            raise APIException(
                ErrorCode.ENGINE_INVALID_ROUTING,
                f"feedback routing {branch} invalid for '{node.name}'",
            )
        await self._send_feedback(node.children[branch], feedback)

    def units(self):
        """All runtime units in the graph, pre-order (what a
        ``StatePersister`` attaches)."""
        return (n.unit for n in self.root.walk())

    def stateful_units(self) -> dict[str, Unit]:
        """Units with learnable state: those that override send_feedback."""
        return {
            n.name: n.unit
            for n in self.root.walk()
            if type(n.unit).send_feedback is not Unit.send_feedback
        }


def endpoint_key(spec: PredictiveUnit) -> str:
    """What a node's breaker is keyed by: ``host:port`` of its declared
    endpoint, else its name."""
    ep = spec.endpoint
    if ep is not None and ep.service_port:
        return f"{ep.service_host}:{ep.service_port}"
    return spec.name


def build_node(spec: PredictiveUnit, registry: UnitRegistry, context: dict[str, Any]) -> Node:
    """Resolve each spec unit to a runtime Unit, in order: an override in
    context['units'], the registry (JAX_MODEL), a container with a
    model_uri, a declared endpoint (``engine/remote.py::RemoteUnit``, REST
    or GRPC), a bare identity Unit."""
    overrides = context.get("units") or {}
    unit: Unit | None = overrides.get(spec.name)
    if unit is not None and not isinstance(unit, Unit):
        raise TypeError(f"override for unit '{spec.name}' must be a Unit, got {type(unit).__name__}")
    if unit is None:
        unit = registry.create(spec, context)
    container = (context.get("containers") or {}).get(spec.name)
    if unit is None and container is not None and container.model_uri:
        from seldon_core_tpu_torch.models.zoo import unit_from_container

        unit = unit_from_container(spec, container, context)
    if unit is None and spec.endpoint is not None and spec.endpoint.service_port:
        from seldon_core_tpu_torch.engine.remote import RemoteUnit

        unit = RemoteUnit(spec)
    if unit is None:
        unit = Unit(spec)
    if container is not None and container.image:
        unit.image = container.image
    children = [build_node(c, registry, context) for c in spec.children]
    return Node(spec=spec, unit=unit, children=children, policy=ResilienceSpec.for_unit(spec))


def build_executor(
    predictor: PredictorSpec,
    registry: UnitRegistry | None = None,
    context: dict[str, Any] | None = None,
    resilience_events: ResilienceEvents | None = None,
    unit_call_hook: Callable[[str, str, float], None] | None = None,
    feedback_metrics_hook: Callable[[str, float], None] | None = None,
    shadow_compare_hook: Callable[[str, bool], None] | None = None,
) -> GraphExecutor:
    """``context['device']`` names where models run (the card by default);
    ``context['mesh']`` (a ``parallel.mesh.Mesh``, or None) serves every
    model over a mesh's positions instead, and a fused island over its
    members' mesh; ``context['cuda_graphs']`` false builds every runtime as
    its eager twin.
    With ``tpu.fuse_graph`` (the default) pure subtrees collapse into one
    fused unit each (``engine/fused.py``), which keeps the resilience knobs
    of the subtree's root, as in the JAX package. ``resilience_events``
    receives every retry, breaker transition, deadline exhaustion and
    degradation (default: a sink that counts nothing); ``unit_call_hook``
    every unit-call attempt's (unit, method, seconds) and
    ``feedback_metrics_hook`` every (unit, reward) feedback reaches;
    ``shadow_compare_hook`` every (shadow unit, agree) a SHADOW router's
    mirror yields."""
    registry = registry or default_registry()
    context = dict(context or {})
    context.setdefault("containers", {c.name: c for c in predictor.componentSpec.containers})
    context.setdefault("tpu", predictor.tpu)
    root = build_node(predictor.graph, registry, context)
    tpu_cfg = context.get("tpu")
    if tpu_cfg is not None and getattr(tpu_cfg, "fuse_graph", True):
        from seldon_core_tpu_torch.engine.fused import fuse_graph

        root = fuse_graph(root, tpu_cfg, context.get("cuda_graphs", True))
    return GraphExecutor(
        root,
        resilience_events=resilience_events,
        unit_call_hook=unit_call_hook,
        feedback_metrics_hook=feedback_metrics_hook,
        shadow_compare_hook=shadow_compare_hook,
    )
