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
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.core.tensor import to_host
from seldon_core_tpu_torch.engine.units import ROUTE_ALL, Unit, UnitRegistry, default_registry
from seldon_core_tpu_torch.graph.spec import (
    TYPE_METHODS,
    PredictiveUnit,
    PredictiveUnitMethod,
    PredictorSpec,
)


@dataclasses.dataclass
class Node:
    """Runtime tree node."""

    spec: PredictiveUnit
    unit: Unit
    children: list["Node"]

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

    def __init__(self, root: Node):
        self.root = root

    def ready(self) -> bool:
        return all(n.unit.ready() for n in self.root.walk())

    # ------------------------------------------------------------- predict
    async def execute(self, msg: SeldonMessage) -> SeldonMessage:
        out = await self._get_output(self.root, msg)
        return await self._settle_to_host(out)

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

    async def _merged_call(self, fn, msgs):
        out = await fn(self._merge_rows(msgs))
        out = await self._settle_to_host(out)
        return self._scatter_rows(msgs, out)

    async def _get_output_many(
        self, node: Node, msgs: list[SeldonMessage]
    ) -> list[SeldonMessage]:
        unit = node.unit
        msgs = [
            m.with_meta(m.meta.merged_with(Meta(request_path={node.name: unit.image})))
            for m in msgs
        ]
        if _has_method(node, PredictiveUnitMethod.TRANSFORM_INPUT):
            msgs = await self._merged_call(unit.transform_input, msgs)
        if not node.children:
            return msgs

        if _has_method(node, PredictiveUnitMethod.ROUTE):
            branches = []
            for m in msgs:
                b = await unit.route(m)
                if b != ROUTE_ALL and not (0 <= b < len(node.children)):
                    raise APIException(
                        ErrorCode.ENGINE_INVALID_ROUTING,
                        f"unit '{node.name}' routed to {b} with {len(node.children)} children",
                    )
                branches.append(b)
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
                return idxs, await self._get_output_many(node.children[b], sub)

            results: list[Any] = [None] * len(msgs)
            for idxs, outs in await _gather_settled(
                *(_run_group(b, idxs) for b, idxs in groups.items())
            ):
                for i, o in zip(idxs, outs):
                    results[i] = o
            out_msgs = results
        else:
            out_msgs = await self._fanout_many(node, msgs)

        if _has_method(node, PredictiveUnitMethod.TRANSFORM_OUTPUT):
            out_msgs = await self._merged_call(unit.transform_output, out_msgs)
        return out_msgs

    async def _fanout_many(
        self, node: Node, msgs: list[SeldonMessage]
    ) -> list[SeldonMessage]:
        """All-children fan-out for a batch: each child walks the whole
        batch, then AGGREGATE runs once on the row-aligned child outputs."""
        unit = node.unit
        child_outs = await _gather_settled(
            *(self._get_output_many(c, msgs) for c in node.children)
        )
        if _has_method(node, PredictiveUnitMethod.AGGREGATE):
            merged_children = [self._merge_rows(co) for co in child_outs]
            out = await self._settle_to_host(await unit.aggregate(merged_children))
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
            out = await unit.transform_input(msg)
            msg = out.with_meta(msg.meta.merged_with(out.meta))
        if not node.children:
            return msg

        branch = ROUTE_ALL
        if _has_method(node, PredictiveUnitMethod.ROUTE):
            branch = await unit.route(msg)
            if branch != ROUTE_ALL and not (0 <= branch < len(node.children)):
                raise APIException(
                    ErrorCode.ENGINE_INVALID_ROUTING,
                    f"unit '{node.name}' routed to {branch} with {len(node.children)} children",
                )
            msg = msg.with_meta(msg.meta.merged_with(Meta(routing={node.name: branch})))
        targets = node.children if branch == ROUTE_ALL else [node.children[branch]]
        child_outputs = await _gather_settled(*(self._get_output(c, msg) for c in targets))

        merged_meta = msg.meta
        for co in child_outputs:
            merged_meta = merged_meta.merged_with(co.meta)
        if _has_method(node, PredictiveUnitMethod.AGGREGATE):
            out = await unit.aggregate(child_outputs)
        elif len(child_outputs) == 1:
            out = child_outputs[0]
        else:
            raise APIException(
                ErrorCode.ENGINE_INVALID_ROUTING,
                f"unit '{node.name}' fanned out to {len(child_outputs)} children without AGGREGATE",
            )
        msg = out.with_meta(merged_meta.merged_with(out.meta))
        if _has_method(node, PredictiveUnitMethod.TRANSFORM_OUTPUT):
            out = await unit.transform_output(msg)
            msg = out.with_meta(msg.meta.merged_with(out.meta))
        return msg

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

    def stateful_units(self) -> dict[str, Unit]:
        """Units with learnable state: those that override send_feedback."""
        return {
            n.name: n.unit
            for n in self.root.walk()
            if type(n.unit).send_feedback is not Unit.send_feedback
        }


def build_node(spec: PredictiveUnit, registry: UnitRegistry, context: dict[str, Any]) -> Node:
    """Resolve each spec unit to a runtime Unit, in order: an override in
    context['units'], the registry (JAX_MODEL), a container with a
    model_uri, a bare identity Unit. A unit reachable only over a network
    endpoint is refused: remote units are not part of this port."""
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
        raise ValueError(
            f"unit '{spec.name}' is served at a network endpoint; remote units "
            "are not supported by the torch port"
        )
    if unit is None:
        unit = Unit(spec)
    if container is not None and container.image:
        unit.image = container.image
    children = [build_node(c, registry, context) for c in spec.children]
    return Node(spec=spec, unit=unit, children=children)


def build_executor(
    predictor: PredictorSpec,
    registry: UnitRegistry | None = None,
    context: dict[str, Any] | None = None,
) -> GraphExecutor:
    """``context['device']`` names where models run (the card by default).
    With ``tpu.fuse_graph`` (the default) pure subtrees collapse into one
    fused unit each (``engine/fused.py``)."""
    registry = registry or default_registry()
    context = dict(context or {})
    context.setdefault("containers", {c.name: c for c in predictor.componentSpec.containers})
    context.setdefault("tpu", predictor.tpu)
    root = build_node(predictor.graph, registry, context)
    tpu_cfg = context.get("tpu")
    if tpu_cfg is not None and getattr(tpu_cfg, "fuse_graph", True):
        from seldon_core_tpu_torch.engine.fused import fuse_graph

        root = fuse_graph(root, tpu_cfg)
    return GraphExecutor(root)
