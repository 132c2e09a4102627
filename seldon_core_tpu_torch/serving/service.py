"""PredictionService: request-level orchestration above the executor.

Port of ``seldon_core_tpu/serving/service.py::PredictionService``
(``predict``, ``predict_stream`` and ``send_feedback``): decode an npy
payload to the tensor arm, assign a puid when the request has none, open
the request's ingress root span (continuing an incoming W3C
``traceparent``; a request tagged ``trace`` is kept whatever the sampling
and gets its unit spans back in ``meta.tags["trace"]``), run
the request through the micro-batcher (or straight through the executor)
under its deadline budget, return the response under the request's puid
and, for an npy request, as npy (``mirror_npy_kind``). The budget is
``tpu.deadline_ms``, tightened but never widened by ``meta.tags
["deadline_ms"]``: stamped into ``DEADLINE`` for every node call and
enforced here, where exhaustion cancels the walk and answers 504 (code 304). Feedback walks the graph along the routing the
response recorded. ``predict_stream`` streams a generative predictor's
tokens as they are chosen. Every request lands in the ingress histogram
with its trace id as exemplar (a failure in the error counter instead, at
the wire), and, under ``ENGINE_ACCESS_LOG=json``, in the access log.

With a replicated decode tier (``serving/affinity_router.py``), a reply's
per-row SLO verdicts reward the arms that served it automatically, a
client's feedback reaches them through ``meta.tags.replica``, and the
operator routes read and drain the fleet (``decode_fleet_status``,
``drain_decode_replica``).
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.codec_npy import array_from_npy, is_npy, npy_from_array
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.core.puid import new_puid
from seldon_core_tpu_torch.engine.executor import DEGRADED_TAG, GraphExecutor
from seldon_core_tpu_torch.engine.resilience import DEADLINE, Deadline
from seldon_core_tpu_torch.metrics import NullMetrics
from seldon_core_tpu_torch.serving.batcher import MicroBatcher
from seldon_core_tpu_torch.telemetry import get_tracer
from seldon_core_tpu_torch.telemetry.access_log import enabled as access_log_enabled
from seldon_core_tpu_torch.telemetry.access_log import log_request

log = logging.getLogger(__name__)


def _with_puid(msg: SeldonMessage, puid: str) -> SeldonMessage:
    m = msg.meta
    return msg.with_meta(
        Meta(
            puid=puid,
            tags=dict(m.tags),
            routing=dict(m.routing),
            request_path=dict(m.request_path),
        )
    )


def mirror_npy_kind(out: SeldonMessage) -> SeldonMessage:
    """Re-encode a tensor response as npy binData (the response mirrors an
    npy request's kind). Class names ride a tag, but only when there are at
    most 64 of them: a 1000-class model's names would dwarf the payload and
    overflow HTTP header limits on the raw path. Non-tensor responses pass
    through unchanged."""
    if out.data is None:
        return out
    tags = dict(out.meta.tags)
    if out.names and len(out.names) <= 64:
        tags["names"] = list(out.names)
    return SeldonMessage(
        bin_data=npy_from_array(out.array),
        meta=Meta(
            puid=out.meta.puid,
            tags=tags,
            routing=dict(out.meta.routing),
            request_path=dict(out.meta.request_path),
        ),
        status=out.status,
    )


def _batch_rows(msg: SeldonMessage) -> int:
    """Request batch size for the access log (tensor leading dim, else 1)."""
    arr = msg.array
    if arr is not None and getattr(arr, "shape", ()):
        return int(arr.shape[0])
    return 1


def _gen_log_fields(out: "SeldonMessage | None") -> tuple[int, str]:
    """The access log's generative fields from the response tags the
    decode scheduler stamped: (generated tokens, SLO verdict — "breached"
    if any row breached, "" when the tier did not judge)."""
    if out is None:
        return 0, ""
    tokens = 0
    gl = out.meta.tags.get("gen_lens")
    if isinstance(gl, (list, tuple)):
        try:
            tokens = int(sum(int(x) for x in gl))
        except (TypeError, ValueError):
            tokens = 0
    slo = ""
    sl = out.meta.tags.get("slo")
    if isinstance(sl, (list, tuple)) and sl:
        slo = "breached" if any(x == "breached" for x in sl) else "met"
    return tokens, slo


class PredictionService:
    def __init__(
        self,
        executor: GraphExecutor,
        *,
        deployment_name: str = "",
        predictor_name: str = "",
        batcher: MicroBatcher | None = None,
        decode_scheduler=None,
        deadline_ms: float = 0.0,
        metrics: NullMetrics | None = None,
        tracer=None,
        decode_npy: bool = True,
        mesh_attrs: dict | None = None,
    ):
        self.executor = executor
        self.deployment_name = deployment_name
        self.predictor_name = predictor_name
        self.batcher = batcher
        self.metrics = metrics or NullMetrics()
        # the process-global tracer by default: every deployment's traces
        # land in one store behind GET /traces
        self.tracer = tracer or get_tracer()
        self.decode_scheduler = decode_scheduler
        # per-request deadline budget (tpu.deadline_ms); 0 = none
        self.deadline_ms = deadline_ms
        # tpu.decode_npy_bindata: False keeps every binData opaque, for
        # bytes-contract graphs whose payloads could start with the npy magic
        self.decode_npy = decode_npy
        # a predictor served over a mesh: its axes, positions and distinct
        # devices ride every ingress span (Mesh.describe)
        self.mesh_attrs = dict(mesh_attrs or {})
        # a graph holding a router that consumes SLO feedback (the
        # PREFIX_AFFINITY built-in) gets each response's meta.tags.slo
        # verdicts back as a reward, with no client change
        self._slo_feedback_graph = any(getattr(n.unit, "consumes_slo_feedback", False)
                                       for n in executor.root.walk())

    def _request_deadline(self, msg: SeldonMessage) -> Deadline | None:
        """The request's budget: the deployment's, tightened (never widened)
        by a positive meta.tags["deadline_ms"]. None when neither is set."""
        budget_ms = float(self.deadline_ms or 0.0)
        tag = msg.meta.tags.get("deadline_ms")
        if tag is not None:
            try:
                req_ms = float(tag)
            except (TypeError, ValueError):
                req_ms = 0.0
            if req_ms > 0:
                budget_ms = min(budget_ms, req_ms) if budget_ms > 0 else req_ms
        return Deadline(budget_ms / 1000.0) if budget_ms > 0 else None

    async def _execute_with_deadline(self, msg: SeldonMessage) -> SeldonMessage:
        """Run the walk under the request's budget: stamped into DEADLINE
        (every node call checks what remains) and enforced with wait_for,
        whose cancellation unwinds the whole walk (siblings settle first)."""
        run = self.batcher.submit(msg) if self.batcher is not None else self.executor.execute(msg)
        deadline = self._request_deadline(msg)
        if deadline is None:
            return await run
        token = DEADLINE.set(deadline)
        try:
            return await asyncio.wait_for(run, timeout=max(deadline.remaining(), 0.0))
        except asyncio.TimeoutError:
            self.metrics.deadline_exceeded(self.deployment_name, "ingress")
            raise APIException(
                ErrorCode.REQUEST_DEADLINE_EXCEEDED,
                "request exceeded its deadline budget at the ingress",
            ) from None
        finally:
            DEADLINE.reset(token)

    def _prepare(self, msg: SeldonMessage, wire_npy: bool) -> tuple[SeldonMessage, bool]:
        """Decode an npy payload to the tensor arm and assign a puid; returns
        the message and whether the request was npy. An explicit
        application/x-npy body (``wire_npy``) is decoded even with sniffing
        off."""
        npy_requested = wire_npy or (self.decode_npy and is_npy(msg.bin_data))
        if npy_requested:
            msg = SeldonMessage.from_array(array_from_npy(msg.bin_data), meta=msg.meta)
        if not msg.meta.puid:
            msg = _with_puid(msg, new_puid())
        return msg, npy_requested

    def _trace_attrs(self, method: str) -> dict:
        return {"deployment": self.deployment_name, "predictor": self.predictor_name, "method": method,
                **self.mesh_attrs}

    async def predict(
        self, msg: SeldonMessage, *, wire_npy: bool = False, traceparent: str | None = None
    ) -> SeldonMessage:
        """``wire_npy``: the transport saw an explicit application/x-npy
        body. Other binData is decoded when it starts with the npy magic
        and ``decode_npy`` is on, else passed through opaque. ``traceparent``: the caller's W3C trace
        header, whose trace this request's spans continue."""
        start = time.perf_counter()
        msg, npy_requested = self._prepare(msg, wire_npy)
        buf = None
        status = 200
        degraded = ""
        out = None
        try:
            with self.tracer.request_trace(
                "ingress",
                puid=msg.meta.puid,
                parent=traceparent,
                attrs=self._trace_attrs("predict"),
                force="trace" in msg.meta.tags,
            ) as buf:
                out = await self._execute_with_deadline(msg)
                degraded = str(out.meta.tags.get(DEGRADED_TAG) or "")
                if buf is not None and degraded:
                    buf.flags.add("degraded")
        except APIException as e:
            status = e.error.http_status
            raise
        except BaseException:
            status = 500
            raise
        finally:
            if access_log_enabled():
                tokens, slo = _gen_log_fields(out)
                log_request(
                    deployment=self.deployment_name,
                    method="predict",
                    puid=msg.meta.puid,
                    trace_id=buf.trace_id if buf is not None else "",
                    status=status,
                    duration_ms=(time.perf_counter() - start) * 1e3,
                    batch=_batch_rows(msg),
                    degraded=degraded,
                    retries=buf.event_count("retry") if buf is not None else 0,
                    tokens=tokens,
                    slo=slo,
                )
        if buf is not None and "trace" in msg.meta.tags:
            # the opt-in contract: per-unit timings ride back in
            # tags["trace"]; the whole tree is GET /traces/{puid}
            out = out.with_meta(out.meta.merged_with(Meta(tags={"trace": buf.tag_spans()})))
        if out.meta.puid != msg.meta.puid:
            out = _with_puid(out, msg.meta.puid)
        self._maybe_slo_feedback(out)
        if npy_requested:
            out = mirror_npy_kind(out)
        self.metrics.ingress_request(
            self.deployment_name,
            "predict",
            time.perf_counter() - start,
            trace_id=buf.trace_id if buf is not None else None,
        )
        return out

    def _maybe_slo_feedback(self, out: SeldonMessage) -> None:
        """Close the reward loop with no client call: a response whose rows
        carry ``meta.tags.slo`` verdicts rewards the replicated decode
        tier's arms through its ``meta.tags.replica`` (each row by its own
        verdict), and a graph router that consumes SLO feedback with the
        met fraction, sent down the Feedback path without the caller
        waiting for it."""
        slo = out.meta.tags.get("slo")
        if not isinstance(slo, (list, tuple)) or not slo:
            return
        sched = self.decode_scheduler
        if sched is not None and hasattr(sched, "ingest_feedback") and "replica" in out.meta.tags:
            try:
                sched.ingest_feedback(Feedback(response=out), use_slo=True)
            except Exception:  # noqa: BLE001 - rewards must not fail serving
                log.exception("automatic SLO feedback (replica arms) failed")
        if self._slo_feedback_graph:
            met = sum(1.0 for v in slo if v == "met") / len(slo)
            task = asyncio.ensure_future(self.executor.send_feedback(Feedback(response=out, reward=met)))
            task.add_done_callback(
                lambda t: t.cancelled()
                or (t.exception() and log.warning("automatic SLO feedback failed: %s", t.exception()))
            )

    def decode_fleet_status(self) -> dict | None:
        """The ``GET /decode/fleet`` body: each arm's lifecycle state and the
        fleet's lifecycle counters; None without a replicated decode tier."""
        sched = self.decode_scheduler
        if sched is None or not hasattr(sched, "replica_states"):
            return None
        states = sched.replica_states()
        return {
            "replicas": [{"replica": i, "state": s} for i, s in enumerate(states)],
            "serving": sum(1 for s in states if s == "up"),
            "evictions": sched.stat_evictions,
            "recoveries": sched.stat_recoveries,
            "drains": sched.stat_drains,
            "migrations": sched.stat_migrations,
            "health_misses": sched.stat_health_misses,
        }

    async def drain_decode_replica(self, replica: int | None = None) -> dict:
        """The ``POST /decode/drain`` action: drain the named arm, or the
        coldest serving one. APIException without a replicated decode tier
        and for an arm that cannot drain (the last serving one, unknown or
        down)."""
        sched = self.decode_scheduler
        if sched is None or not hasattr(sched, "drain_replica"):
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, "deployment has no replicated decode tier to drain")
        try:
            if replica is None:
                return await sched.scale_down()
            return await sched.drain_replica(int(replica))
        except ValueError as e:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, str(e)) from e

    async def predict_stream(
        self, msg: SeldonMessage, *, wire_npy: bool = False, traceparent: str | None = None
    ):
        """Per-token streaming predict: an async generator of events
            {"row": r, "index": i, "token": t}   per generated token
            {"done": true, "ids": [[...]], "gen_lens": [...], "puid": ...}
        the last. Without a decode scheduler the one event is the buffered
        predict()'s answer. The ingress span stays open for the stream's
        life; the scheduler hangs each row's spans under it."""
        start = time.perf_counter()
        msg, _ = self._prepare(msg, wire_npy)
        puid = msg.meta.puid
        sched = self.decode_scheduler
        if sched is None:
            out = await self.predict(msg, traceparent=traceparent)
            arr = out.array
            ev = {
                "done": True,
                "ids": np.atleast_2d(np.asarray(arr)).astype(int).tolist() if arr is not None else [],
                "puid": puid,
            }
            if "gen_lens" in out.meta.tags:
                ev["gen_lens"] = out.meta.tags["gen_lens"]
            yield ev
            return
        if msg.array is None:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, "streaming predict needs tensor token ids")
        rows = np.atleast_2d(np.asarray(msg.array)).astype(np.int32)
        overrides = sched.request_params_from_meta(msg.meta)
        # the scheduler picks the trace context up at submit
        buf, troot, ttoken = self.tracer.begin_request(
            "ingress", puid=puid, parent=traceparent, attrs=self._trace_attrs("predict_stream"),
            force="trace" in msg.meta.tags,
        )
        trace_err: BaseException | None = None
        queue: asyncio.Queue = asyncio.Queue()

        def on_token(row: int):
            def cb(tok: int, index: int) -> None:
                queue.put_nowait({"row": row, "index": index, "token": tok})

            return cb

        async def run_all():
            try:
                # settle every row before failing the stream
                outs = await asyncio.gather(
                    *(sched.submit(row, **overrides, on_token=on_token(i)) for i, row in enumerate(rows)),
                    return_exceptions=True,
                )
                for o in outs:
                    if isinstance(o, BaseException):
                        raise o
                queue.put_nowait(("done", outs))
            except Exception as e:  # noqa: BLE001 - surfaced as a stream event
                queue.put_nowait(("error", e))

        runner = asyncio.ensure_future(run_all())
        try:
            while True:
                ev = await queue.get()
                if isinstance(ev, dict):
                    yield ev
                    continue
                kind, payload = ev
                if kind == "error":
                    raise payload
                yield {
                    "done": True,
                    "ids": [o.tolist() for o in payload],
                    "gen_lens": [len(o) - rows.shape[1] for o in payload],
                    "puid": puid,
                }
                break
        except BaseException as e:
            trace_err = e
            raise
        finally:
            # a closed stream cancels its rows' generations
            runner.cancel()
            self.tracer.finish_request(buf, troot, ttoken, error=trace_err)
            status = 200
            if isinstance(trace_err, APIException):
                status = trace_err.error.http_status
            elif trace_err is not None:
                status = 500
            if access_log_enabled():
                log_request(
                    deployment=self.deployment_name,
                    method="predict_stream",
                    puid=puid,
                    trace_id=buf.trace_id if buf is not None else "",
                    status=status,
                    duration_ms=(time.perf_counter() - start) * 1e3,
                    batch=int(rows.shape[0]),
                )
            self.metrics.ingress_request(
                self.deployment_name,
                "predict_stream",
                time.perf_counter() - start,
                trace_id=buf.trace_id if buf is not None else None,
            )

    async def send_feedback(self, feedback: Feedback, *, traceparent: str | None = None) -> SeldonMessage:
        start = time.perf_counter()
        puid = feedback.response.meta.puid if feedback.response is not None else ""
        buf = None
        status = 200
        try:
            with self.tracer.request_trace(
                "ingress", puid=puid, parent=traceparent, attrs=self._trace_attrs("feedback")
            ) as buf:
                await self.executor.send_feedback(feedback)
                # a response the replicated decode tier served names its
                # arms in meta.tags.replica: the client's reward reaches them
                sched = self.decode_scheduler
                if sched is not None and hasattr(sched, "ingest_feedback"):
                    sched.ingest_feedback(feedback)
        except APIException as e:
            status = e.error.http_status
            raise
        except BaseException:
            status = 500
            raise
        finally:
            if access_log_enabled():
                log_request(
                    deployment=self.deployment_name,
                    method="feedback",
                    puid=puid,
                    trace_id=buf.trace_id if buf is not None else "",
                    status=status,
                    duration_ms=(time.perf_counter() - start) * 1e3,
                )
        self.metrics.ingress_request(
            self.deployment_name,
            "feedback",
            time.perf_counter() - start,
            trace_id=buf.trace_id if buf is not None else None,
        )
        return SeldonMessage(meta=Meta(puid=new_puid()))
