"""Tracer: the per-process owner of request traces (port of
``seldon_core_tpu/telemetry/tracer.py``).

One Tracer (usually the process-global one — ``get_tracer()``) owns the
SpanStore and the request-trace lifecycle: the serving entrypoints open the
ingress root span through it, the walk records spans via the contextvar
(telemetry/context.py), and on completion the buf is offered to the store's
tail sampler (+ optional OTLP file export).

Env config (names in utils/env.py):

    ENGINE_TELEMETRY=off            disable tracing entirely (A/B runs)
    ENGINE_TRACE_MAX_ERRORS=128     always-keep pool bound
    ENGINE_TRACE_SLOW_KEEP=32       slowest-N ok traces kept
    ENGINE_TRACE_MAX_SAMPLED=64     sampled-ok pool bound
    ENGINE_TRACE_SAMPLE_RATE=0.05   ok-trace sample probability
    ENGINE_OTLP_FILE=<path>         append retained traces as OTLP-JSON lines
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.telemetry.context import TRACE, TraceContext, parse_traceparent
from seldon_core_tpu_torch.telemetry.export import OtlpFileExporter
from seldon_core_tpu_torch.telemetry.spans import TraceBuf, new_trace_id
from seldon_core_tpu_torch.telemetry.store import SpanStore


class Tracer:
    def __init__(
        self,
        enabled: bool = True,
        store: SpanStore | None = None,
        otlp_path: str | None = None,
    ):
        self.enabled = enabled
        self.store = store or SpanStore()
        self._exporter = OtlpFileExporter(otlp_path) if otlp_path else None

    # ------------------------------------------------------------ lifecycle
    def begin_request(
        self,
        name: str,
        *,
        puid: str = "",
        parent: str | None = None,
        attrs: dict | None = None,
        force: bool = False,
    ):
        """Open a request's root span and install the trace context.
        Returns (buf, root_span, reset_token), or (None, None, None) when
        tracing is off and the request didn't force it. ``parent`` is an
        incoming traceparent header: the trace CONTINUES under the remote
        caller's span instead of starting fresh."""
        if not self.enabled and not force:
            return None, None, None
        parsed = parse_traceparent(parent)
        buf = TraceBuf(parsed[0] if parsed else new_trace_id(), puid=puid)
        root = buf.begin(name, parsed[1] if parsed else "", attrs)
        if force:
            buf.flags.add("forced")
        token = TRACE.set((TraceContext(buf, root),))
        return buf, root, token

    def finish_request(self, buf, root, token, error: BaseException | None = None):
        """Close the root span, classify the outcome for tail sampling, and
        offer the trace to the store."""
        if buf is None:
            return
        try:
            TRACE.reset(token)
        except ValueError:
            # reset from a different Context than the set (an async
            # generator finalized from another task): just clear
            TRACE.set(())
        root.end()
        if error is not None:
            root.error = True
            buf.flags.add("error")
            if (
                isinstance(error, APIException)
                and error.error is ErrorCode.REQUEST_DEADLINE_EXCEEDED
            ):
                buf.flags.add("deadline")
        retained = self.store.offer(buf)
        if retained and self._exporter is not None:
            rec = self.store.get(buf.trace_id)
            if rec is not None:
                self._exporter.export(rec)

    @contextmanager
    def request_trace(
        self,
        name: str,
        *,
        puid: str = "",
        parent: str | None = None,
        attrs: dict | None = None,
        force: bool = False,
    ) -> Iterator[TraceBuf | None]:
        buf, root, token = self.begin_request(
            name, puid=puid, parent=parent, attrs=attrs, force=force
        )
        try:
            yield buf
        except BaseException as e:
            self.finish_request(buf, root, token, error=e)
            raise
        else:
            self.finish_request(buf, root, token)


# ------------------------------------------------------------- global tracer

_GLOBAL: Tracer | None = None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def tracer_from_env() -> Tracer:
    from seldon_core_tpu_torch.utils import env as envmod

    enabled = os.environ.get(envmod.ENGINE_TELEMETRY, "on").strip().lower() not in (
        "off",
        "0",
        "false",
    )
    store = SpanStore(
        max_errors=_env_int(envmod.ENGINE_TRACE_MAX_ERRORS, 128),
        slow_keep=_env_int(envmod.ENGINE_TRACE_SLOW_KEEP, 32),
        max_sampled=_env_int(envmod.ENGINE_TRACE_MAX_SAMPLED, 64),
        sample_rate=_env_float(envmod.ENGINE_TRACE_SAMPLE_RATE, 0.05),
    )
    return Tracer(
        enabled=enabled,
        store=store,
        otlp_path=os.environ.get(envmod.ENGINE_OTLP_FILE) or None,
    )


def get_tracer() -> Tracer:
    """The process-global tracer (lazily built from env). Every
    PredictionService in the process shares it, so
    GET /traces sees all deployments."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = tracer_from_env()
    return _GLOBAL


def configure(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests; embedding)."""
    global _GLOBAL
    _GLOBAL = tracer
    return tracer
