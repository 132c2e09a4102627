"""PredictionService: request-level orchestration above the executor.

Port of ``seldon_core_tpu/serving/service.py::PredictionService``
(``predict`` and ``send_feedback``, without tracing or metrics): decode an
npy payload to the tensor arm, assign a puid when the request has none, run
the request through the micro-batcher (or straight through the executor),
return the response under the request's puid and, for an npy request, as
npy (``mirror_npy_kind``). Feedback walks the graph along the routing the
response recorded.
"""

from __future__ import annotations

from seldon_core_tpu_torch.core.codec_npy import array_from_npy, is_npy, npy_from_array
from seldon_core_tpu_torch.core.message import Feedback, Meta, SeldonMessage
from seldon_core_tpu_torch.core.puid import new_puid
from seldon_core_tpu_torch.engine.executor import GraphExecutor
from seldon_core_tpu_torch.serving.batcher import MicroBatcher


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


class PredictionService:
    def __init__(
        self,
        executor: GraphExecutor,
        *,
        deployment_name: str = "",
        predictor_name: str = "",
        batcher: MicroBatcher | None = None,
    ):
        self.executor = executor
        self.deployment_name = deployment_name
        self.predictor_name = predictor_name
        self.batcher = batcher

    async def predict(self, msg: SeldonMessage, *, wire_npy: bool = False) -> SeldonMessage:
        """``wire_npy``: the transport saw an explicit application/x-npy
        body. Other binData is decoded when it starts with the npy magic,
        else passed through opaque."""
        npy_requested = wire_npy or is_npy(msg.bin_data)
        if npy_requested:
            msg = SeldonMessage.from_array(array_from_npy(msg.bin_data), meta=msg.meta)
        if not msg.meta.puid:
            msg = _with_puid(msg, new_puid())
        if self.batcher is not None:
            out = await self.batcher.submit(msg)
        else:
            out = await self.executor.execute(msg)
        if out.meta.puid != msg.meta.puid:
            out = _with_puid(out, msg.meta.puid)
        if npy_requested:
            out = mirror_npy_kind(out)
        return out

    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        await self.executor.send_feedback(feedback)
        return SeldonMessage(meta=Meta(puid=new_puid()))
