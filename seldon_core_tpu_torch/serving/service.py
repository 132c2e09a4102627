"""PredictionService: request-level orchestration above the executor.

Port of ``seldon_core_tpu/serving/service.py::PredictionService.predict``:
assign a puid when the request has none, run the request through the
micro-batcher (or straight through the executor), and return the response
under the request's puid.
"""

from __future__ import annotations

from seldon_core_tpu_torch.core.message import Meta, SeldonMessage
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

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if not msg.meta.puid:
            msg = _with_puid(msg, new_puid())
        if self.batcher is not None:
            out = await self.batcher.submit(msg)
        else:
            out = await self.executor.execute(msg)
        if out.meta.puid != msg.meta.puid:
            out = _with_puid(out, msg.meta.puid)
        return out
