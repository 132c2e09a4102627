"""Model runtime: parameters resident on the device, shape buckets.

Port of ``seldon_core_tpu/models/base.py`` (``ModelRuntime`` and the MODEL
graph unit). A runtime places a model's parameters on one ``torch.device``
once, pads every request to a batch bucket on the host (so the forward runs
at a few fixed batch sizes, the counterpart of one compiled program per
bucket), and splits batches above the largest bucket into bucket-sized
chunks. Wire-dtype policy: token ids (``int_inputs="ids"``) stay int32 end
to end — never through bfloat16, which corrupts every id from 257 up; a
uint8 batch of an image-shaped value model (the binary image wire) goes to
the device as uint8, a quarter of float32's bytes, and is cast there;
floating outputs are cast to float32 on the device before readback (numpy
has no bfloat16).
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage
from seldon_core_tpu_torch.core.tensor import (
    bucket_for,
    default_buckets,
    pad_batch,
    resolve_device,
    to_device,
    to_host,
)
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph.spec import PredictiveUnit
from seldon_core_tpu_torch.models.convert import params_to_torch

# forwards at or above this stall the serving loop enough to tax other
# requests' latency; offload_compute="auto" moves them to the compute pool
OFFLOAD_MIN_FORWARD_MS = 3.0

COMPUTE_POOL_WORKERS = 2
_COMPUTE_POOL: ThreadPoolExecutor | None = None
_COMPUTE_POOL_LOCK = threading.Lock()


def compute_pool() -> ThreadPoolExecutor:
    """Shared worker pool for offloaded forwards and device readbacks. Small
    on purpose: it exists to keep the event loop free, not for throughput
    (torch releases the GIL inside its kernels and while it waits on the
    card)."""
    global _COMPUTE_POOL
    if _COMPUTE_POOL is None:
        with _COMPUTE_POOL_LOCK:
            if _COMPUTE_POOL is None:
                _COMPUTE_POOL = ThreadPoolExecutor(
                    max_workers=COMPUTE_POOL_WORKERS, thread_name_prefix="seldon-compute"
                )
    return _COMPUTE_POOL


ApplyFn = Callable[[Any, torch.Tensor], torch.Tensor]


class ModelRuntime:
    """One model loaded onto one device.

    ``apply_fn(params, x[batch, ...]) -> y[batch, ...]`` takes the parameter
    tree (tensors on ``device``) and a batch tensor on ``device``."""

    def __init__(
        self,
        apply_fn: ApplyFn,
        params: Any,
        *,
        device: Any = None,
        buckets: Sequence[int] = (),
        max_batch: int = 64,
        dtype: torch.dtype = torch.float32,
        class_names: Sequence[str] = (),
        int_inputs: str = "cast",
        offload_compute: str = "auto",
        layout: Callable[[np.ndarray], Any] | None = None,
    ):
        if int_inputs not in ("cast", "ids"):
            raise ValueError(f"int_inputs must be 'cast' or 'ids', got {int_inputs!r}")
        if offload_compute not in ("auto", "always", "never"):
            raise ValueError(
                "offload_compute must be 'auto', 'always' or 'never', got "
                f"{offload_compute!r}"
            )
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.dtype = dtype
        # "cast": integer payloads are values and normalize to float;
        # "ids": integers are token ids and stay exact int32
        self.int_inputs = int_inputs
        self.class_names = tuple(class_names)
        self.buckets = tuple(buckets) if buckets else default_buckets(max_batch)
        # "auto" resolves at warmup() from a measured forward; until then
        # only "always" offloads
        self.offload_compute_mode = offload_compute
        self.offload_compute = offload_compute == "always"
        self.stat_forward_ms: float | None = None
        self.feature_shape: tuple[int, ...] | None = None
        self._low_precision = torch.finfo(dtype).bits < 32
        self.params = params_to_torch(params, self.device, dtype, layout)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if x.dtype == torch.uint8 or (self._low_precision and x.dtype == torch.float32):
                x = x.to(self.dtype)
            y = self.apply_fn(self.params, x)
            if self._low_precision and y.is_floating_point():
                y = y.float()
        return y

    # -------------------------------------------------------------- predict
    def predict(self, x) -> np.ndarray:
        """Host-in host-out batched predict with bucket padding."""
        return to_host(self.predict_device(x))

    def predict_device(self, x) -> torch.Tensor:
        """Like predict but leaves the result on the device."""
        x = to_host(x)
        # every wire form maps onto the input dtypes warmup ran: int32 ids
        # (the JSON wire's float32 holds every id < 2^24 exactly), uint8
        # images, or float32 values (both cast to the model dtype on the
        # device)
        if self.int_inputs == "ids":
            x = np.asarray(x, dtype=np.int32)
        elif not (x.dtype == np.uint8 and self._uint8_wire()):
            x = np.asarray(x, dtype=np.float32)
        n = x.shape[0]
        bucket = bucket_for(n, self.buckets)
        if bucket is None:
            step = self.buckets[-1]
            return torch.cat(
                [self.predict_device(x[i : i + step]) for i in range(0, n, step)], dim=0
            )
        padded, valid = pad_batch(x, bucket)
        y = self._forward(to_device(padded, self.device))
        return y if valid == bucket else y[:valid]

    def _uint8_wire(self) -> bool:
        """uint8 rides to the device raw only for image-shaped value models
        (rank >= 2 features): exactly the signatures warmup runs."""
        shape = self.feature_shape
        return self.int_inputs == "cast" and shape is not None and len(tuple(shape)) >= 2

    def warmup(self) -> None:
        """One forward per bucket and wire dtype ahead of traffic, then
        resolve offload_compute="auto" from the largest bucket's measured
        time. A runtime that offloads to the compute pool on the card also
        runs one forward on each pool thread: PyTorch builds cuDNN and
        cuBLAS handles per thread, and without it the first ResNet50
        ensemble request took 156 ms against 28 ms for the next (H100,
        chip_smoke.py)."""
        if self.feature_shape is None:
            raise ValueError("set runtime.feature_shape before warmup()")
        if self.int_inputs == "ids":
            wires = [np.int32]
        else:
            wires = [np.float32, np.uint8] if self._uint8_wire() else [np.float32]
        for b in self.buckets:
            for wire in wires:
                self.predict(np.zeros((b, *self.feature_shape), dtype=wire))
        if self.offload_compute_mode == "auto":
            x = np.zeros((max(self.buckets), *self.feature_shape), dtype=wires[0])
            self.stat_forward_ms = self._measure_forward_ms(x)
            self.offload_compute = self.stat_forward_ms >= OFFLOAD_MIN_FORWARD_MS
        if self.offload_compute and self.device.type == "cuda":
            self._warm_pool_threads(np.zeros((self.buckets[0], *self.feature_shape), dtype=wires[0]))

    def _warm_pool_threads(self, x: np.ndarray) -> None:
        """One forward on every compute-pool thread: a barrier holds each
        task until all have started, so no thread takes two."""
        barrier = threading.Barrier(COMPUTE_POOL_WORKERS)

        def run():
            barrier.wait(timeout=60)
            self.predict(x)

        for f in [compute_pool().submit(run) for _ in range(COMPUTE_POOL_WORKERS)]:
            f.result()

    def _measure_forward_ms(self, x: np.ndarray, runs: int = 3) -> float:
        """Median forward time including readback, which waits for the
        device — the stall one forward would put on the serving loop."""
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            self.predict(x)
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] * 1e3


class ModelUnit(Unit):
    """Graph MODEL unit backed by a ModelRuntime (counterpart of
    ``JaxModelUnit``)."""

    def __init__(self, spec: PredictiveUnit, runtime: ModelRuntime):
        super().__init__(spec)
        self.runtime = runtime

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if msg.data is None:
            raise APIException(
                ErrorCode.ENGINE_INVALID_JSON,
                f"MODEL node '{self.spec.name}' needs tensor data; opaque "
                "binData/strData is not a tensor",
            )
        x = msg.array
        if self.runtime.offload_compute:
            y = await asyncio.get_running_loop().run_in_executor(
                compute_pool(), self.runtime.predict_device, x
            )
        else:
            y = self.runtime.predict_device(x)
        return msg.with_array(y, self.runtime.class_names or msg.names)

    def as_pure_fn(self):
        return self.runtime.apply_fn, self.runtime.params
