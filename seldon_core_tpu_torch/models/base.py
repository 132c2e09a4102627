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

Each (bucket, wire dtype) is one dispatch key with one CUDA graph
(``ops/graphs.py``), captured in ``warmup()``: a request copies its padded
batch into the key's static input and replays the graph, the port's form of
the JAX package's one compiled program per shape. ``compile_counts()``
counts the captures and ``recompiles_since_warmup()`` the keys first met
after warmup (each captured when it arrives, as ``jax.jit`` would compile
it). ``cuda_graphs=False`` runs the same keys eagerly on the same static
buffers: the eager twin a caller asks for by name.

``weight_quant="int8"`` quantizes the parameters from their original
float32 leaves, on the JAX package's layout, before they are laid out and
placed (``models/quant.py``, as ``seldon_core_tpu/models/base.py:137-168``
does): payloads int8, scales float32. The model's functions take the
quantized leaves where they use them (``ops/int8_matmul.py`` for a matmul).
Parameters that arrive already quantized keep their payloads and float32
scales in a plain runtime too (a fused ensemble of quantized members).

With a ``mesh`` (``parallel/mesh.py``) the runtime serves the model over
mesh positions, as ``seldon_core_tpu/models/base.py:128-134`` and
``:222-276`` do: batch buckets round up to the data axis's multiple, the
padded batch splits over "data", the parameters are placed per position
from the model's partition rule (``param_pspecs``; axes the mesh lacks are
dropped with a warning, and a replicated leaf is held once per distinct
device), and the apply is the model's ``MeshApply`` (or its single-position
apply run on each data lead). Where every position is on one device the
whole sharded forward is captured once per bucket, as above; one graph
cannot span cards, so a mesh over distinct cards runs eagerly, logged at
build and marked ``mesh_eager`` on every request's span (``Mesh.describe``).
On a mesh whose "data" axis spans processes (``parallel/mesh.py::
process_mesh``) a runtime takes this process's rows and returns them, as a
JAX program over process-local data does: its buckets round up to the
data positions this process holds. With ``weight_quant="int8"`` the
partition rule is mirrored onto the quantized leaves
(``quant.quantized_pspecs``): a position holds its shard of each int8
payload, as a contiguous copy, and the scales of its own columns.
"""

from __future__ import annotations

import asyncio
import logging
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
    to_host,
)
from seldon_core_tpu_torch.engine.units import Unit
from seldon_core_tpu_torch.graph.spec import PredictiveUnit
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.models.quant import quantize_params, quantized_pspecs
from seldon_core_tpu_torch.ops.graphs import GraphCache
from seldon_core_tpu_torch.parallel.collectives import shard, unshard
from seldon_core_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    MeshApply,
    PositionParams,
    data_parallel,
    place_params,
    unique_tensors,
)

log = logging.getLogger(__name__)

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


_COMPUTE_POOL_HOLDERS = 0


def hold_compute_pool() -> None:
    """A server that may use the pool counts itself in; the pool itself
    still starts at first use."""
    global _COMPUTE_POOL_HOLDERS
    with _COMPUTE_POOL_LOCK:
        _COMPUTE_POOL_HOLDERS += 1


def release_compute_pool() -> None:
    """A server's close: the last holder to go shuts the pool down and
    joins its threads (work already queued finishes first); the next
    ``compute_pool()`` starts a new one."""
    global _COMPUTE_POOL, _COMPUTE_POOL_HOLDERS
    with _COMPUTE_POOL_LOCK:
        _COMPUTE_POOL_HOLDERS = max(0, _COMPUTE_POOL_HOLDERS - 1)
        pool = None
        if _COMPUTE_POOL_HOLDERS == 0:
            pool, _COMPUTE_POOL = _COMPUTE_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


ApplyFn = Callable[[Any, torch.Tensor], torch.Tensor]


class ModelRuntime:
    """One model loaded onto one device, or over the positions of a mesh.

    ``apply_fn(params, x[batch, ...]) -> y[batch, ...]`` takes the parameter
    tree (tensors on ``device``) and a batch tensor on ``device``; on a mesh
    it may be a ``MeshApply`` over every position's tree and block."""

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
        weight_quant: str = "",
        cuda_graphs: bool = True,
        mesh: Mesh | None = None,
        param_pspecs: Any = None,
    ):
        if weight_quant not in ("", "int8"):
            raise ValueError(f"weight_quant must be '' or 'int8', got {weight_quant!r}")
        if int_inputs not in ("cast", "ids"):
            raise ValueError(f"int_inputs must be 'cast' or 'ids', got {int_inputs!r}")
        if offload_compute not in ("auto", "always", "never"):
            raise ValueError(
                "offload_compute must be 'auto', 'always' or 'never', got "
                f"{offload_compute!r}"
            )
        self.apply_fn = apply_fn
        self.mesh = mesh
        # on a mesh: where the padded batch is staged and the output gathered
        self.device = resolve_device(device) if mesh is None else mesh.positions[0]
        self.dtype = dtype
        # "cast": integer payloads are values and normalize to float;
        # "ids": integers are token ids and stay exact int32
        self.int_inputs = int_inputs
        self.class_names = tuple(class_names)
        self.buckets = tuple(buckets) if buckets else default_buckets(max_batch)
        if mesh is not None and DATA_AXIS in mesh.shape:
            # the batch splits over the data axis, so every bucket rounds up to
            # its multiple (padding covers the difference)
            d = mesh.shape[DATA_AXIS]
            self.buckets = tuple(sorted({-(-b // d) * d for b in self.buckets}))
        # "auto" resolves at warmup() from a measured forward; until then
        # only "always" offloads
        self.offload_compute_mode = offload_compute
        self.offload_compute = offload_compute == "always"
        self.stat_forward_ms: float | None = None
        self.feature_shape: tuple[int, ...] | None = None
        # generative decode geometry ({"seq", "max_new_tokens"}), set by the
        # zoo for decoders; read by the decode scheduler's opt-in
        self.generative: dict | None = None
        self._low_precision = torch.finfo(dtype).bits < 32
        self.weight_quant = weight_quant
        if weight_quant == "int8":
            params = quantize_params(params)
            if param_pspecs is not None:
                # a leaf's spec applies to its int8 payload, its scales go
                # with the payload's columns
                param_pspecs = quantized_pspecs(param_pspecs, params)
        if mesh is None:
            self.params = params_to_torch(params, self.device, dtype, layout)
        else:
            # over processes: each process's rows in, its rows out
            mesh.check_data_only("a model runtime")
            if not isinstance(apply_fn, MeshApply):
                self.apply_fn = data_parallel(apply_fn, mesh)
            self.params = params if isinstance(params, PositionParams) else place_params(
                params, param_pspecs, mesh, lambda a, dev: params_to_torch(a, dev, dtype, layout))
            if mesh.n_devices > 1 and cuda_graphs:
                # one CUDA graph cannot span cards
                log.warning("mesh %s spans %d devices: its forwards run eagerly, not as captured graphs",
                            mesh.shape, mesh.n_devices)
                cuda_graphs = False
        # the partition rule load_params places a full tree by
        self.param_pspecs = param_pspecs
        # held while a forward is queued and while load_params queues its
        # copies: a replay sees every leaf of one update or none
        self.params_lock = threading.Lock()
        # one captured graph per (bucket, wire dtype, feature shape) on the card
        self.cuda_graphs = cuda_graphs
        self.graphs = GraphCache(self.device, capture=cuda_graphs)
        self._warmup_keys: int | None = None

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if x.dtype == torch.uint8 or (self._low_precision and x.dtype == torch.float32):
                x = x.to(self.dtype)
            if self.mesh is None:
                y = self.apply_fn(self.params, x)
            else:
                split = {DATA_AXIS: 0}
                y = unshard(self.apply_fn(self.params, shard(x, self.mesh, split)), self.mesh, split, self.device)
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
        # a feature shape other than the warmed one is a key of its own (the
        # JAX package compiles it anew), never a write into another's buffer
        entry = self.graphs.entry(("forward", bucket, padded.dtype.str, padded.shape[1:]), self._forward,
                                  [(padded.shape, torch.from_numpy(padded[:0]).dtype)])
        # the rows leave the static output before the next request may
        # overwrite it
        with self.params_lock:
            return entry.run(padded, post=lambda y: y[:valid].clone())

    def load_params(self, tree: Any) -> None:
        """Copy a tree of the resident parameters' structure and shapes into
        them in place, as one update: the captured graphs read these tensors'
        storage, so new weights must land in it (a new tree would leave every
        replay on the old one). The copies are queued on the devices' current
        streams under ``params_lock``, the lock a forward is queued under, so
        each forward sees all of the update or none of it, on every position.

        On a mesh the update is a ``PositionParams`` of the resident one's
        structure (a train step's placed copies) or a full tree in the port's
        layout (``gather_params``' form, a snapshot), placed here with the
        runtime's partition rule; each distinct resident tensor is copied
        once, and shapes are checked per position."""
        if self.mesh is None:
            dst_trees, src_trees = [self.params], [tree]
        else:
            if not isinstance(tree, PositionParams):
                tree = place_params(tree, self.param_pspecs, self.mesh,
                                    lambda a, dev: params_to_torch(a, dev, self.dtype))
            if len(tree) != len(self.params):
                raise ValueError(f"a parameter update for {len(tree)} positions on a mesh of {len(self.params)}")
            dst_trees, src_trees = self.params, tree
        pairs: dict[int, tuple] = {}
        for pos, (d_tree, s_tree) in enumerate(zip(dst_trees, src_trees)):
            def pair(d, s, pos=pos):
                if tuple(d.shape) != tuple(s.shape):
                    where = f" at mesh position {pos}" if self.mesh is not None else ""
                    raise ValueError(f"a parameter update of shape {tuple(s.shape)} for a leaf of shape "
                                     f"{tuple(d.shape)}{where}")
                pairs.setdefault(id(d), (d, s))

            _zip_trees(pair, d_tree, s_tree)
        with self.params_lock, torch.no_grad():
            for d, s in pairs.values():
                d.copy_(s)

    def _uint8_wire(self) -> bool:
        """uint8 rides to the device raw only for image-shaped value models
        (rank >= 2 features): exactly the signatures warmup runs."""
        shape = self.feature_shape
        return self.int_inputs == "cast" and shape is not None and len(tuple(shape)) >= 2

    def warmup(self) -> None:
        """One forward per bucket and wire dtype ahead of traffic, each
        captured as a CUDA graph on the card, then resolve
        offload_compute="auto" from the largest bucket's measured (replayed)
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
        self._warmup_keys = sum(self.compile_counts().values())
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

    def param_bytes(self) -> int:
        """Device bytes the parameters hold: every tensor once, so a leaf
        that positions share on one device counts once (int8 payloads and
        their float32 scales included)."""
        trees = self.params if isinstance(self.params, PositionParams) else [self.params]
        return sum(t.numel() * t.element_size() for t in unique_tensors(trees))

    def compile_counts(self) -> dict[str, int]:
        """Dispatch keys built, per program: on the card each is one captured
        CUDA graph (the runtime's one program is ``forward``)."""
        return {"forward": self.graphs.counts().get("forward", 0)}

    def recompiles_since_warmup(self) -> int:
        """Keys built since warmup(): 0 is the serving invariant; -1 when
        warmup never ran."""
        if self._warmup_keys is None:
            return -1
        return sum(self.compile_counts().values()) - self._warmup_keys

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


def _zip_trees(fn: Callable[[torch.Tensor, Any], None], dst: Any, src: Any) -> None:
    """``fn(dst_leaf, src_leaf)`` over two trees of one structure; raises
    where they differ."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or dst.keys() != src.keys():
            raise ValueError("a parameter update whose tree differs from the runtime's")
        for k in dst:
            _zip_trees(fn, dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError("a parameter update whose tree differs from the runtime's")
        for d, s in zip(dst, src):
            _zip_trees(fn, d, s)
    else:
        fn(dst, src)


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
