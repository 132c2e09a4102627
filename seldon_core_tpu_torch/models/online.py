"""Online fine-tuning from serving feedback.

Port of ``seldon_core_tpu/models/online.py``: a ``JAX_MODEL`` unit with
``finetune: true`` buffers (features, truth) pairs from
``/api/v0.1/feedback`` and, once ``finetune_batch`` examples are in, runs
one SGD or Adam step off the event loop and puts the updated weights under
the serving runtime, so the next prediction sees them. The loss is the
reference's: cross-entropy on log(serving probabilities + 1e-9).

What changes in the port: the reference swaps ``runtime.params`` for the
step's new tree, and a predict in flight finishes on the old one. The
port's forwards are CUDA graphs captured over the parameter tensors'
storage (``models/base.py``), so a new tree would never be seen. The step
trains copies of the serving parameters (made at the first step, in the
serving dtype, with the optimizer's moments beside them) and
``ModelRuntime.load_params`` copies the result into the captured tensors
as one update, ordered against every replay: a forward sees all of a step
or none of it, and no dispatch key is added.

On a mesh (``tpu.mesh`` with any axes the port serves) the unit trains
over the mesh, as the JAX package's step takes ``jax.value_and_grad``
through its mesh-aware apply: the step's copies are the runtime's
per-position blocks (``PositionParams``, sharing kept), the loss is taken
on the global batch from the data leads' rows (``steps.data_split_apply``:
a batch the data axis does not divide is padded with rows the loss never
reads), each block's copies on distinct devices agree on their gradient
(``parallel/mesh.py::sum_replica_grads``), and ``load_params`` copies every
position's blocks in as one update. A snapshot holds the full tree
(``gather_params``) and the optimizer's moments as full leaves, as JAX's
``np.asarray`` of sharded arrays gathers them, so it restores into a mesh
unit or a one-device unit alike.

A forward that reaches a hand-written kernel has no backward
(``ops/flash_attention.py``, ``ops/int8_matmul.py``): its wrapper raises
under autograd, the step fails with that error and the weights stay, as the
reference's step through its Pallas kernel fails. int8 weights are refused
at build (``models/zoo.py::make_model_unit``).
"""

from __future__ import annotations

import asyncio
import logging
import threading

import numpy as np
import torch

from seldon_core_tpu_torch.core.message import Feedback
from seldon_core_tpu_torch.graph.spec import PredictiveUnit
from seldon_core_tpu_torch.models.base import ModelRuntime, ModelUnit
from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch, tree_map
from seldon_core_tpu_torch.parallel.mesh import gather_params
from seldon_core_tpu_torch.training.steps import (
    TrainState,
    adam,
    apply_gradients,
    data_split_apply,
    gathered_optimizer_state,
    grad_mode,
    init_state,
    load_optimizer_state,
    sgd,
)

log = logging.getLogger(__name__)


def _to_numpy(obj):
    """An optimizer's state dict with every tensor as a numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().float().cpu().numpy() if obj.is_floating_point() else obj.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_tensors(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    return obj


class OnlineFinetuneModelUnit(ModelUnit):
    """A model unit that learns from labelled feedback.

    Unit parameters: ``finetune`` (enables this unit), ``finetune_lr``
    (default 1e-3), ``finetune_batch`` (examples per step, default 32),
    ``finetune_optimizer`` ("sgd" or "adam", the default)."""

    def __init__(self, spec: PredictiveUnit, runtime: ModelRuntime):
        super().__init__(spec, runtime)
        self.lr = float(self.params.get("finetune_lr", 1e-3))
        self.batch = int(self.params.get("finetune_batch", 32))
        opt_name = str(self.params.get("finetune_optimizer", "adam"))
        self._optimizer = sgd(self.lr) if opt_name == "sgd" else adam(self.lr)
        # the trainable copies and the optimizer's moments are made by the
        # first step: they double the model's memory, wasted if no feedback
        # ever comes
        self._state: TrainState | None = None
        self._buffer_x: list[np.ndarray] = []
        self._buffer_y: list[int] = []
        self._steps_taken = 0
        self._lock = threading.Lock()  # the buffer and the step count
        self._train_lock = threading.Lock()  # one step at a time; taken before _lock

    # ------------------------------------------------------------- learning
    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        """Buffer (request features, truth label); train when full."""
        if feedback.request is None or feedback.truth is None:
            return
        x = feedback.request.array
        t = feedback.truth.array
        if x is None or t is None:
            return
        x = np.atleast_2d(np.asarray(x, np.float32))
        t = np.asarray(t)
        # truth may be class indices [n] / [n, 1] or one-hot rows [n, classes]
        if t.ndim >= 2 and t.shape[-1] > 1:
            y = np.argmax(t, axis=-1).reshape(-1)
        else:
            y = t.reshape(-1).astype(np.int64)
        if x.shape[0] != y.shape[0]:
            return
        batches = []
        with self._lock:
            self._buffer_x.extend(x)
            self._buffer_y.extend(int(v) for v in y)
            # drain every full batch, or payloads larger than the batch
            # grow the buffer without bound
            while len(self._buffer_y) >= self.batch:
                batches.append((np.stack(self._buffer_x[: self.batch]),
                                np.asarray(self._buffer_y[: self.batch], np.int32)))
                del self._buffer_x[: self.batch]
                del self._buffer_y[: self.batch]
        for bx, by in batches:
            # off the event loop: a step waits for the device
            await asyncio.to_thread(self._train, bx, by)

    def _train(self, x: np.ndarray, y: np.ndarray) -> None:
        rt = self.runtime
        with self._train_lock:
            if self._state is None:
                self._state = init_state(rt.params, self._optimizer)
            state = self._state
            xt = torch.from_numpy(x).to(rt.device)  # float32, as the reference's step takes it
            yt = torch.from_numpy(y).to(rt.device).long()
            with grad_mode():
                if rt.mesh is None:
                    probs = rt.apply_fn(state.params, xt)
                else:
                    probs = data_split_apply(rt.apply_fn, state.params, xt, rt.mesh)
                logp = torch.log(probs.float() + 1e-9)
                loss = -logp.gather(-1, yt[:, None]).mean()
                apply_gradients(state, loss)
            rt.load_params(state.params)
            with self._lock:
                self._steps_taken += 1
                steps = self._steps_taken
        log.info("online finetune '%s': step %d, loss %.4f", self.name, steps, float(loss.detach()))

    # ---------------------------------------------------------- persistence
    def __getstate__(self):
        # the persister snapshots from its own thread while feedback fills
        # the buffer and steps run: between steps, with (x, y) aligned
        with self._train_lock, self._lock:
            return {
                "buffer_x": [np.asarray(a) for a in self._buffer_x],
                "buffer_y": list(self._buffer_y),
                "steps_taken": self._steps_taken,
                # a copy: on the CPU the arrays would share the live storage
                "params": tree_map(np.array, params_to_numpy(self._full_params())),
                "opt_state": None if self._state is None else _to_numpy(gathered_optimizer_state(self._state)),
            }

    def __setstate__(self, state):
        with self._train_lock, self._lock:
            self._buffer_x = [np.asarray(a) for a in state.get("buffer_x", [])]
            self._buffer_y = list(state.get("buffer_y", []))
            self._steps_taken = int(state.get("steps_taken", 0))
            rt = self.runtime
            if "params" in state:
                # on a mesh the full tree is placed by the runtime's rule
                rt.load_params(state["params"] if rt.mesh is not None else
                               params_to_torch(state["params"], rt.device, rt.dtype))
            self._state = None
            if state.get("opt_state") is not None:
                self._state = init_state(rt.params, self._optimizer)
                load_optimizer_state(self._state, _to_tensors(state["opt_state"]))

    def _full_params(self):
        """The serving parameters as one tree (gathered on a mesh)."""
        rt = self.runtime
        return gather_params(rt.params) if rt.mesh is not None else rt.params
