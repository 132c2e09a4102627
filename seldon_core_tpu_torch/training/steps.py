"""Train steps over the port's parameter trees: fine-tuning and distillation.

Port of ``seldon_core_tpu/training/steps.py`` (``TrainState``,
``cross_entropy``, ``make_train_step``, ``init_state``, ``kl_from_teacher``,
``make_distill_step``, ``make_feature_distill_step``). The JAX package's step
is a pure function of (state, batch) with an ``optax`` transformation; in the
port a state holds leaf tensors that require grad and a ``torch.optim``
optimizer over them, and a step updates both in place and returns the same
state with ``step`` one higher.

What changes in the port:

- The optimizer is a factory (``adam(lr)``, ``sgd(lr)``) that ``init_state``
  binds to the state's leaves, so the step makers take no optimizer.
  ``adam`` is ``torch.optim.Adam`` at its defaults, which are
  ``optax.adam``'s: b1 0.9, b2 0.999, eps 1e-8 added outside the square
  root, bias-corrected moments (``tests/test_torch_training.py`` holds the
  two update for update). ``sgd`` is plain SGD, as ``optax.sgd``.
- ``feat_noise`` draws from a ``torch.Generator`` seeded from (7, step)
  (``models/decoder.sampling_generator``), not from
  ``jax.random.fold_in(key(7), step)``: the noise has the reference's
  scale, its draws differ.
- A step runs with autograd on and outside ``torch.inference_mode``
  whatever the caller's mode, on leaves that ``init_state`` made outside it.

``shard_state`` and ``make_sharded_train_step`` are mesh work and come
with the port's multi-device tier.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.models.convert import tree_map
from seldon_core_tpu_torch.models.quant import is_quantized_leaf

LogitsFn = Callable[[Any, torch.Tensor], torch.Tensor]
OptimizerFactory = Callable[[list], torch.optim.Optimizer]
FEAT_NOISE_SEED = 7  # the reference's jax.random.key(7)


def adam(lr: float) -> OptimizerFactory:
    """``optax.adam(lr)``: torch's Adam at its (the same) defaults."""
    return partial(torch.optim.Adam, lr=lr)


def sgd(lr: float) -> OptimizerFactory:
    """``optax.sgd(lr)``: no momentum, no weight decay."""
    return partial(torch.optim.SGD, lr=lr)


@dataclass
class TrainState:
    """The parameter tree (leaf tensors that require grad), the optimizer
    over its leaves, and the number of steps taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def tree_leaves(tree: Any) -> list:
    """The leaves of a dict / list tree in its iteration order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def trainable(tree: Any, device: Any = None, dtype: torch.dtype | None = None) -> Any:
    """Fresh leaf tensors that require grad, made outside inference mode:
    numpy or tensor leaves copied (onto ``device`` and into ``dtype`` where
    given). A weight-only int8 leaf has no gradient and is refused."""

    def leaf(a):
        if is_quantized_leaf(a):
            raise ValueError("an int8 weight leaf cannot be trained: gradients over int8 payloads are undefined")
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
        if not t.is_floating_point():
            raise ValueError(f"a parameter leaf of dtype {t.dtype} cannot be trained")
        t = t.detach().to(device=device if device is not None else t.device, dtype=dtype or t.dtype)
        return t.clone().requires_grad_(True)

    with torch.inference_mode(False):
        return tree_map(leaf, tree)


def init_state(params: Any, optimizer: OptimizerFactory, device: Any = None) -> TrainState:
    """A state over trainable copies of ``params`` (numpy or tensor leaves),
    its optimizer's moments made lazily by the first step, as optax's are
    made by ``init``."""
    leaves = trainable(params, device)
    return TrainState(leaves, optimizer(tree_leaves(leaves)), 0)


@contextlib.contextmanager
def grad_mode():
    """Autograd on, outside inference mode, whatever the caller's mode."""
    with torch.inference_mode(False), torch.enable_grad():
        yield


def apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer update from ``loss``'s gradient; ``state.step`` + 1."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(logits_fn: LogitsFn):
    """step(state, {"x", "y"}) -> (state, {"loss", "accuracy"})."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with grad_mode():
            logits = logits_fn(state.params, batch["x"])
            loss = cross_entropy(logits, batch["y"])
            apply_gradients(state, loss)
        acc = (logits.detach().argmax(-1) == batch["y"].long()).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def kl_from_teacher(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                    teacher_temp: float = 1.0) -> torch.Tensor:
    """Mean KL(teacher || student) over every position; ``teacher_temp`` < 1
    sharpens the teacher first (the reference's docstring says why greedy
    acceptance wants it)."""
    t = F.log_softmax(teacher_logits.float() / teacher_temp, dim=-1)
    s = F.log_softmax(student_logits.float(), dim=-1)
    return (t.exp() * (t - s)).sum(-1).mean()


def _agreement(logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    return (logits.detach().argmax(-1) == teacher_logits.argmax(-1)).float().mean()


def make_distill_step(logits_fn: LogitsFn, teacher_temp: float = 1.0):
    """KL distillation: batch {"x": ids [b, s], "t": the teacher's logits
    [b, s, vocab]} -> (state, {"kl", "top1_agreement"})."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with grad_mode():
            logits = logits_fn(state.params, batch["x"])
            loss = kl_from_teacher(batch["t"], logits, teacher_temp)
            apply_gradients(state, loss)
        return state, {"kl": loss.detach(), "top1_agreement": _agreement(logits, batch["t"])}

    return step


def feature_noise(f: torch.Tensor, feat_noise: float, step: int) -> torch.Tensor:
    """The EAGLE input-noise augmentation: Gaussian noise of std
    ``feat_noise`` x the batch features' (population) std, drawn from the
    (7, step) generator."""
    from seldon_core_tpu_torch.models.decoder import sampling_generator

    g = sampling_generator(FEAT_NOISE_SEED, step, f.device)
    noise = torch.randn(f.shape, generator=g, device=f.device, dtype=torch.float32)
    return f + (feat_noise * f.std(unbiased=False) * noise).to(f.dtype)


def make_feature_distill_step(teacher_temp: float = 1.0, feat_weight: float = 1.0, feat_noise: float = 0.0,
                              self_cond: float = 0.0):
    """KL + feature-regression distillation of the feature head: batch {"x":
    ids [b, s], "t": the teacher's logits [b, s, vocab], "f": its final
    hidden [b, s, d]} -> (state, {"kl", "top1_agreement", "feat_mse"}), the
    metrics from the teacher-forced pass. ``feat_noise`` perturbs the input
    features (the target stays clean); ``self_cond`` adds a second pass on
    the head's own detached features at that weight."""
    from seldon_core_tpu_torch.models.decoder import feature_sequence_logits

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        f = batch["f"]
        f_in = feature_noise(f, feat_noise, state.step) if feat_noise > 0.0 else f
        with grad_mode():
            logits, head_feats = feature_sequence_logits(state.params, batch["x"], f_in)
            kl = kl_from_teacher(batch["t"], logits, teacher_temp)
            fmse = ((head_feats.float() - f.float()) ** 2).mean()
            loss = kl + feat_weight * fmse
            if self_cond > 0.0:
                logits2, head_feats2 = feature_sequence_logits(state.params, batch["x"], head_feats.detach())
                kl2 = kl_from_teacher(batch["t"], logits2, teacher_temp)
                fmse2 = ((head_feats2.float() - f.float()) ** 2).mean()
                loss = loss + self_cond * (kl2 + feat_weight * fmse2)
            apply_gradients(state, loss)
        return state, {"kl": kl.detach(), "top1_agreement": _agreement(logits, batch["t"]),
                       "feat_mse": fmse.detach()}

    return step
