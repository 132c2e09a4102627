"""Mixture-of-Experts FFN, with expert parallelism over the mesh "expert" axis.

Port of ``seldon_core_tpu/ops/moe.py``: top-1 gating in the dense-dispatch
formulation (every expert computes every token and a one-hot gate selects),
so the sharded form needs no routing collective. With ``w1``/``b1``/``w2``/
``b2`` split over the expert axis (``moe_pspecs``), each position computes
only its local experts' slab of the ``ebsf`` intermediate, and the
gate-selected sum over the expert axis becomes one ``psum``
(``moe_ffn_shards``), where XLA derives the same psum from the shardings.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.parallel.collectives import psum, replicated
from seldon_core_tpu_torch.parallel.mesh import EXPERT_AXIS, Mesh, P


def init_moe(seed: int, d_model: int, d_ff: int, n_experts: int) -> dict:
    """The JAX package's numpy draws, in its order: bit-identical weights."""
    rng = np.random.default_rng(seed)
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_ff) ** 0.5
    return {
        "gate": (rng.standard_normal((d_model, n_experts)) * 0.02).astype(np.float32),
        "w1": (rng.standard_normal((n_experts, d_model, d_ff)) * s1).astype(np.float32),
        "b1": np.zeros((n_experts, d_ff), np.float32),
        "w2": (rng.standard_normal((n_experts, d_ff, d_model)) * s2).astype(np.float32),
        "b2": np.zeros((n_experts, d_model), np.float32),
    }


def moe_pspecs(expert_axis: str = EXPERT_AXIS) -> dict:
    """Experts split over the mesh's expert axis, the gate replicated."""
    return {
        "gate": P(),
        "w1": P(expert_axis, None, None),
        "b1": P(expert_axis, None),
        "w2": P(expert_axis, None, None),
        "b2": P(expert_axis, None),
    }


def _gate(params: dict, x: torch.Tensor):
    logits = x @ params["gate"].to(x.dtype)  # [b, s, E]
    probs = torch.softmax(logits, dim=-1)
    top = probs.argmax(dim=-1)  # [b, s]
    onehot = torch.nn.functional.one_hot(top, logits.shape[-1]).to(x.dtype)  # [b, s, E]
    gate_weight = (probs * onehot).sum(dim=-1, keepdim=True)  # [b, s, 1]
    return onehot, gate_weight


def _expert_slab(params: dict, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The gate-selected sum over the experts ``params`` holds (all of
    them, or one position's slab with ``onehot`` cut to match)."""
    h = torch.einsum("bsd,edf->ebsf", x, params["w1"].to(x.dtype))
    h = torch.relu(h + params["b1"].to(x.dtype)[:, None, None, :])
    y = torch.einsum("ebsf,efd->ebsd", h, params["w2"].to(x.dtype))
    y = y + params["b2"].to(x.dtype)[:, None, None, :]
    return torch.einsum("ebsd,bse->bsd", y, onehot)


def moe_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [batch, seq, d_model] -> [batch, seq, d_model], top-1 routing, all
    experts on one position."""
    onehot, gate_weight = _gate(params, x)
    return _expert_slab(params, x, onehot) * gate_weight


def moe_ffn_shards(params: Sequence[dict], xs: Sequence[torch.Tensor], mesh: Mesh,
                   expert_axis: str = EXPERT_AXIS) -> list[torch.Tensor]:
    """``moe_ffn`` with each position's experts a contiguous slab of the
    expert axis (``moe_pspecs``): per position the gate over every expert
    (the gate is replicated), its slab's selected sum, then one psum over
    the expert axis. ``xs`` per position, replicated along the expert axis."""
    gates = replicated(_gate, mesh, expert_axis, params, xs)
    partial = []
    for pos, (p, x, (onehot, _)) in enumerate(zip(params, xs, gates)):
        e_local = p["w1"].shape[0]
        first = mesh.coord(pos, expert_axis) * e_local
        partial.append(_expert_slab(p, x, onehot[..., first:first + e_local]))
    summed = psum(partial, mesh, expert_axis)
    return replicated(lambda s, g: s * g[1], mesh, expert_axis, summed, gates)


def moe_load_balance_loss(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss, E * sum(frac_e * prob_e): 1 at perfect
    balance, up to E at total collapse."""
    logits = x.float() @ params["gate"].float()
    probs = torch.softmax(logits, dim=-1)
    top = probs.argmax(dim=-1)
    n_experts = logits.shape[-1]
    frac = torch.nn.functional.one_hot(top, n_experts).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    return n_experts * (frac * mean_prob).sum()
