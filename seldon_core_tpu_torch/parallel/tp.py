"""Tensor-parallel partitioning for the generative decode tier.

Port of ``seldon_core_tpu/parallel/tp.py``. The decode scheduler
(``serving/decode_scheduler.py``) runs every fused program (prefill chunk
ladder, decode step, verify, draft, paged copy) as one dispatch key. On a
decode mesh (``tpu.decode_mesh_axes``, e.g. ``{"tp": 4}``) each of those
programs runs over the mesh's positions, following the low-latency decode
partitioning of Pope et al., *Efficiently Scaling Transformer Inference*
(2022), as the JAX package's GSPMD programs do:

- **attention sharded on the head axis**: the paged KV pool
  ``[L, n_pages, h, page_size, hd]`` and the draft's flat slot cache
  ``[L, n_slots, h, ctx, hd]`` hold ``h / tp`` heads per position, and each
  position runs its heads' scores, softmax and context on its own;
- **FFN sharded on the hidden axis**: ``mlp_in`` column-parallel, ``mlp_out``
  row-parallel;
- **row-parallel output projections**: ``attn_out``'s input axis is split
  head-aligned, so each residual branch ends in one ``psum``: two per layer
  (attention and FFN), with the row-parallel bias added once, after it;
- **everything else replicated**: layer norms, embeddings, the weight-tied
  head, the feature head's ``fc`` fuse and the packed ``qkv`` projection,
  whose q|k|v boundaries a contiguous shard cannot respect. Its redundant
  FLOPs are 3h^2 of the ~12h^2 per token, while the sharded tensors carry
  the attention and FFN majority and the KV bytes.

The port's form is the list-of-shards mesh of ``parallel/mesh.py``: one
process drives the positions, a parameter tree is placed per position by
``place_params`` under ``decoder_param_pspecs`` (a replicated leaf is held
once per distinct device), and the two reduces are
``parallel/collectives.py::psum``. The replicated residual stream, and with
it the full q/k/v of the replicated ``qkv`` projection, lives on the lead
position's device; each position receives its heads of q/k/v and the MLP
input there (no copy for positions on the lead's device), and each write
into a head-sharded buffer takes the full rows and stores each position's
heads.

int8 paged KV: the per-page-row (scale, zero point) planes
``[L, n_pages, page_size]`` have no head axis and replicate. Quantization
reduces over ``(h, hd)`` of the full fresh rows, so every position stores
the scales the single-device pool would, and its dequant reads its
device's copy of the planes.

Host-side structures (block tables, the ``PageAllocator``, the prefix
index) are device-count-agnostic: a block table maps logical to physical
pages, and a page is itself head-sharded, so admission, copy-on-write and
reclaim never see the mesh. The host KV tier moves whole pages: a read
gathers every position's heads of a page, a write scatters them back.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from seldon_core_tpu_torch.parallel.collectives import _on, psum
from seldon_core_tpu_torch.parallel.mesh import Mesh, P, PositionParams, local_cards, place_params


def tp_width(mesh_axes) -> int:
    """The tensor-parallel width a ``decode_mesh_axes`` mapping asks for
    (1 when unset/empty — single-device)."""
    if not mesh_axes:
        return 1
    w = 1
    for size in mesh_axes.values():
        w *= int(size)
    return w


def _host_cards() -> list[torch.device]:
    """The cards this process sees (the CPU alone off the card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return local_cards("cuda")
    return [torch.device("cpu")]


def decode_mesh_problems(mesh_axes, params=None, draft_params=None, devices=None) -> list[str]:
    """Everything wrong with a ``decode_mesh_axes`` request, as a list of
    problems (empty = servable). Pure host checks: axis shape, device
    budget, and — when the decoder params are at hand — the divisibility
    rules head/FFN sharding needs. ``decode_tp_mesh`` raises these;
    ``scheduler_for_executor`` warn-and-disables on them (the spec-mode
    precedent for unservable opt-in configs). ``devices``: the positions
    the caller offers (a list may repeat a device); None counts the
    host's distinct cards."""
    problems: list[str] = []
    if not mesh_axes:
        return problems
    if len(mesh_axes) != 1:
        problems.append(
            f"decode_mesh_axes supports exactly ONE tensor-parallel axis, "
            f"got {dict(mesh_axes)!r}"
        )
    for name, size in mesh_axes.items():
        if int(size) < 1:
            problems.append(f"decode_mesh_axes axis '{name}' must be >= 1, got {size}")
    tp = tp_width(mesh_axes)
    n_dev = len(_host_cards() if devices is None else list(devices))
    if tp > n_dev:
        problems.append(
            f"decode_mesh_axes={dict(mesh_axes)} needs {tp} devices, have {n_dev}"
        )
    for what, p in (("decoder", params), ("draft", draft_params)):
        if p is None or tp <= 1:
            continue
        from seldon_core_tpu_torch.models.decoder import decoder_dims

        dims = decoder_dims(p)
        ffn = p["layers"][0]["mlp_in"]["w"].shape[1]
        if dims["heads"] % tp:
            problems.append(
                f"{what} n_heads={dims['heads']} not divisible by tp width {tp} "
                "(attention is sharded on the head axis)"
            )
        if ffn % tp:
            problems.append(
                f"{what} ffn={ffn} not divisible by tp width {tp} "
                "(the FFN is sharded on its hidden axis)"
            )
    return problems


def decode_tp_mesh(mesh_axes, params=None, draft_params=None, devices=None):
    """Build the decode mesh: ``(mesh, axis_name, tp_width)``.

    Returns ``(None, None, 1)`` for an unset/width-1 request. Raises
    ValueError listing every problem — the scheduler's contract when
    handed mesh axes directly; the serving builder pre-checks with
    ``decode_mesh_problems`` and warn-disables instead, so a deployment
    degrades to single-device rather than failing to boot. The mesh takes
    the first ``tp`` of ``devices`` (the host's cards when None)."""
    problems = decode_mesh_problems(mesh_axes, params, draft_params, devices)
    if problems:
        raise ValueError("; ".join(problems))
    tp = tp_width(mesh_axes)
    if tp <= 1:
        return None, None, 1
    positions = list(_host_cards() if devices is None else devices)[:tp]
    mesh = Mesh({str(a): int(s) for a, s in mesh_axes.items()}, positions)
    axis = mesh.axis_names[0]
    return mesh, axis, mesh.shape[axis]


def decoder_param_pspecs(params: dict, axis: str):
    """Partition-spec tree for the models/decoder.py param layout (see
    the module docstring for the partitioning rationale)."""

    def _ln(p):
        return {k: P() for k in p}

    def _layer(lp):
        return {
            "ln1": _ln(lp["ln1"]),
            # packed q/k/v boundaries don't align with contiguous shards
            "qkv": {"w": P(), "b": P()},
            # row-parallel: input axis sharded head-aligned, bias applied
            # to the all-reduced (replicated) output
            "attn_out": {"w": P(axis, None), "b": P()},
            "ln2": _ln(lp["ln2"]),
            # column-parallel: output ffn axis sharded, bias rides the shard
            "mlp_in": {"w": P(None, axis), "b": P(axis)},
            "mlp_out": {"w": P(axis, None), "b": P()},
        }

    out = {
        "tok_emb": P(),
        "pos_emb": P(),
        "layers": [_layer(lp) for lp in params["layers"]],
        "ln_f": _ln(params["ln_f"]),
    }
    if "fc" in params:
        # feature-draft head (models/decoder.init_feature_draft): the
        # [2*hidden -> hidden] feature+embedding fuse replicates — its
        # input is the replicated feat buffer + embedding, and its output
        # feeds the head's qkv which is replicated too
        out["fc"] = {"w": P(), "b": P()}
    return out


class TPLayer(dict):
    """One decoder layer over a decode mesh. As a dict it holds the lead
    position's replicated leaves the single-device code reads (``ln1``,
    ``qkv``, ``ln2``); ``shards`` holds every position's layer tree (its
    ``attn_out``/``mlp_out`` rows, its ``mlp_in`` columns)."""

    def __init__(self, shards: Sequence[dict], mesh: Mesh, axis: str):
        super().__init__({k: shards[0][k] for k in ("ln1", "qkv", "ln2")})
        self.shards, self.mesh, self.axis = list(shards), mesh, axis

    @property
    def width(self) -> int:
        return self.mesh.shape[self.axis]

    def each(self, fn: Callable, heads: Sequence, args: Sequence) -> list:
        """``fn(*heads_i, *args_i)`` at every position i: ``heads`` are
        full-head tensors ``[n, h, ...]`` (or None), of which position i
        takes its ``h / tp`` heads; of ``args`` a ``Placed`` buffer (or a
        tuple of them) gives position i's part, a tensor goes to i's device,
        anything else passes as it is."""
        out, moved = [], {}

        def local(a, i, dev):
            if isinstance(a, Placed):
                return a.parts[i]
            if isinstance(a, tuple):
                return tuple(local(b, i, dev) for b in a)
            if isinstance(a, torch.Tensor):
                key = (id(a), dev)
                if key not in moved:
                    moved[key] = _on(a, dev)
                return moved[key]
            return a

        for i, dev in enumerate(self.mesh.positions):
            hs = [None if t is None else _on(head_block(t, 1, self.mesh.coord(i, self.axis), self.width), dev)
                  for t in heads]
            out.append(fn(*hs, *(local(a, i, dev) for a in args)))
        return out


class TPParams(dict):
    """A decoder's parameters placed over a decode mesh. As a dict it is the
    lead position's tree with ``layers`` as ``TPLayer``s, so the
    single-device code reads the replicated leaves (embeddings, ``ln_f``,
    the feature head's ``fc``) where it always did; ``positions`` is the
    ``PositionParams`` every position holds."""

    def __init__(self, positions: PositionParams, mesh: Mesh, axis: str):
        lead = positions[0]
        super().__init__({k: v for k, v in lead.items() if k != "layers"})
        self["layers"] = [TPLayer([p["layers"][li] for p in positions], mesh, axis)
                          for li in range(len(lead["layers"]))]
        self.positions, self.mesh, self.axis = positions, mesh, axis


def place_decoder(params: dict, mesh: Mesh, axis: str) -> TPParams:
    """``params`` (tensors on one device) placed by ``decoder_param_pspecs``:
    each position's shards as contiguous copies on its device, a
    replicated leaf once per distinct device (the given tensor itself on
    its own device)."""
    placed = place_params(params, decoder_param_pspecs(params, axis), mesh, lambda a, dev: _on(a, dev))
    return TPParams(placed, mesh, axis)


def row_parallel(partials: Sequence[torch.Tensor], bias: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """A row-parallel projection's output on the lead position: the psum of
    every position's partial product, then the bias, once."""
    return psum(partials, mesh, axis)[0] + bias


def head_block(t: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    """Block ``i`` of ``n`` along ``dim`` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


class Placed:
    """A decode buffer over the positions of a decode mesh: ``parts[i]`` is
    position i's block. ``dim`` is the head axis the buffer is split at
    (None: replicated, one tensor per distinct device, which the positions
    on that device share)."""

    __slots__ = ("parts", "dim", "mesh", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], dim: int | None, mesh: Mesh, axis: str):
        self.parts, self.dim, self.mesh, self.axis = list(parts), dim, mesh, axis

    def __getitem__(self, key) -> "Placed":
        """Every part indexed by ``key`` along the leading axes (a layer):
        the key must not reach the head axis."""
        views: dict = {}
        parts = [views.setdefault(id(p), p[key]) for p in self.parts]
        dim = self.dim
        if dim is not None and isinstance(key, int):
            dim -= 1
        return Placed(parts, dim, self.mesh, self.axis)

    def unique(self) -> list[torch.Tensor]:
        """Each distinct tensor once (a replicated buffer: one per device)."""
        return list({id(p): p for p in self.parts}.values())

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> tuple:
        """The global shape."""
        shape = list(self.parts[0].shape)
        if self.dim is not None:
            shape[self.dim] *= self.mesh.shape[self.axis]
        return tuple(shape)

    def zero_(self) -> "Placed":
        for t in self.unique():
            t.zero_()
        return self

    def copy_(self, other: "Placed") -> "Placed":
        for t, s in zip(self.unique(), other.unique()):
            t.copy_(s)
        return self

    def block(self, i: int, full: torch.Tensor, dim: int) -> torch.Tensor:
        """Position i's share of a full-head tensor whose head axis is
        ``dim``, on i's device (the whole tensor for a replicated buffer)."""
        if self.dim is None:
            return _on(full, self.parts[i].device)
        return _on(head_block(full, dim, self.mesh.coord(i, self.axis), self.mesh.shape[self.axis]),
                   self.parts[i].device)

    def gather(self, fn: Callable[[torch.Tensor], torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
        """The full tensor of ``fn(part)`` over the positions: the parts'
        results concatenated along the head axis ``dim`` on ``device`` (a
        replicated buffer: the lead's)."""
        if self.dim is None:
            return _on(fn(self.parts[0]), device)
        return torch.cat([_on(fn(p), device) for p in self.parts], dim=dim)

    def each_part(self, fn: Callable[[torch.Tensor, int], Any]) -> None:
        """``fn(part, i)`` once per distinct part (i: the first position
        holding it)."""
        seen: set = set()
        for i, p in enumerate(self.parts):
            if id(p) not in seen:
                seen.add(id(p))
                fn(p, i)


def kv_placed(shape: Sequence[int], dtype: torch.dtype, mesh: Mesh, axis: str, fill: float = 0.0) -> Placed:
    """One KV buffer over the mesh, by the KV layout: the 5-D layouts — page
    pool ``[L, n_pages, h, page_size, hd]`` and flat slot cache
    ``[L, n_slots, h, ctx, hd]`` — carry heads at axis 2 and split there;
    everything else (the int8 scale and zero-point planes, which have no
    head axis) replicates, one tensor per distinct device. Filled with
    ``fill``."""
    dim = 2 if len(shape) == 5 else None
    local = list(shape)
    if dim is not None:
        local[dim] //= mesh.shape[axis]
    made: dict = {}
    parts = []
    for i, dev in enumerate(mesh.positions):
        key = i if dim is not None else dev
        if key not in made:
            made[key] = torch.full(local, fill, dtype=dtype, device=dev)
        parts.append(made[key])
    return Placed(parts, dim, mesh, axis)


def tensors_of(a) -> list[torch.Tensor]:
    """The distinct tensors of a buffer, placed or not."""
    return a.unique() if isinstance(a, Placed) else [a]
