"""Import Hugging Face BERT checkpoints into the port's BERT.

Port of ``seldon_core_tpu/models/hf_import.py``: ``bert_params_from_hf``
maps a ``BertForSequenceClassification`` state dict onto the parameter tree
``models/bert.py::bert_logits`` consumes (torch Linear ``[out, in]`` weights
transposed to ``[in, out]``, per-layer Q/K/V concatenated into the fused
qkv projection, the segment-0 embedding folded into ``pos_emb``), the same
numpy code as there, so both packages serve the same arrays.

Where the JAX package reads the directory with
``transformers.BertForSequenceClassification.from_pretrained``, the port
reads a ``save_pretrained`` directory itself (``load_hf_bert_dir``) and
needs neither ``transformers`` nor ``safetensors``: ``config.json``, then
the first of ``model.safetensors``, ``model.safetensors.index.json`` with
its shards, or ``pytorch_model.bin`` — the order ``from_pretrained`` takes
them in. Every floating tensor is widened to float32.

Two refusals the JAX branch does not make: a checkpoint without
``classifier.weight`` (a bare ``BertModel``), whose head ``from_pretrained``
would draw at random, and a geometry the BERT apply would compute wrongly
(heads other than hidden // 64, an activation other than erf GELU).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

# safetensors dtype names -> torch dtypes the reader widens to float32
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
# buffers a checkpoint may carry that are not weights
_BUFFER_SUFFIXES = (".position_ids", ".token_type_ids")


def _t(state: dict, key: str) -> np.ndarray:
    """Fetch a tensor from a torch state_dict as float32 numpy."""
    t = state[key]
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def bert_params_from_hf(model: Any) -> dict:
    """Map a ``transformers`` BERT classifier (or its ``state_dict()``) onto
    the params tree bert_logits consumes.

    Accepts a ``BertForSequenceClassification`` instance or a raw
    state_dict with the standard HF key names. torch Linear weights are
    [out, in] and transpose to the [in, out] layout used here; per-layer
    Q/K/V concatenate into the fused qkv projection.
    """
    state = model if isinstance(model, dict) else model.state_dict()
    state = {k.removeprefix("bert."): v for k, v in state.items()}

    hidden = _t(state, "embeddings.word_embeddings.weight").shape[1]
    if hidden % 64 != 0:
        raise ValueError(
            f"hidden={hidden} is not a multiple of 64: head count is "
            "inferred as hidden//64 (head_dim 64, BERT geometry)"
        )
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in state:
        n_layers += 1
    if n_layers == 0:
        raise ValueError("no encoder layers found — not a BERT state_dict?")

    def dense(prefix: str) -> dict:
        return {
            "w": _t(state, f"{prefix}.weight").T.copy(),
            "b": _t(state, f"{prefix}.bias"),
        }

    def ln(prefix: str) -> dict:
        return {
            "scale": _t(state, f"{prefix}.weight"),
            "bias": _t(state, f"{prefix}.bias"),
        }

    layers = []
    for i in range(n_layers):
        a = f"encoder.layer.{i}.attention"
        qkv_w = np.concatenate(
            [_t(state, f"{a}.self.{m}.weight").T for m in ("query", "key", "value")],
            axis=1,
        )
        qkv_b = np.concatenate(
            [_t(state, f"{a}.self.{m}.bias") for m in ("query", "key", "value")]
        )
        layers.append(
            {
                "qkv": {"w": qkv_w.copy(), "b": qkv_b},
                "attn_out": dense(f"{a}.output.dense"),
                "ln1": ln(f"{a}.output.LayerNorm"),
                "mlp_in": dense(f"encoder.layer.{i}.intermediate.dense"),
                "mlp_out": dense(f"encoder.layer.{i}.output.dense"),
                "ln2": ln(f"encoder.layer.{i}.output.LayerNorm"),
            }
        )

    # single-segment serving: the segment-0 embedding joins every position,
    # so folding it into pos_emb is exact (HF adds tok + pos + type then LN)
    pos = _t(state, "embeddings.position_embeddings.weight")
    type0 = _t(state, "embeddings.token_type_embeddings.weight")[0]
    params: dict = {
        "tok_emb": _t(state, "embeddings.word_embeddings.weight"),
        "pos_emb": pos + type0[None, :],
        "ln_emb": ln("embeddings.LayerNorm"),
        "layers": layers,
    }
    if "pooler.dense.weight" in state:
        params["pooler"] = dense("pooler.dense")
    if "classifier.weight" in state:
        params["head"] = dense("classifier")
    else:  # headless encoder: identity head keeps bert_logits callable
        params["head"] = {
            "w": np.eye(hidden, dtype=np.float32),
            "b": np.zeros((hidden,), np.float32),
        }
    return params


# ------------------------------------------------------------ the file reader


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every floating tensor of one ``.safetensors`` file as float32 numpy:
    an 8-byte little-endian header length, a JSON header (``__metadata__``
    skipped), then raw little-endian bytes at each tensor's
    ``data_offsets``, counted from the byte after the header. Buffers
    (``_BUFFER_SUFFIXES``) are skipped; any other non-float tensor is
    refused by name."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for key, info in header.items():
        if key == "__metadata__" or key.endswith(_BUFFER_SUFFIXES):
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor '{key}' has dtype {info['dtype']}; the reader takes F32, F16 and BF16")
        start, end = info["data_offsets"]
        t = torch.frombuffer(data, dtype=dtype, count=(end - start) // dtype.itemsize, offset=start)
        out[key] = t.float().numpy().reshape(info["shape"]).copy()
    return out


def _read_torch_bin(path: str) -> dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {
        k: v.detach().float().numpy()
        for k, v in state.items()
        if not k.endswith(_BUFFER_SUFFIXES) and v.is_floating_point()
    }


def _renamed(key: str) -> str:
    """The key ``from_pretrained`` loads a tensor under: early BERT
    checkpoints name LayerNorm parameters ``gamma`` / ``beta``."""
    if "LayerNorm" in key:
        if key.endswith(".gamma"):
            return key[: -len("gamma")] + "weight"
        if key.endswith(".beta"):
            return key[: -len("beta")] + "bias"
    return key


def load_hf_bert_dir(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """(state dict of float32 numpy, config dict) of a ``save_pretrained``
    directory of a ``BertForSequenceClassification``. Raises
    FileNotFoundError when the directory holds no weights file."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    torch_bin = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        state = read_safetensors(single)
    elif os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        state = {}
        for shard in shards:
            state.update(read_safetensors(os.path.join(path, shard)))
    elif os.path.exists(torch_bin):
        state = _read_torch_bin(torch_bin)
    else:
        raise FileNotFoundError(
            f"{path} holds no model.safetensors, model.safetensors.index.json or pytorch_model.bin"
        )
    return {_renamed(k): v for k, v in state.items()}, config


def class_names_from_config(config: dict, num_classes: int) -> tuple[str, ...]:
    """The classifier's class names: the config's ``id2label`` (JSON keys
    are strings) sorted by their int value, else transformers' default
    ``LABEL_i`` for each of the head's rows."""
    id2label = config.get("id2label") or {}
    if id2label:
        return tuple(str(id2label[k]) for k in sorted(id2label, key=int))
    return tuple(f"LABEL_{i}" for i in range(num_classes))


def check_bert_geometry(path: str, state: dict, config: dict) -> None:
    """Refuse, by name, a checkpoint the BERT apply cannot serve as the
    torch model computes it: no classifier head, heads other than
    hidden // 64, or an activation other than erf GELU."""
    if "classifier.weight" not in state:
        raise ValueError(
            f"hf-bert://{path}: the checkpoint has no classifier.weight (a bare BertModel?) — "
            "from_pretrained would draw the classification head at random; save a "
            "BertForSequenceClassification instead"
        )
    hidden = int(config.get("hidden_size", 768))
    heads = int(config.get("num_attention_heads", hidden // 64))
    if heads != hidden // 64:
        raise ValueError(
            f"hf-bert://{path}: num_attention_heads={heads} with hidden_size={hidden}; "
            "the BERT apply infers hidden // 64 heads (head_dim 64)"
        )
    act = config.get("hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(f"hf-bert://{path}: hidden_act={act!r}; the BERT apply uses erf GELU ('gelu')")
