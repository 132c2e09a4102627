"""Model checkpoint save and restore (the ``file://`` model_uri scheme).

Port of ``seldon_core_tpu/persistence/checkpoint.py``, in its format, so
each package restores the other's checkpoints: ``<dir>/metadata.json``
holds the zoo builder's name and kwargs, ``<dir>/params.msgpack`` the
parameter tree as ``flax.serialization.to_bytes`` writes it (the port's own
codec, ``persistence/_msgpack.py``: the card's host has no flax). Restore
builds the zoo model as the template (its apply, feature shape, class
names, integer-input rule and layout) and fills its tree leaf by leaf.

A restore refuses, by path, a key the checkpoint lacks, a key the template
lacks and a leaf of another shape. flax's ``from_bytes`` refuses the first
and passes the other two through.

CLI (a seeded zoo model written as a checkpoint):
    python -m seldon_core_tpu_torch.persistence.checkpoint save <model> <dir> [k=v ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any

import numpy as np

from seldon_core_tpu_torch.persistence import _msgpack


def _to_numpy(tree: Any) -> Any:
    from seldon_core_tpu_torch.models.convert import params_to_numpy

    return params_to_numpy(tree)


def save_model(path: str, model: str, params: Any, kwargs: dict | None = None) -> None:
    """Persist params (numpy or tensor leaves) and the zoo builder identity
    that owns the apply function."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"model": model, "kwargs": kwargs or {}}, f)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(_msgpack.to_bytes(_to_numpy(params)))


def _fill(template: Any, state: Any, at: str) -> Any:
    """The template's tree with each leaf taken from ``state`` (a flax state
    dict: lists are maps keyed by index)."""
    if isinstance(template, (dict, list, tuple)):
        keys = [str(k) for k in (template if isinstance(template, dict) else range(len(template)))]
        if not isinstance(state, dict):
            raise ValueError(f"checkpoint holds a leaf at {at or '/'} where the model has a subtree")
        missing = sorted(set(keys) - set(state))
        if missing:
            raise ValueError(f"checkpoint lacks {missing} at {at or '/'}")
        extra = sorted(set(state) - set(keys))
        if extra:
            raise ValueError(f"checkpoint holds {extra} at {at or '/'}, which the model does not have")
        if isinstance(template, dict):
            return {k: _fill(v, state[str(k)], f"{at}/{k}") for k, v in template.items()}
        return type(template)(_fill(v, state[str(i)], f"{at}/{i}") for i, v in enumerate(template))
    if isinstance(state, dict):
        raise ValueError(f"checkpoint holds a subtree at {at} where the model has a leaf")
    want = np.shape(template)
    got = np.shape(state)
    if want != got:
        raise ValueError(f"checkpoint leaf {at} has shape {got}, the model's has {want}")
    return np.asarray(state)


def restore_model(path: str):
    """The zoo ModelSpec with the checkpoint's parameters in place of the
    fresh init."""
    from seldon_core_tpu_torch.models import zoo

    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    name, kwargs = meta["model"], meta.get("kwargs", {})
    ms = zoo.get_model(name, **kwargs)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        state = _msgpack.restore(f.read())
    return dataclasses.replace(ms, params=_fill(ms.params, state, ""))


def _parse_kv(items: list[str]) -> dict:
    from seldon_core_tpu_torch.models.zoo import _parse_zoo_uri

    return _parse_zoo_uri("zoo://x?" + "&".join(items))[1]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="write a zoo model's seeded parameters as a file:// checkpoint")
    sub = parser.add_subparsers(dest="cmd", required=True)
    save = sub.add_parser("save", help="build zoo model <model> with the given kwargs and save it to <dir>")
    save.add_argument("model")
    save.add_argument("dir")
    save.add_argument("kwargs", nargs="*", help="builder kwargs as k=v (e.g. seed=0 max_len=512)")
    args = parser.parse_args(argv)
    from seldon_core_tpu_torch.models.zoo import get_model

    kwargs = _parse_kv(args.kwargs)
    save_model(args.dir, args.model, get_model(args.model, **kwargs).params, kwargs)
    print(f"saved {args.model} {kwargs} to {args.dir} (serve it as model_uri file://{args.dir})")


if __name__ == "__main__":
    main()
