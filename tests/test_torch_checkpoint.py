"""``file://`` checkpoints between the port and the JAX package.

Each package restores the other's ``metadata.json`` + ``params.msgpack``
(flax's format; the port writes it with its own codec). ``iris_mlp`` seed 3
(drawn differently by the two packages: the restored arrays are the
writer's) and ``bert_tiny`` with ``max_len`` 32 (drawn identically: the
restored arrays are bit-identical both ways), as the JAX
``tests/test_models_heavy.py`` checkpoint tests use them. Predictions of
the restored models agree within rtol 2e-4 / atol 2e-5 (float32, the
port's BERT tolerance against the JAX model).
"""

import json
import logging

import jax
import numpy as np
import pytest

from flax import serialization
from seldon_core_tpu.graph.spec import TpuSpec as JaxTpuSpec
from seldon_core_tpu.models import zoo as jax_zoo
from seldon_core_tpu.models.zoo import build_runtime_from_uri as jax_build
from seldon_core_tpu.persistence import checkpoint as jax_ckpt
from seldon_core_tpu_torch.graph.spec import TpuSpec
from seldon_core_tpu_torch.models import zoo
from seldon_core_tpu_torch.models.zoo import build_runtime_from_uri
from seldon_core_tpu_torch.persistence import _msgpack, checkpoint

TOL = dict(rtol=2e-4, atol=2e-5)
CASES = {"iris_mlp": {"seed": 3}, "bert_tiny": {"max_len": 32}}


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _inputs(name):
    rng = np.random.default_rng(5)
    if name == "iris_mlp":
        return rng.uniform(0, 8, (3, 4)).astype(np.float32)
    return rng.integers(0, 1024, (3, 16))


def _predict_both(tmp_path, path, name):
    port = build_runtime_from_uri(f"file://{path}", TpuSpec(batch_buckets=(4,), max_batch=4), "cpu")
    theirs = jax_build(f"file://{path}", JaxTpuSpec(batch_buckets=[4], max_batch=4))
    x = _inputs(name)
    return port.predict(x), np.asarray(theirs.predict(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_checkpoint_restores_in_the_port(tmp_path, name):
    kwargs = CASES[name]
    jms = jax_zoo.get_model(name, **kwargs)
    path = str(tmp_path / "ckpt")
    jax_ckpt.save_model(path, name, jms.params, kwargs)
    ours = checkpoint.restore_model(path)
    for a, b in zip(_leaves(ours.params), _leaves(jms.params), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got, ref = _predict_both(tmp_path, path, name)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    kwargs = CASES[name]
    ms = zoo.get_model(name, **kwargs)
    path = str(tmp_path / "ckpt")
    checkpoint.save_model(path, name, ms.params, kwargs)
    theirs = jax_ckpt.restore_model(path)
    for a, b in zip(_leaves(theirs.params), _leaves(ms.params), strict=True):
        np.testing.assert_array_equal(a, b)
    if name == "bert_tiny":  # drawn identically by both packages
        for a, b in zip(_leaves(theirs.params), _leaves(jax_zoo.get_model(name, **kwargs).params), strict=True):
            np.testing.assert_array_equal(a, b)
    got, ref = _predict_both(tmp_path, path, name)
    np.testing.assert_allclose(got, ref, **TOL)
    assert json.loads((tmp_path / "ckpt" / "metadata.json").read_text()) == {"model": name, "kwargs": kwargs}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_bytes_are_flax_bytes(name):
    """The codec writes what flax writes, byte for byte, and flax's
    msgpack_restore reads it."""
    params = zoo.get_model(name, **CASES[name]).params
    ours = _msgpack.to_bytes(params)
    assert ours == serialization.to_bytes(params)
    restored = serialization.msgpack_restore(ours)
    assert jax.tree.structure(restored) == jax.tree.structure(serialization.to_state_dict(params))
    for a, b in zip(jax.tree.leaves(restored), _leaves(params), strict=True):
        np.testing.assert_array_equal(a, b)


def test_scalars_lists_and_bfloat16_round_trip():
    """The rest of the subset: numpy scalars (ext 3), Python scalars, str,
    bytes, None, bool, long maps and arrays, and flax's bfloat16 leaves."""
    import jax.numpy as jnp

    tree = {"s": np.float32(1.5), "i": np.int64(-7), "n": None, "t": True, "f": 0.25, "big": 2**40,
            "neg": -200, "str": "x" * 40, "raw": b"\x00\x01" * 200, "many": {str(i): i for i in range(20)},
            "list": [np.arange(3, dtype=np.int32), np.zeros((0, 2), np.float32)]}
    ours = _msgpack.to_bytes(tree)
    assert ours == serialization.to_bytes(tree)
    back = _msgpack.restore(ours)
    assert back["s"] == np.float32(1.5) and type(back["s"]) is np.float32
    assert back["big"] == 2**40 and back["neg"] == -200 and back["raw"] == b"\x00\x01" * 200
    np.testing.assert_array_equal(back["list"]["0"], np.arange(3))
    bf = {"w": np.asarray(jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16))}
    got = _msgpack.restore(serialization.to_bytes(bf))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf["w"].astype(np.float32))


def test_chunked_leaves_round_trip(tmp_path, monkeypatch):
    """A leaf over MAX_CHUNK_SIZE bytes is stored chunked; with a small
    limit on both sides, each package restores the other's chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 4096)
    kwargs = CASES["bert_tiny"]
    ms = zoo.get_model("bert_tiny", **kwargs)
    assert _msgpack.to_bytes(ms.params) == serialization.to_bytes(ms.params)
    state = _msgpack.to_state_dict(ms.params)
    assert state["tok_emb"][_msgpack.CHUNKED] and len(state["tok_emb"]["chunks"]) == 1024 * 128 * 4 // 4096
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_model(jax_dir, "bert_tiny", jax_zoo.get_model("bert_tiny", **kwargs).params, kwargs)
    checkpoint.save_model(port_dir, "bert_tiny", ms.params, kwargs)
    for restored in (checkpoint.restore_model(jax_dir).params, jax_ckpt.restore_model(port_dir).params):
        for a, b in zip(_leaves(restored), _leaves(ms.params), strict=True):
            np.testing.assert_array_equal(a, b)


def _tampered(tmp_path, edit):
    params = jax.tree.map(np.asarray, jax_zoo.get_model("iris_mlp", seed=3).params)
    params = edit(params)
    path = str(tmp_path / "bad")
    jax_ckpt.save_model(path, "iris_mlp", params, {"seed": 3})
    return path


def test_structure_and_shape_refusals(tmp_path):
    def drop(p):
        del p["l2"]["b"]
        return p

    path = _tampered(tmp_path, drop)
    with pytest.raises(ValueError, match=r"lacks \['b'\] at /l2"):
        checkpoint.restore_model(path)
    with pytest.raises(ValueError, match="do not match"):  # flax refuses a missing key too
        jax_ckpt.restore_model(path)
    extra = _tampered(tmp_path, lambda p: {**p, "l3": {"w": np.ones((2, 2), np.float32)}})
    with pytest.raises(ValueError, match=r"holds \['l3'\] at /"):
        checkpoint.restore_model(extra)
    shape = _tampered(tmp_path, lambda p: {**p, "l1": {"w": np.ones((4, 7), np.float32), "b": p["l1"]["b"]}})
    with pytest.raises(ValueError, match=r"/l1/w has shape \(4, 7\), the model's has \(4, 32\)"):
        checkpoint.restore_model(shape)


def test_file_uri_warns_about_unit_parameters_and_keeps_int_inputs(tmp_path, caplog):
    """Extra unit parameters are ignored with the JAX package's warning. The
    port keeps the template's integer-input rule (token ids stay int32);
    the JAX restore drops it to the default ``cast``."""
    path = str(tmp_path / "ckpt")
    checkpoint.save_model(path, "bert_tiny", zoo.get_model("bert_tiny", max_len=32).params, {"max_len": 32})
    with caplog.at_level(logging.WARNING):
        rt = build_runtime_from_uri(f"file://{path}", TpuSpec(), "cpu", extra_params={"seq": 8})
    assert "file:// checkpoints ignore extra unit parameters ['seq']" in caplog.text
    assert rt.feature_shape == (16,) and rt.int_inputs == "ids"
    assert jax_ckpt.restore_model(path).int_inputs == "cast"


def test_save_cli_writes_a_checkpoint_jax_restores(tmp_path, capsys):
    path = str(tmp_path / "cli")
    checkpoint.main(["save", "iris_mlp", path, "seed=3", "hidden=16"])
    assert "file://" in capsys.readouterr().out
    theirs = jax_ckpt.restore_model(path)
    for a, b in zip(_leaves(theirs.params), _leaves(zoo.get_model("iris_mlp", seed=3, hidden=16).params),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(checkpoint.restore_model(path).params), _leaves(theirs.params), strict=True):
        np.testing.assert_array_equal(a, b)


FORMAT_LIBRARIES = {"transformers", "safetensors", "flax", "msgpack", "sklearn", "joblib"}


def _imports(path, top_level_only: bool):
    import ast

    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = tree.body if top_level_only else list(ast.walk(tree))
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_needs_none_of_the_format_libraries():
    """The card's host has none of them: the port reads and writes HF,
    safetensors and flax files itself. The sklearn example models (user
    code, like the reference's) import sklearn inside their constructors
    only, so their modules import on a host without it."""
    from pathlib import Path

    package = Path(__file__).resolve().parents[1] / "seldon_core_tpu_torch"
    examples = package / "examples"
    bad = [(str(f), m) for f in sorted(package.rglob("*.py")) if examples not in f.parents
           for m in _imports(f, False) if m in FORMAT_LIBRARIES]
    bad += [(str(f), m) for f in sorted(examples.rglob("*.py")) for m in _imports(f, True) if m in FORMAT_LIBRARIES]
    assert bad == []
