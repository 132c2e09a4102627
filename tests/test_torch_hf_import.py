"""``hf-bert://`` in the port against the JAX package's branch.

A tiny ``BertForSequenceClassification`` (hidden 128, 3 layers, 2 heads,
64 positions, 3 labels, the JAX ``tests/test_hf_import.py`` geometry) is
saved with ``save_pretrained`` as safetensors, as sharded safetensors and
as ``pytorch_model.bin``. The JAX package reads each directory with
``transformers``; the port reads the files itself. Tolerances: float32
probabilities of the two packages within atol 1e-5 (the same arrays run
through two float32 forwards); against the torch model rtol 5e-3 / atol
5e-4, the JAX test's (layernorm eps 1e-12 there, 1e-6 here).
"""

import json
import struct

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

from seldon_core_tpu.graph.spec import TpuSpec as JaxTpuSpec  # noqa: E402
from seldon_core_tpu.models.zoo import build_runtime_from_uri as jax_build  # noqa: E402
from seldon_core_tpu_torch.graph.spec import TpuSpec  # noqa: E402
from seldon_core_tpu_torch.models.hf_import import load_hf_bert_dir, read_safetensors  # noqa: E402
from seldon_core_tpu_torch.models.zoo import build_runtime_from_uri  # noqa: E402

PACKAGES_ATOL = 1e-5
TORCH_TOL = dict(rtol=5e-3, atol=5e-4)
SEQ = 16
LABELS = {0: "neg", 1: "neutral", 2: "pos"}
FORMS = ("safetensors", "sharded", "bin")


def _tiny_hf_bert(seed=0, headless=False):
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
        intermediate_size=256, max_position_embeddings=64, num_labels=3, hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0, id2label=LABELS,
    )
    torch.manual_seed(seed)
    cls = transformers.BertModel if headless else transformers.BertForSequenceClassification
    return cls(cfg).eval()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    model = _tiny_hf_bert()
    dirs = {}
    for form in FORMS:
        d = tmp_path_factory.mktemp(form)
        kw = {"safe_serialization": form != "bin"}
        if form == "sharded":
            kw["max_shard_size"] = "200KB"
        model.save_pretrained(d, **kw)
        dirs[form] = d
    return model, dirs


def _runtimes(uri):
    port = build_runtime_from_uri(uri, TpuSpec(batch_buckets=(4,), max_batch=4), "cpu")
    theirs = jax_build(uri, JaxTpuSpec(batch_buckets=[4], max_batch=4))
    return port, theirs


@pytest.mark.parametrize("form", FORMS)
def test_hf_bert_serves_as_the_jax_branch(saved, form):
    model, dirs = saved
    files = {p.name for p in dirs[form].iterdir()}
    want_file = {"safetensors": "model.safetensors", "sharded": "model.safetensors.index.json",
                 "bin": "pytorch_model.bin"}[form]
    assert want_file in files, files
    port, theirs = _runtimes(f"hf-bert://{dirs[form]}?seq={SEQ}")
    ids = np.random.default_rng(0).integers(0, 128, (4, SEQ))
    got = port.predict(ids)
    ref = np.asarray(theirs.predict(ids))
    assert got.shape == (4, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=PACKAGES_ATOL)
    with torch.no_grad():
        want = torch.softmax(model(input_ids=torch.as_tensor(ids)).logits, -1).numpy()
    np.testing.assert_allclose(got, want, **TORCH_TOL)
    assert port.class_names == tuple(theirs.class_names) == ("neg", "neutral", "pos")
    assert port.feature_shape == (SEQ,)


def test_reader_equals_the_safetensors_library(saved):
    _, dirs = saved
    path = str(dirs["safetensors"] / "model.safetensors")
    ours, lib = read_safetensors(path), safetensors_numpy.load_file(path)
    assert set(ours) == {k for k in lib if not k.endswith("position_ids")}
    for k, v in ours.items():
        np.testing.assert_array_equal(v, lib[k].astype(np.float32))
    state, config = load_hf_bert_dir(str(dirs["bin"]))
    torch_state = _tiny_hf_bert().state_dict()
    assert set(state) == {k for k in torch_state if not k.endswith("position_ids")}
    for k, v in state.items():
        np.testing.assert_array_equal(v, torch_state[k].numpy())
    assert config["id2label"] == {str(k): v for k, v in LABELS.items()}


def test_seq_over_the_position_table_fails_as_in_jax(saved):
    _, dirs = saved
    uri = f"hf-bert://{dirs['safetensors']}?seq=128"
    with pytest.raises(ValueError) as theirs:
        jax_build(uri, JaxTpuSpec())
    with pytest.raises(ValueError) as ours:
        build_runtime_from_uri(uri, TpuSpec(), "cpu")
    assert str(ours.value) == str(theirs.value)
    assert "max_position_embeddings=64" in str(ours.value)


def test_unit_parameters_merge_under_the_uri_query(saved):
    """The URI's ``seq`` wins over a unit parameter's; ``attn_kernel`` from
    the unit parameters picks the apply; ``seq_parallel`` is accepted."""
    _, dirs = saved
    uri = f"hf-bert://{dirs['safetensors']}?seq={SEQ}"
    extra = {"seq": 32, "attn_kernel": "blockwise", "seq_parallel": "ring"}
    port = build_runtime_from_uri(uri, TpuSpec(batch_buckets=(4,), max_batch=4), "cpu", extra_params=extra)
    theirs = jax_build(uri, JaxTpuSpec(batch_buckets=[4], max_batch=4), extra_params=extra)
    assert port.feature_shape == tuple(theirs.feature_shape) == (SEQ,)
    ids = np.random.default_rng(1).integers(0, 128, (3, SEQ))
    np.testing.assert_allclose(port.predict(ids), np.asarray(theirs.predict(ids)), rtol=0, atol=PACKAGES_ATOL)


def test_headless_checkpoint_is_refused_by_name(tmp_path):
    """from_pretrained would draw the head at random (the JAX branch serves
    that); the port refuses it."""
    _tiny_hf_bert(headless=True).save_pretrained(tmp_path)
    with pytest.raises(ValueError, match="classifier.weight"):
        build_runtime_from_uri(f"hf-bert://{tmp_path}", TpuSpec(), "cpu")


def test_bf16_checkpoint_loads(tmp_path):
    model = _tiny_hf_bert(seed=4)
    model.to(torch.bfloat16).save_pretrained(tmp_path)
    raw = (tmp_path / "model.safetensors").read_bytes()
    header = json.loads(raw[8 : 8 + struct.unpack("<Q", raw[:8])[0]])
    assert any(v.get("dtype") == "BF16" for k, v in header.items() if k != "__metadata__")
    state, _ = load_hf_bert_dir(str(tmp_path))
    for k, v in model.state_dict().items():
        if k in state:
            np.testing.assert_array_equal(state[k], v.float().numpy())
    port = build_runtime_from_uri(f"hf-bert://{tmp_path}?seq={SEQ}", TpuSpec(batch_buckets=(2,), max_batch=2), "cpu")
    ids = np.random.default_rng(2).integers(0, 128, (2, SEQ))
    with torch.no_grad():
        want = torch.softmax(model.float()(input_ids=torch.as_tensor(ids)).logits, -1).numpy()
    np.testing.assert_allclose(port.predict(ids), want, **TORCH_TOL)


def test_default_labels_without_id2label(tmp_path, saved):
    """A config.json without id2label gets transformers' default names."""
    _, dirs = saved
    for p in dirs["safetensors"].iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg.pop("id2label")
    cfg.pop("label2id")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    port = build_runtime_from_uri(f"hf-bert://{tmp_path}?seq={SEQ}", TpuSpec(), "cpu")
    assert port.class_names == ("LABEL_0", "LABEL_1", "LABEL_2")
