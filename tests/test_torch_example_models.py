"""The port's copies of the example models against the JAX package's.

- ``DeepMnist`` is the same torch CPU code in both packages: outputs are
  bit-identical.
- ``GbmClassifier`` and ``SigmoidPredictor`` serve the same sklearn fit
  through each package's ``SklearnModelAdapter``: bit-identical.
- ``MnistCnn``: the torch twin draws the JAX example's parameters (carried
  across by ``params_from_jax``: HWIO -> OIHW, dense rows from NHWC to
  NCHW flatten order) bit for bit; untrained, its probabilities agree
  with the JAX forward within atol 1e-5 (float32 convolutions summed in
  another order); trained 80 Adam(1e-3) steps each, the two reach the same
  accuracy on the synthetic set within 2 points (torch.optim.Adam and
  optax.adam round differently). Measured on the CPU: both at 100.0%
  after 80 steps (a gap of 0 points), probabilities within 3.6e-7.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from seldon_core_tpu.serving.microservice import load_user_object as jax_load
from seldon_core_tpu_torch.examples.models.torch_mnist_cnn import MnistCnn as cnn_module
from seldon_core_tpu_torch.serving.microservice import load_user_object

ROOT = Path(__file__).resolve().parents[1]
PORT_MODELS = ROOT / "seldon_core_tpu_torch" / "examples" / "models"
JAX_MODELS = ROOT / "examples" / "models"
CNN_ATOL = 1e-5
ACCURACY_POINTS = 2.0


def _both(module: str, folder: str, params: dict, jax_folder: str | None = None):
    return (load_user_object(module, str(PORT_MODELS / folder), dict(params)),
            jax_load(module, str(JAX_MODELS / (jax_folder or folder)), dict(params)))


def test_deep_mnist_is_the_jax_packages():
    ours, theirs = _both("DeepMnist", "deep_mnist", {"train_steps": 20})
    x = np.random.default_rng(0).normal(size=(6, 784)).astype(np.float32)
    np.testing.assert_array_equal(ours.predict(x, []), theirs.predict(x, []))
    assert ours.class_names == theirs.class_names


@pytest.mark.parametrize("module,folder,params,features", [
    ("GbmClassifier", "gbm_classifier", {"max_iter": 20}, 30),
    ("SigmoidPredictor", "sigmoid_predictor", {"nb_samples": 400}, 10),
])
def test_sklearn_examples_through_the_ports_adapter(module, folder, params, features):
    pytest.importorskip("sklearn")
    ours, theirs = _both(module, folder, params)
    x = np.random.default_rng(1).normal(size=(7, features)) * 10
    got = ours.predict(x, [])
    np.testing.assert_array_equal(got, theirs.predict(x, []))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-9)
    assert ours.class_names == theirs.class_names


def test_adapters_hold_the_reference_contract():
    import torch

    from seldon_core_tpu_torch.models.adapters import FunctionModelAdapter, SklearnModelAdapter, TorchModelAdapter

    module = torch.nn.Linear(3, 2).train()
    adapter = TorchModelAdapter(module, class_names=["a", "b"], softmax=True)
    assert not module.training and adapter.class_names == ["a", "b"]
    out = adapter.predict([[1, 2, 3]], [])
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-6)
    assert FunctionModelAdapter(lambda x: x + 1).predict([1.0], []).tolist() == [2.0]

    class Labels:  # duck-typed: predict only, 1-D out
        classes_ = [0, 1]

        def predict(self, X):
            return np.asarray(X).sum(axis=1)

    sk = SklearnModelAdapter(Labels())
    assert sk.class_names == ["0", "1"] and sk.predict([[1, 2], [3, 4]], []).tolist() == [[3], [7]]


def _jax_cnn(train_steps: int):
    return jax_load("MnistCnn", str(JAX_MODELS / "jax_mnist_cnn"), {"train_steps": train_steps})


def test_mnist_cnn_draws_the_jax_parameters_and_forward():
    theirs = _jax_cnn(0)
    ours = load_user_object("MnistCnn", str(PORT_MODELS / "torch_mnist_cnn"), {"train_steps": 0, "device": "cpu"})
    carried = cnn_module.params_from_jax(jax.tree.map(np.asarray, theirs._params))
    assert jax.tree.structure(carried) == jax.tree.structure(ours.initial_params)
    for a, b in zip(jax.tree.leaves(ours.initial_params), jax.tree.leaves(carried), strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = ours.train_x[:64]
    got = ours.predict(x, [])
    np.testing.assert_allclose(got, theirs.predict(x, []), rtol=0, atol=CNN_ATOL)
    assert got.shape == (64, 10) and ours.class_names == theirs.class_names


def test_mnist_cnn_dense_layout_matches_the_jax_flatten():
    """Row (h * 7 + w) * 16 + c of the JAX dense layer becomes row
    c * 49 + h * 7 + w here."""
    dense = np.arange(784 * 10, dtype=np.float32).reshape(784, 10)
    tree = {k: {"w": np.zeros((3, 3, 1 if k == "conv1" else 8, 8 if k == "conv1" else 16), np.float32),
                "b": np.zeros(8 if k == "conv1" else 16, np.float32)} for k in ("conv1", "conv2")}
    tree["dense"] = {"w": dense, "b": np.zeros(10, np.float32)}
    out = cnn_module.params_from_jax(tree)["dense"]["w"]
    for c, h, w in ((0, 0, 0), (3, 2, 5), (15, 6, 6)):
        np.testing.assert_array_equal(out[c * 49 + h * 7 + w], dense[(h * 7 + w) * 16 + c])
    assert out.shape == (784, 10) and out.flags["C_CONTIGUOUS"]


def test_mnist_cnn_trains_to_the_jax_accuracy():
    theirs = _jax_cnn(80)
    ours = load_user_object("MnistCnn", str(PORT_MODELS / "torch_mnist_cnn"), {"device": "cpu"})
    x, y = ours.train_x, ours.train_y

    def accuracy(model):
        return 100.0 * float((model.predict(x, []).argmax(axis=1) == y).mean())

    ours_acc, theirs_acc = accuracy(ours), accuracy(theirs)
    assert ours_acc > 50.0, ours_acc  # it learned the prototypes
    assert abs(ours_acc - theirs_acc) <= ACCURACY_POINTS, (ours_acc, theirs_acc)
