"""PyTorch MNIST CNN, the twin of the JAX package's
``examples/models/jax_mnist_cnn/MnistCnn.py`` (the reference's keras_mnist
slot: a conv net trained on MNIST-like data and served through the
wrapper).

The same numpy draws in the same order give the same synthetic
digit-prototype task (MNIST is not bundled) and the same He-initialised
parameters, drawn in the JAX example's layout and carried across by
``params_from_jax``: two 3x3 stride-2 "SAME" convolutions (8 and 16
channels, ReLU), a dense layer to 10 logits, softmax out. Training is
full-batch Adam(1e-3) for ``train_steps`` steps on ``device`` (the card
unless the caller names another); the trained forward stays there and
``predict`` reads the probabilities back to host numpy.

Serve it as a PYTHON_CLASS unit (``module`` MnistCnn, ``model_dir`` this
directory; ``seldon_core_tpu_torch/deployments/mnist_cnn.json``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.core.tensor import resolve_device

SIDE = 28  # input rows and columns
FEATURES = 7 * 7 * 16  # the dense layer's inputs: 16 channels of a 7x7 map


def _init_params(rng: np.random.Generator) -> dict:
    """The JAX example's draws: HWIO kernels, a [784, 10] dense layer whose
    rows are in NHWC flatten order."""

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return {
        "conv1": {"w": he((3, 3, 1, 8), 9), "b": np.zeros((8,), np.float32)},
        "conv2": {"w": he((3, 3, 8, 16), 72), "b": np.zeros((16,), np.float32)},
        "dense": {"w": he((FEATURES, 10), 784), "b": np.zeros((10,), np.float32)},
    }


def params_from_jax(tree: dict) -> dict:
    """The JAX example's parameters in this model's layout: HWIO kernels
    become OIHW, and the dense rows move from NHWC flatten order
    ((h * 7 + w) * 16 + c) to NCHW order (c * 49 + h * 7 + w)."""
    dense = np.asarray(tree["dense"]["w"])
    return {
        "conv1": {"w": np.asarray(tree["conv1"]["w"]).transpose(3, 2, 0, 1).copy(),
                  "b": np.asarray(tree["conv1"]["b"])},
        "conv2": {"w": np.asarray(tree["conv2"]["w"]).transpose(3, 2, 0, 1).copy(),
                  "b": np.asarray(tree["conv2"]["b"])},
        "dense": {"w": dense.reshape(7, 7, 16, 10).transpose(2, 0, 1, 3).reshape(FEATURES, 10).copy(),
                  "b": np.asarray(tree["dense"]["b"])},
    }


def _apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, 784] float -> [N, 10] logits. "SAME" at stride 2 on an even side
    pads one row and one column after the image, none before."""
    h = x.reshape(-1, 1, SIDE, SIDE)
    for name in ("conv1", "conv2"):
        h = F.conv2d(F.pad(h, (0, 1, 0, 1)), p[name]["w"], stride=2)
        h = torch.relu(h + p[name]["b"][None, :, None, None])
    return h.reshape(h.shape[0], -1) @ p["dense"]["w"] + p["dense"]["b"]


class MnistCnn:
    def __init__(self, train_steps: int = 80, seed: int = 0, device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(int(seed))
        prototypes = rng.standard_normal((10, 784)).astype(np.float32)
        labels = rng.integers(0, 10, 512)
        X = prototypes[labels] + 0.3 * rng.standard_normal((512, 784)).astype(np.float32)
        self.initial_params = params_from_jax(_init_params(rng))

        params = {
            layer: {k: torch.from_numpy(v).to(self.device).requires_grad_() for k, v in leaves.items()}
            for layer, leaves in self.initial_params.items()
        }
        leaves = [t for layer in params.values() for t in layer.values()]
        optimizer = torch.optim.Adam(leaves, lr=1e-3)
        x = torch.from_numpy(X).to(self.device)
        y = torch.from_numpy(labels).to(self.device)
        for _ in range(int(train_steps)):
            optimizer.zero_grad()
            F.cross_entropy(_apply(params, x), y).backward()
            optimizer.step()
        self._params = {layer: {k: t.detach() for k, t in leaves.items()} for layer, leaves in params.items()}
        self.train_x, self.train_y = X, labels
        self.class_names = [f"class:{i}" for i in range(10)]

    def forward(self, X) -> torch.Tensor:
        """Softmax probabilities on ``self.device``."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(X, np.float32)).to(self.device)
            return torch.softmax(_apply(self._params, x), dim=-1)

    def predict(self, X, feature_names):
        return self.forward(X).cpu().numpy()
