"""Torch MNIST-style classifier (the reference's deep_mnist example, a
restored TF softmax model with class names "class:0".."class:9"). A torch
CPU module is trained briefly at construction on a synthetic
digit-prototype task (MNIST is not bundled) and served through
``seldon_core_tpu_torch.models.adapters.TorchModelAdapter``. The same code
as the JAX package's copy, so the same seed gives the same outputs.

Serve it as a PYTHON_CLASS unit (``module`` DeepMnist, ``model_dir`` this
directory).
"""

import numpy as np
import torch

from seldon_core_tpu_torch.models.adapters import TorchModelAdapter


class DeepMnist:
    def __init__(self, train_steps: int = 60, seed: int = 0):
        torch.manual_seed(seed)
        rng = np.random.default_rng(seed)
        # synthetic task: 10 fixed 784-d prototypes + noise
        prototypes = rng.standard_normal((10, 784)).astype(np.float32)
        labels = rng.integers(0, 10, 512)
        X = prototypes[labels] + 0.3 * rng.standard_normal((512, 784)).astype(
            np.float32
        )

        module = torch.nn.Sequential(
            torch.nn.Linear(784, 128), torch.nn.ReLU(), torch.nn.Linear(128, 10)
        )
        opt = torch.optim.Adam(module.parameters(), lr=1e-3)
        xt = torch.as_tensor(X)
        yt = torch.as_tensor(labels)
        for _ in range(int(train_steps)):
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(module(xt), yt)
            loss.backward()
            opt.step()

        self._adapter = TorchModelAdapter(
            module, class_names=[f"class:{i}" for i in range(10)], softmax=True
        )
        self.class_names = self._adapter.class_names

    def predict(self, X, feature_names):
        return self._adapter.predict(X, feature_names)
