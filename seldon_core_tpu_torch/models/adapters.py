"""Framework adapters: serve a model of another framework as a graph node.

Port of ``seldon_core_tpu/models/adapters.py``. Each adapter makes an
object with the duck-typed ``predict(X, feature_names)`` contract that a
PYTHON_CLASS unit serves (``engine/units.py::PythonClassUnit``):

- ``FunctionModelAdapter``: any f(np.ndarray) -> np.ndarray;
- ``TorchModelAdapter``: a ``torch.nn.Module`` in eval mode on the host
  CPU, numpy out — the reference's contract, kept: a module on the card
  belongs in a zoo model served as JAX_MODEL, not behind this adapter;
- ``SklearnModelAdapter``: an estimator with ``predict_proba`` (preferred)
  or ``predict``, duck-typed: this module imports no sklearn.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np


class FunctionModelAdapter:
    """Wrap a plain function as a duck-typed model."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], class_names: Sequence[str] = ()):
        self._fn = fn
        if class_names:
            self.class_names = list(class_names)

    def predict(self, X: np.ndarray, feature_names) -> np.ndarray:
        return np.asarray(self._fn(np.asarray(X)))


class TorchModelAdapter:
    """Wrap a torch.nn.Module (eval mode, CPU) as a duck-typed model."""

    def __init__(self, module: Any, class_names: Sequence[str] = (), softmax: bool = False):
        import torch

        self._torch = torch
        self._module = module.eval()
        self._softmax = softmax
        if class_names:
            self.class_names = list(class_names)

    def predict(self, X: np.ndarray, feature_names) -> np.ndarray:
        torch = self._torch
        with torch.no_grad():
            t = torch.as_tensor(np.asarray(X, dtype=np.float32))
            out = self._module(t)
            if self._softmax:
                out = torch.softmax(out, dim=-1)
        return out.cpu().numpy()


class SklearnModelAdapter:
    """Wrap an sklearn-style estimator (predict_proba preferred)."""

    def __init__(self, estimator: Any, class_names: Sequence[str] = ()):
        self._est = estimator
        if class_names:
            self.class_names = list(class_names)
        elif hasattr(estimator, "classes_"):
            self.class_names = [str(c) for c in estimator.classes_]

    def predict(self, X: np.ndarray, feature_names) -> np.ndarray:
        if hasattr(self._est, "predict_proba"):
            return np.asarray(self._est.predict_proba(np.asarray(X)))
        out = np.asarray(self._est.predict(np.asarray(X)))
        return out if out.ndim == 2 else out[:, None]
