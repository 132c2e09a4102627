"""Fitted-MLP user model (the reference's sigmoid_predictor example: fits an
sklearn MLPClassifier at construction on a synthetic sigmoid(x0*x1) task
and serves predict_proba) through
``seldon_core_tpu_torch.models.adapters.SklearnModelAdapter``. Needs
sklearn on the serving host.

Serve it as a PYTHON_CLASS unit (``module`` SigmoidPredictor,
``model_dir`` this directory).
"""

import numpy as np

from seldon_core_tpu_torch.models.adapters import SklearnModelAdapter


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class SigmoidPredictor:
    def __init__(self, nb_samples: int = 2000, seed: int = 0):
        from sklearn.neural_network import MLPClassifier

        rng = np.random.default_rng(seed)
        X = rng.normal(size=(int(nb_samples), 10))
        y = (sigmoid(X[:, 0] * X[:, 1]) >= 0.5).astype(int)
        ffnn = MLPClassifier(hidden_layer_sizes=(32,), max_iter=200, random_state=0)
        ffnn.fit(X, y)
        self._adapter = SklearnModelAdapter(ffnn, class_names=["p0", "p1"])
        self.class_names = self._adapter.class_names

    def predict(self, X, feature_names):
        return self._adapter.predict(X, feature_names)
