"""Fitted-sklearn user model (the reference's sklearn_iris example: loads a
joblib artifact and serves predict_proba) through
``seldon_core_tpu_torch.models.adapters.SklearnModelAdapter``. Needs
sklearn and joblib on the serving host.

    python seldon_core_tpu_torch/examples/models/sklearn_iris/train_iris.py

then serve it as a PYTHON_CLASS unit (``module`` IrisClassifier,
``model_dir`` this directory).
"""

import os

from seldon_core_tpu_torch.models.adapters import SklearnModelAdapter


class IrisClassifier:
    def __init__(self, model_file: str = ""):
        import joblib

        path = model_file or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "IrisClassifier.joblib"
        )
        if not os.path.exists(path):
            # self-healing dev flow: fit the reference pipeline on the spot
            from train_iris import train  # same directory

            train(path)
        self._adapter = SklearnModelAdapter(
            joblib.load(path), class_names=["setosa", "versicolor", "virginica"]
        )
        self.class_names = self._adapter.class_names

    def predict(self, X, feature_names):
        return self._adapter.predict(X, feature_names)
