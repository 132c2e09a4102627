"""Gradient-boosted-trees classifier (the reference's h2o_example: a GBM on
a binary task served through the wrapper): an sklearn
HistGradientBoostingClassifier fitted at construction on the bundled
breast-cancer dataset (binary, 30 features), served through
``seldon_core_tpu_torch.models.adapters.SklearnModelAdapter``. Needs
sklearn on the serving host.

Serve it as a PYTHON_CLASS unit (``module`` GbmClassifier, ``model_dir``
this directory; ``seldon_core_tpu_torch/deployments/gbm.json``).
"""

from seldon_core_tpu_torch.models.adapters import SklearnModelAdapter


class GbmClassifier:
    def __init__(self, max_iter: int = 60, seed: int = 0):
        from sklearn.datasets import load_breast_cancer
        from sklearn.ensemble import HistGradientBoostingClassifier

        data = load_breast_cancer()
        gbm = HistGradientBoostingClassifier(
            max_iter=int(max_iter), random_state=int(seed)
        )
        gbm.fit(data.data, data.target)
        self._adapter = SklearnModelAdapter(
            gbm, class_names=["malignant", "benign"]
        )
        self.class_names = self._adapter.class_names
        self.feature_names = list(data.feature_names)

    def predict(self, X, feature_names):
        return self._adapter.predict(X, feature_names)
