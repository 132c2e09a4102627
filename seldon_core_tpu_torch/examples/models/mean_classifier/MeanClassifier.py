"""Example user model (the reference's mean_classifier): the sigmoid of
each row's mean. Numpy only.

Serve it as a PYTHON_CLASS unit (``module`` MeanClassifier, ``model_dir``
this directory).
"""

import numpy as np


class MeanClassifier:
    def __init__(self, intValue=0):
        self.intValue = intValue
        self.class_names = ["proba"]

    def predict(self, X, feature_names):
        return 1.0 / (1.0 + np.exp(-np.mean(X, axis=1, keepdims=True)))
