"""Example outlier-scoring user class (the reference's paysim fraud
detector and its OUTLIER_DETECTOR wrapper tier). It scores transactions
(amount, oldBalance, newBalance) against stored per-feature statistics —
the max |z| the built-in OUTLIER_DETECTOR unit computes — so it runs with
no model artifact. Numpy only.

Wrapped in ``engine/units.py::OutlierDetectorUnit`` every response carries
``meta.tags.outlierScore``; ``seldon_core_tpu_torch/deployments/
fraud_outlier.json`` runs the built-in equivalent ahead of a MODEL node.
"""

import numpy as np


class FraudDetector:
    def __init__(self, threshold=4.0):
        # training-set stats for (amount, oldBalance, newBalance), pretend-fit
        self.means = np.asarray([178197.0, 833883.0, 855113.0])
        self.stds = np.asarray([603858.0, 2888243.0, 2924048.0])
        self.threshold = float(threshold)

    def score(self, X, feature_names):
        """Single float per request: worst feature z-score in the batch."""
        z = np.abs((np.asarray(X, np.float64) - self.means) / self.stds)
        return float(np.max(z))
