"""Train the iris classifier artifact (the reference's train_iris.py: a
LogisticRegression pipeline on the sklearn iris dataset, dumped with
joblib).

    python seldon_core_tpu_torch/examples/models/sklearn_iris/train_iris.py [out.joblib]
"""

import sys


def train(path: str = "IrisClassifier.joblib"):
    import joblib
    from sklearn import datasets
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import Pipeline

    iris = datasets.load_iris()
    p = Pipeline([("clf", LogisticRegression(max_iter=500))])
    p.fit(iris.data, iris.target)
    joblib.dump(p, path)
    return p


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "IrisClassifier.joblib"
    train(out)
    print(f"model saved to {out}")
