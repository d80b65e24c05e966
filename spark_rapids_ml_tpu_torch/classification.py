"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.classification`` ≙
``spark_rapids_ml_tpu.classification`` (the logistic half; the tree
classifiers come with a later slice)."""

from .models.classification import LogisticRegression, LogisticRegressionModel

__all__ = ["LogisticRegression", "LogisticRegressionModel"]
