"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.classification`` ≙
``spark_rapids_ml_tpu.classification`` (LogisticRegression and
RandomForestClassifier)."""

from .models.classification import LogisticRegression, LogisticRegressionModel
from .models.tree import RandomForestClassificationModel, RandomForestClassifier

__all__ = [
    "LogisticRegression",
    "LogisticRegressionModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
]
