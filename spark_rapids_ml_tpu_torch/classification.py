"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.classification`` ≙
``spark_rapids_ml_tpu.classification`` (LogisticRegression,
RandomForestClassifier and GBTClassifier)."""

from .models.classification import LogisticRegression, LogisticRegressionModel
from .models.tree import (
    GBTClassificationModel,
    GBTClassifier,
    RandomForestClassificationModel,
    RandomForestClassifier,
)

__all__ = [
    "GBTClassificationModel",
    "GBTClassifier",
    "LogisticRegression",
    "LogisticRegressionModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
]
