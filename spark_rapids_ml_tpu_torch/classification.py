"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.classification`` ≙
``spark_rapids_ml_tpu.classification`` (LogisticRegression,
RandomForestClassifier, GBTClassifier and OneVsRest)."""

from .models.classification import LogisticRegression, LogisticRegressionModel
from .models.tree import (
    GBTClassificationModel,
    GBTClassifier,
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from .pipeline import OneVsRest, OneVsRestModel  # pyspark.ml.classification layout

__all__ = [
    "GBTClassificationModel",
    "GBTClassifier",
    "LogisticRegression",
    "LogisticRegressionModel",
    "OneVsRest",
    "OneVsRestModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
]
