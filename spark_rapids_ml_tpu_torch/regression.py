"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.regression`` ≙
``spark_rapids_ml_tpu.regression``."""

from .models.regression import LinearRegression, LinearRegressionModel
from .models.tree import (
    GBTRegressionModel,
    GBTRegressor,
    RandomForestRegressionModel,
    RandomForestRegressor,
)

__all__ = [
    "GBTRegressionModel",
    "GBTRegressor",
    "LinearRegression",
    "LinearRegressionModel",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
]
