"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.regression`` ≙
``spark_rapids_ml_tpu.regression`` (RandomForestRegressor and
GBTRegressor; the linear regressor comes with a later slice)."""

from .models.tree import (
    GBTRegressionModel,
    GBTRegressor,
    RandomForestRegressionModel,
    RandomForestRegressor,
)

__all__ = ["GBTRegressionModel", "GBTRegressor", "RandomForestRegressionModel", "RandomForestRegressor"]
