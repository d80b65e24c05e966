"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.regression`` ≙
``spark_rapids_ml_tpu.regression`` (RandomForestRegressor; the linear
regressor comes with a later slice)."""

from .models.tree import RandomForestRegressionModel, RandomForestRegressor

__all__ = ["RandomForestRegressionModel", "RandomForestRegressor"]
