"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.feature`` ≙
``spark_rapids_ml_tpu.feature``."""

from .models.feature import PCA, PCAModel

__all__ = ["PCA", "PCAModel"]
