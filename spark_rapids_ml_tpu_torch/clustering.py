"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.clustering`` ≙
``spark_rapids_ml_tpu.clustering``."""

from .models.clustering import KMeans, KMeansModel

__all__ = ["KMeans", "KMeansModel"]
