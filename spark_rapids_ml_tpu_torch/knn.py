"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.knn`` ≙
``spark_rapids_ml_tpu.knn`` (exact search only)."""

from .models.knn import NearestNeighbors, NearestNeighborsModel

__all__ = ["NearestNeighbors", "NearestNeighborsModel"]
