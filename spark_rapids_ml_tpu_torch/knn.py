"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.knn`` ≙
``spark_rapids_ml_tpu.knn`` (exact and IVF-Flat approximate search)."""

from .models.knn import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)

__all__ = [
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "NearestNeighbors",
    "NearestNeighborsModel",
]
