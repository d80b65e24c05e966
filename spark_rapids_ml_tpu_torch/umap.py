"""Drop-in module alias: ``spark_rapids_ml_tpu_torch.umap`` ≙
``spark_rapids_ml_tpu.umap``."""

from .models.umap import UMAP, UMAPModel

__all__ = ["UMAP", "UMAPModel"]
