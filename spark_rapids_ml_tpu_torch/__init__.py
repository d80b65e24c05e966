"""spark_rapids_ml_tpu_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu.

The JAX package beside it is the reference; this package keeps its module
layout and public names, runs on one CUDA card (``cuda:0``) unless the
caller asks for the CPU (``device="cpu"``), and replaces each Pallas kernel
on its path with a CUDA kernel written for Hopper (``csrc/``). It imports
``torch``, numpy and scipy — never ``jax`` and nothing of the JAX package.

    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch import NearestNeighbors, UMAP
    from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor
"""

__version__ = "0.1.0"

from .data.dataframe import DataFrame, Row
from .classification import RandomForestClassificationModel, RandomForestClassifier
from .knn import NearestNeighbors, NearestNeighborsModel
from .regression import RandomForestRegressionModel, RandomForestRegressor
from .umap import UMAP, UMAPModel

__all__ = [
    "DataFrame",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "Row",
    "UMAP",
    "UMAPModel",
    "__version__",
]
