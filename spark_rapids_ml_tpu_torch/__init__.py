"""spark_rapids_ml_tpu_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu.

The JAX package beside it is the reference; this package keeps its module
layout and public names, runs on one CUDA card (``cuda:0``) unless the
caller asks for the CPU (``device="cpu"``), and replaces each Pallas kernel
on its path with a CUDA kernel written for Hopper (``csrc/``). It imports
``torch``, numpy and scipy — never ``jax`` and nothing of the JAX package.

    from spark_rapids_ml_tpu_torch.feature import PCA
    from spark_rapids_ml_tpu_torch.clustering import KMeans
    from spark_rapids_ml_tpu_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu_torch.regression import LinearRegression
    from spark_rapids_ml_tpu_torch import NearestNeighbors, ApproximateNearestNeighbors, UMAP
    from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor
    from spark_rapids_ml_tpu_torch import GBTClassifier, GBTRegressor

Out-of-core data: ``DataFrame.scan_parquet(path)`` (a lazy
``ParquetScanFrame`` that streamed fits and transforms never materialize)
and the chunk sources of a streamed fit,

    from spark_rapids_ml_tpu_torch.data.chunks import (
        ArrayChunkSource, CSRChunkSource, GeneratorChunkSource, ParquetChunkSource)
"""

__version__ = "0.1.0"

from .data.dataframe import DataFrame, Row
from .classification import (
    GBTClassificationModel,
    GBTClassifier,
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from .knn import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from .regression import (
    GBTRegressionModel,
    GBTRegressor,
    LinearRegression,
    LinearRegressionModel,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from .umap import UMAP, UMAPModel

__all__ = [
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "DataFrame",
    "GBTClassificationModel",
    "GBTClassifier",
    "GBTRegressionModel",
    "GBTRegressor",
    "LinearRegression",
    "LinearRegressionModel",
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
