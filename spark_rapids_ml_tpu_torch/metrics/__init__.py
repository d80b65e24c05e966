"""Host-side metric computation from mergeable sufficient statistics.

A copy of ``spark_rapids_ml_tpu/metrics/`` (numpy only), which mirrors
the reference package's ``spark_rapids_ml/metrics/``: ``MulticlassMetrics``
/ ``RegressionMetrics`` aggregate per-shard sufficient statistics (confusion counts / moment buffers) and
compute every metric the corresponding Spark evaluator supports. Unlike the
reference there is no ``EvalMetricInfo`` side-channel — the evaluator object
itself travels into ``model._transformEvaluate``.
"""

from .multiclass import MulticlassMetrics, log_loss
from .regression import RegressionMetrics

__all__ = [
    "MulticlassMetrics",
    "RegressionMetrics",
    "log_loss",
]
