"""Port parity: ``Pipeline`` and ``OneVsRest`` (``spark_rapids_ml_tpu_torch``'s
``pipeline.py``) against the JAX package's on the CPU.

Both packages fit in f64 (``float32_inputs=False``) on the same
numpy-seeded rows; the port with ``device="cpu"`` (K1 and K3 take their
plain versions), the JAX side with ``num_workers=1``. PCA's output is held
at rtol 1e-10 (a closed-form eigensolve), LogisticRegression's columns at
the f64 LogisticRegression tolerance of ``tests/test_torch_f64.py`` (atol
1e-4, the JAX package's own), and predictions equal. Directories saved by
the JAX package load in the port and transform alike.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.pipeline import OneVsRest as JOvR
from spark_rapids_ml_tpu.pipeline import Pipeline as JPipeline
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.classification import OneVsRest as TOvR
from spark_rapids_ml_tpu_torch.classification import OneVsRestModel as TOvRModel
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.feature import PCAModel as TPCAModel
from spark_rapids_ml_tpu_torch.pipeline import Pipeline as TPipeline
from spark_rapids_ml_tpu_torch.pipeline import PipelineModel as TPipelineModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR_TOL = dict(atol=1e-4)
PCA_TOL = dict(rtol=1e-10, atol=1e-12)
F64 = dict(float32_inputs=False)


def _multiclass(n=450, d=8, k=3, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4
    y = rng.integers(0, k, size=n)
    X = centers[y] + spread * rng.normal(size=(n, d))
    return {"features": X, "label": y.astype(np.float64)}


def _frames(cols):
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


def _stages(mod_pca, mod_lr, **dev):
    return [mod_pca(k=4, inputCol="features", outputCol="pca_out", **F64, **dev),
            mod_lr(featuresCol="pca_out", regParam=0.01, **F64, **dev)]


def _on_cpu(model):
    """A loaded model's stages on the CPU (a loaded model runs on cuda:0)."""
    for stage in getattr(model, "stages", None) or model.models:
        stage.setDevice("cpu")
    return model


def _hold_lr_columns(tout, jout, what):
    np.testing.assert_array_equal(tout.column("prediction"), np.asarray(jout.column("prediction")), err_msg=what)
    for c in ("probability", "rawPrediction"):
        np.testing.assert_allclose(tout.column(c), np.asarray(jout.column(c)), **LR_TOL, err_msg=f"{what} {c}")


def test_pipeline_pca_then_logreg_matches_jax(tmp_path):
    cols = _multiclass()
    jdf, tdf = _frames(cols)
    jm = JPipeline(stages=_stages(JPCA, JLogReg, num_workers=1)).fit(jdf)
    tm = TPipeline(stages=_stages(TPCA, TLogReg, device="cpu")).fit(tdf)
    assert [type(s).__name__ for s in tm.stages] == ["PCAModel", "LogisticRegressionModel"]
    jout, tout = jm.transform(jdf), tm.transform(tdf)
    np.testing.assert_allclose(tout.column("pca_out"), np.asarray(jout.column("pca_out")), **PCA_TOL)
    _hold_lr_columns(tout, jout, "pipeline")
    assert (tout.column("prediction") == cols["label"]).mean() > 0.9

    # the port's save / load: the chained transform is equal
    path = str(tmp_path / "pipe")
    tm.write().overwrite().save(path)
    tm.write().overwrite().save(path)
    with pytest.raises(FileExistsError):
        tm.save(path)
    assert sorted(os.listdir(path)) == ["pipeline.json", "stage_000", "stage_001"]
    loaded = _on_cpu(TPipelineModel.load(path))
    for c in ("pca_out", "prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(loaded.transform(tdf).column(c), tout.column(c), err_msg=c)

    # the JAX package's directory
    jpath = str(tmp_path / "jax_pipe")
    jm.write().overwrite().save(jpath)
    jl = _on_cpu(TPipelineModel.load(jpath))
    assert isinstance(jl.stages[0], TPCAModel)
    jlout = jl.transform(tdf)
    np.testing.assert_allclose(jlout.column("pca_out"), np.asarray(jout.column("pca_out")), **PCA_TOL)
    _hold_lr_columns(jlout, jout, "JAX-saved pipeline")


def test_pipeline_transformer_stage_passthrough():
    cols = _multiclass(n=200)
    tdf = TDataFrame(dict(cols))
    pca_model = TPCA(k=3, inputCol="features", outputCol="p", device="cpu").fit(tdf)
    pipe = TPipeline().setStages([pca_model, TLogReg(featuresCol="p", regParam=0.01, device="cpu")])
    assert pipe.getStages()[0] is pca_model
    model = pipe.fit(tdf)
    assert model.stages[0] is pca_model
    assert "prediction" in model.transform(tdf)
    with pytest.raises(TypeError, match="neither an estimator nor a transformer"):
        TPipeline([object()]).fit(tdf)


def test_one_vs_rest_matches_jax(tmp_path):
    cols = _multiclass(n=500, d=6, k=4, spread=1.5)
    jdf, tdf = _frames(cols)
    y = cols["label"]
    jm = JOvR(classifier=JLogReg(regParam=0.01, num_workers=1, **F64)).fit(jdf)
    tm = TOvR(classifier=TLogReg(regParam=0.01, device="cpu", **F64)).fit(tdf)
    assert tm.numClasses == jm.numClasses == 4
    jout, tout = jm.transform(jdf), tm.transform(tdf)
    raw = tout.column("rawPrediction")
    assert raw.shape == (500, 4)
    np.testing.assert_allclose(raw, np.asarray(jout.column("rawPrediction")), **LR_TOL)
    np.testing.assert_array_equal(tout.column("prediction"), np.asarray(jout.column("prediction")))
    # each column is its binary model's raw score, bit for bit
    for k, m in enumerate(tm.models):
        np.testing.assert_array_equal(raw[:, k], m.transform(tdf).column("rawPrediction")[:, 1])
        assert m.getOrDefault("labelCol") == "_ovr_label"
    acc_ovr = (tout.column("prediction") == y).mean()
    direct = TLogReg(regParam=0.01, device="cpu", **F64).fit(tdf)
    acc_direct = (direct.transform(tdf).column("prediction") == y).mean()
    assert acc_ovr > 0.9 and acc_ovr >= acc_direct - 0.05

    path = str(tmp_path / "ovr")
    tm.save(path)
    with pytest.raises(FileExistsError):
        tm.save(path)
    loaded = _on_cpu(TOvRModel.load(path))
    np.testing.assert_array_equal(loaded.transform(tdf).column("rawPrediction"), raw)
    jpath = str(tmp_path / "jax_ovr")
    jm.save(jpath)
    jl = _on_cpu(TOvRModel.load(jpath))
    assert jl.numClasses == 4
    np.testing.assert_allclose(jl.transform(tdf).column("rawPrediction"), np.asarray(jout.column("rawPrediction")),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(jl.transform(tdf).column("prediction"), np.asarray(jout.column("prediction")))


def test_one_vs_rest_rejects_bad_labels():
    rng = np.random.default_rng(0)
    cols = {"features": rng.normal(size=(60, 3)), "label": np.linspace(0, 1, 60)}
    jdf, tdf = _frames(cols)
    with pytest.raises(RuntimeError, match="non-negative integers") as te:
        TOvR(classifier=TLogReg(device="cpu")).fit(tdf)
    with pytest.raises(RuntimeError, match="non-negative integers") as je:
        JOvR(classifier=JLogReg()).fit(jdf)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="classifier must be set"):
        TOvR().fit(tdf)


def test_meta_modules_leave_jax_out():
    """Importing the port's pipeline and tuning imports no JAX."""
    code = (
        "import sys\n"
        "from spark_rapids_ml_tpu_torch import pipeline, tuning\n"
        "from spark_rapids_ml_tpu_torch.classification import OneVsRest\n"
        "from spark_rapids_ml_tpu_torch.data.dataframe import kfold\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'spark_rapids_ml_tpu.'))"
        " or m == 'spark_rapids_ml_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)
