"""Port parity: model export to scikit-learn (``spark_rapids_ml_tpu_torch/
export.py``, ``_TpuModel.to_sklearn()`` / ``cpu()``) against the JAX
package's ``export.py``.

Two holds:

* **carried parameters**: a model fitted by the JAX package, saved, and
  loaded into the port (``interop.load_jax_model``) exports, after a pickle
  round trip, to sklearn objects equal to the JAX package's export of the
  same model bit for bit (every array, its dtype and shape, every param);
  ``random_forest_packed`` equal field for field.
* **port fits**: a model fitted by the port exports to sklearn whose
  ``predict`` / ``transform`` / ``predict_proba`` equals the port's
  transform at the tolerances of the JAX package's ``tests/test_export.py``
  (its cases: PCA, KMeans, LinearRegression, binomial and 3-class
  LogisticRegression, forest classifier and regressor, the split-equality
  edge, feature importances, entropy, multiclass forests).

sklearn is imported inside the exporters only: importing the port does not
import it (the card machine has none).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from spark_rapids_ml_tpu import export as jexport
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.models.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.models.feature import PCA as JPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu.models.tree import RandomForestClassifier as JRFC
from spark_rapids_ml_tpu.models.tree import RandomForestRegressor as JRFR
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import export as texport
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.classification import RandomForestClassifier as TRFC
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg
from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor as TRFR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _roundtrip(sk_model):
    return pickle.loads(pickle.dumps(sk_model))


def _state(obj):
    """A fitted sklearn object as nested plain values: its class, its params
    (not deep) and every attribute; a ``Tree`` as its pickled state."""
    from sklearn.base import BaseEstimator
    from sklearn.tree._tree import Tree

    if isinstance(obj, Tree):
        return {"Tree": _state(obj.__getstate__()), "n_features": obj.n_features, "n_outputs": obj.n_outputs}
    if isinstance(obj, BaseEstimator):
        return {"class": type(obj).__name__, "params": _state(obj.get_params(deep=False)),
                **{k: _state(v) for k, v in vars(obj).items()}}
    if isinstance(obj, dict):
        return {k: _state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_state(v) for v in obj]
    return obj


def _assert_bitwise(a, b, where="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _cls_data(seed=0, n=400, d=8, k=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(d, k)) + rng.normal(size=(n, k)) * 0.1, axis=1).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# JAX-fitted parameters carried into the port: the same export, bit for bit
# ---------------------------------------------------------------------------


def _jax_model(kind):
    rng = np.random.default_rng(7)
    if kind == "pca":
        X = (rng.normal(size=(200, 12)) * ([1, 5] * 6)).astype(np.float32)
        return JPCA(k=3, num_workers=1).fit(JDataFrame({"features": X}))
    if kind == "kmeans":
        X = np.concatenate([rng.normal(loc=c, size=(80, 8)) for c in (-4.0, 0.0, 4.0)]).astype(np.float32)
        return JKMeans(k=3, seed=5, num_workers=1).fit(JDataFrame({"features": X}))
    if kind == "linreg":
        X = rng.normal(size=(300, 10)).astype(np.float32)
        y = (X @ rng.normal(size=10) + 2.0).astype(np.float32)
        return JLinReg(regParam=0.1, num_workers=1).fit(JDataFrame({"features": X, "label": y}))
    if kind in ("logreg2", "logreg3"):
        X, y = _cls_data(k=int(kind[-1]))
        return JLogReg(regParam=0.01, num_workers=1).fit(JDataFrame({"features": X, "label": y}))
    X, y = _cls_data(seed=3, n=300, d=6, k=3)
    if kind == "rf_classifier":
        return JRFC(numTrees=4, maxDepth=5, maxBins=16, seed=3, impurity="entropy", num_workers=1).fit(
            JDataFrame({"features": X, "label": y}))
    return JRFR(numTrees=4, maxDepth=5, maxBins=16, seed=3, num_workers=1).fit(
        JDataFrame({"features": X, "label": X[:, 0] * 2 + np.abs(X[:, 1])}))


@pytest.mark.parametrize("kind", ["pca", "kmeans", "linreg", "logreg2", "logreg3", "rf_classifier", "rf_regressor"])
def test_export_of_a_jax_model_carried_across_equals_jax_export(tmp_path, kind):
    jm = _jax_model(kind)
    path = str(tmp_path / kind)
    jm.write().save(path)
    tm = interop.load_jax_model(path, device="cpu")
    assert type(tm).__module__.startswith("spark_rapids_ml_tpu_torch.")
    sk_t, sk_j = _roundtrip(tm.to_sklearn()), _roundtrip(jm.to_sklearn())
    assert type(sk_t) is type(sk_j)
    _assert_bitwise(_state(sk_t), _state(sk_j))
    if kind.startswith("rf"):
        pt, pj = texport.random_forest_packed(tm), jexport.random_forest_packed(jm)
        assert sorted(pt) == sorted(pj) and pt["meta"] == pj["meta"]
        for key in ("feat1", "thr1", "feat2", "thr2"):
            _assert_bitwise(pt[key], pj[key], key)


# ---------------------------------------------------------------------------
# port-fitted models: the export reproduces the port's transform
# ---------------------------------------------------------------------------


def _port_case(case, rng):
    """(model, query rows, frame of them) of one of the JAX package's export
    test cases, fitted by the port."""
    if case == "pca":
        X = (rng.normal(size=(200, 12)) * ([1, 5] * 6)).astype(np.float32)
        return TPCA(k=3, device="cpu").fit(TDataFrame({"features": X})), X
    if case == "kmeans":
        X = np.concatenate([rng.normal(loc=c, size=(80, 8)) for c in (-4.0, 0.0, 4.0)]).astype(np.float32)
        return TKMeans(k=3, seed=5, device="cpu").fit(TDataFrame({"features": X})), X
    if case == "linreg":
        X = rng.normal(size=(300, 10)).astype(np.float32)
        y = (X @ rng.normal(size=10) + 2.0).astype(np.float32)
        return TLinReg(regParam=0.1, device="cpu").fit(TDataFrame({"features": X, "label": y})), X
    if case in ("logreg2", "logreg3"):
        k = int(case[-1])
        X = rng.normal(size=(400, 8)).astype(np.float32)
        y = np.argmax(X @ rng.normal(size=(8, k)) + rng.normal(size=(400, k)) * 0.1, axis=1).astype(np.float32)
        return TLogReg(regParam=0.01, device="cpu").fit(TDataFrame({"features": X, "label": y})), X
    if case == "rf_classifier":
        X = rng.normal(size=(500, 10)).astype(np.float32)
        y = ((X[:, 0] + X[:, 3] * X[:, 1]) > 0).astype(np.float32)
        m = TRFC(numTrees=12, maxDepth=5, seed=3, device="cpu").fit(TDataFrame({"features": X, "label": y}))
        return m, rng.normal(size=(200, 10)).astype(np.float32)
    if case == "rf_regressor":
        X = rng.normal(size=(500, 10)).astype(np.float32)
        y = (X[:, 0] * 2 + np.abs(X[:, 1])).astype(np.float32)
        m = TRFR(numTrees=12, maxDepth=5, seed=3, device="cpu").fit(TDataFrame({"features": X, "label": y}))
        return m, rng.normal(size=(200, 10)).astype(np.float32)
    if case == "rf_split_equality_edge":
        # integer-valued features land exactly on bin edges: x <= t left in
        # the export must route as x >= thr right in the port
        X = np.random.default_rng(0).integers(0, 8, size=(400, 4)).astype(np.float32)
        y = (X[:, 0] >= 4).astype(np.float32)
        return TRFC(numTrees=6, maxDepth=4, seed=1, device="cpu").fit(TDataFrame({"features": X, "label": y})), X
    # rf_multiclass: per-tree normalized distributions average to the vote
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = np.argmax(X[:, :3] + rng.normal(size=(600, 3)) * 0.3, axis=1).astype(np.float32)
    m = TRFC(numTrees=10, maxDepth=6, seed=4, device="cpu").fit(TDataFrame({"features": X, "label": y}))
    return m, rng.normal(size=(150, 8)).astype(np.float32)


@pytest.mark.parametrize("case", ["pca", "kmeans", "linreg", "logreg2", "logreg3", "rf_classifier", "rf_regressor",
                                  "rf_split_equality_edge", "rf_multiclass"])
def test_port_model_export_reproduces_transform(case):
    model, Xq = _port_case(case, np.random.default_rng(42))
    sk = _roundtrip(model.to_sklearn())
    out = model.transform(TDataFrame({"features": Xq}))
    if case == "pca":
        np.testing.assert_allclose(sk.transform(Xq), out.column("pca_features"), atol=1e-5)
        np.testing.assert_allclose(sk.tpu_mean_, model.mean_, atol=1e-6)
        assert sk.components_.shape == (3, 12)
    elif case == "kmeans":
        np.testing.assert_array_equal(sk.predict(Xq.astype(np.float64)), out.column("prediction"))
    elif case in ("linreg", "rf_regressor"):
        np.testing.assert_allclose(sk.predict(Xq), out.column("prediction"), atol=1e-4)
    else:
        np.testing.assert_array_equal(sk.predict(Xq), out.column("prediction"))
        atol = 1e-5 if case.startswith("logreg") else 1e-6
        np.testing.assert_allclose(sk.predict_proba(Xq), out.column("probability"), atol=atol)
    if case == "rf_multiclass":
        assert sk.n_classes_ == 3


def test_rf_export_feature_importances_and_entropy():
    """Exported trees agree on n_features even where a tree never splits on
    the last feature; an entropy forest exports entropy impurities."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(300, 10)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    sk = TRFC(numTrees=8, maxDepth=4, seed=2, device="cpu").fit(TDataFrame({"features": X, "label": y})).to_sklearn()
    fi = sk.feature_importances_
    assert fi.shape == (10,) and np.isfinite(fi).all()

    X = rng.normal(size=(200, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    model = TRFC(numTrees=4, maxDepth=3, seed=0, impurity="entropy", device="cpu").fit(
        TDataFrame({"features": X, "label": y}))
    sk = model.to_sklearn()
    assert sk.criterion == "entropy" and sk.estimators_[0].criterion == "entropy"
    ls = model._leaf_stats_arr[0, 0]
    p = ls / ls.sum()
    exp = -np.sum(np.where(p > 0, p * np.log2(np.maximum(p, 1e-30)), 0.0))
    np.testing.assert_allclose(sk.estimators_[0].tree_.impurity[0], exp, rtol=1e-5)


def test_random_forest_packed_of_a_port_fit():
    X, y = _cls_data(seed=8, n=200, d=6, k=3)
    m = TRFC(numTrees=5, maxDepth=6, seed=2, device="cpu").fit(TDataFrame({"features": X, "label": y}))
    pk = texport.random_forest_packed(m)
    assert pk["meta"]["n_trees"] == 5
    assert pk["feat1"].shape[0] % 8 == 0
    k1, k2 = pk["meta"]["k1"], pk["meta"]["k2"]
    assert k1 + k2 == m._max_depth_built
    assert pk["feat1"].shape[1] == (1 << k1) - 1
    assert pk["feat2"].shape == ((0, 64) if k2 == 0 else (pk["feat1"].shape[0] * (1 << k1), 64))
    with pytest.raises(TypeError):
        texport.random_forest_packed(object())
    with pytest.raises(TypeError, match="no sklearn exporter"):
        texport.to_sklearn(object())


def test_cpu_returns_the_model_itself():
    X = np.random.default_rng(1).normal(size=(50, 4)).astype(np.float32)
    m = TPCA(k=2, device="cpu").fit(TDataFrame({"features": X}))
    assert m.cpu() is m


def test_importing_the_port_does_not_import_sklearn():
    code = (
        "import sys\n"
        "import spark_rapids_ml_tpu_torch\n"
        "from spark_rapids_ml_tpu_torch import core, export, interop, feature, clustering, classification\n"
        "from spark_rapids_ml_tpu_torch import regression, knn, umap, evaluation\n"
        "print([m for m in sys.modules if m == 'sklearn' or m.startswith('sklearn.')])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
