"""The port's first slice as a whole: PCA, KMeans and LogisticRegression
``fit`` then ``transform`` through ``DataFrame`` against the JAX package
(``num_workers=1``, CPU), save/load, cross-loading of JAX-saved models, and
the import boundary (the port never imports ``jax`` or the JAX package).

Inputs are made with a seeded numpy generator at the full width d = 256.
Tolerances are stated per check: both packages fit in f32 with different
summation orders, so fitted values agree to a small multiple of f32
rounding where the fit is well conditioned.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.feature import PCA as JPCA
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.classification import LogisticRegressionModel as TLogRegModel
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.feature import PCA as TPCA
from spark_rapids_ml_tpu_torch.feature import PCAModel as TPCAModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 256


def _low_rank(seed, n=3000, k=5):
    """Data with k well-separated principal directions plus small noise,
    so the top-k eigenvectors are determined (up to the fixed sign)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(D, k)))
    Z = rng.normal(size=(n, k)) * np.array([5.0, 4.0, 3.0, 2.0, 1.5])[:k]
    X = Z @ Q.T + rng.normal(size=(n, D)) * 0.05 + 1.0
    return X.astype(np.float32)


def _blobs(seed, n=4000, k=20):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, D)) * 2.0
    lab = rng.integers(0, k, size=n)
    return (centers[lab] + rng.normal(size=(n, D)) * 0.5).astype(np.float32)


def _frames(data):
    return JDataFrame(dict(data)), TDataFrame(dict(data))


def test_pca_fit_transform_matches_jax():
    X = _low_rank(1)
    jdf, tdf = _frames({"features": X})
    jm = JPCA(k=5, num_workers=1).fit(jdf)
    tm = TPCA(k=5, device="cpu").fit(tdf)
    # means of O(1) data: f32 rounding; eigenpairs of a well-separated
    # spectrum: ~1e-5 relative
    assert np.abs(tm.mean_ - jm.mean_).max() < 1e-5
    np.testing.assert_allclose(tm.explained_variance_, jm.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(tm.explained_variance_ratio_, jm.explained_variance_ratio_, rtol=1e-4)
    np.testing.assert_allclose(tm.singular_values_, jm.singular_values_, rtol=1e-4)
    assert np.abs(tm.pc - jm.pc).max() < 1e-4
    out_t = np.asarray(tm.transform(tdf).column("pca_features"))
    out_j = np.asarray(jm.transform(jdf).column("pca_features"))
    assert out_t.shape == (3000, 5)
    assert np.abs(out_t - out_j).max() < 1e-3 * np.abs(out_j).max()


def test_kmeans_fit_transform_matches_jax():
    X = _blobs(2)
    jdf, tdf = _frames({"features": X})
    jm = JKMeans(k=20, maxIter=20, seed=3, num_workers=1).fit(jdf)
    tm = TKMeans(k=20, maxIter=20, seed=3, device="cpu").fit(tdf)
    # the same seed draws the same numbers, but a draw near its threshold
    # may flip on an ulp of distance, so the fit is held by its cost and by
    # its centres matched to their nearest counterparts
    assert abs(tm.trainingCost - jm.trainingCost) / jm.trainingCost < 1e-3
    cj, ct = jm.cluster_centers_, tm.cluster_centers_
    match = ((ct[:, None, :] - cj[None]) ** 2).sum(-1).argmin(axis=1)
    assert sorted(match.tolist()) == list(range(20))  # a permutation
    assert np.abs(ct - cj[match]).max() < 1e-3
    pt = np.asarray(tm.transform(tdf).column("prediction"))
    pj = np.asarray(jm.transform(jdf).column("prediction"))
    assert (match[pt] == pj).all()


@pytest.mark.parametrize("n_classes,reg,enet", [(2, 0.01, 0.0), (4, 0.01, 0.0), (10, 0.01, 0.0), (2, 0.02, 0.5),
                                                (300, 0.01, 0.0)])
def test_logreg_fit_transform_matches_jax(n_classes, reg, enet):
    # at least 100 rows a class: with fewer, the unpenalized intercepts of
    # 300 classes are too loosely pinned for two f32 solvers to stop at
    # the same point (300 classes: the class-tiled instance on the card,
    # the JAX package outside its Pallas gate)
    n = max(3000, 100 * n_classes)
    rng = np.random.default_rng(n_classes)
    X = rng.normal(size=(n, D)).astype(np.float32)
    W = rng.normal(size=(D, n_classes)) * 0.2
    y = (X @ W + rng.gumbel(size=(n, n_classes))).argmax(axis=1).astype(np.float32)
    jdf, tdf = _frames({"features": X, "label": y})
    kw = dict(maxIter=50, regParam=reg, elasticNetParam=enet)
    jm = JLogReg(num_workers=1, **kw).fit(jdf)
    tm = TLogReg(device="cpu", **kw).fit(tdf)
    # regularized, well-conditioned optimum: both solvers stop within their
    # f32 tolerance of it
    scale = np.abs(jm.coefficientMatrix).max()
    assert np.abs(tm.coefficientMatrix - jm.coefficientMatrix).max() < 2e-3 * scale
    assert np.abs(tm.interceptVector - jm.interceptVector).max() < 2e-3 * max(scale, 1.0)
    ot, oj = tm.transform(tdf), jm.transform(jdf)
    assert (np.asarray(ot.column("prediction")) == np.asarray(oj.column("prediction"))).mean() > 0.995
    assert np.abs(np.asarray(ot.column("probability")) - np.asarray(oj.column("probability"))).max() < 5e-3
    if n_classes == 2:
        assert tm.coefficients.shape == (D,) and isinstance(tm.intercept, float)
    else:
        assert tm.coefficientMatrix.shape == (n_classes, D)


def test_save_load_round_trip(tmp_path):
    X = _low_rank(4, n=500)
    y = (X[:, 0] > X[:, 0].mean()).astype(np.float32)
    tdf = TDataFrame({"features": X, "label": y})
    pca = TPCA(k=3, device="cpu").fit(tdf)
    lr = TLogReg(device="cpu", maxIter=10, regParam=0.1).fit(tdf)
    pca.write().save(str(tmp_path / "pca"))
    lr.write().save(str(tmp_path / "lr"))
    pca2 = TPCAModel.load(str(tmp_path / "pca")).setDevice("cpu")
    lr2 = TLogRegModel.load(str(tmp_path / "lr")).setDevice("cpu")
    assert pca2.getK() == 3
    np.testing.assert_array_equal(pca2.components_, pca.components_)
    np.testing.assert_array_equal(
        pca2.transform(tdf).column("pca_features"), pca.transform(tdf).column("pca_features")
    )
    np.testing.assert_array_equal(lr2.coefficients, lr.coefficients)
    np.testing.assert_array_equal(
        lr2.transform(tdf).column("probability"), lr.transform(tdf).column("probability")
    )
    est = TKMeans(k=4, maxIter=3, device="cpu")
    est.write().save(str(tmp_path / "km_est"))
    est2 = TKMeans.load(str(tmp_path / "km_est"))
    assert est2.getK() == 4 and est2.getOrDefault("maxIter") == 3


@pytest.mark.parametrize("kind", ["pca", "kmeans", "logreg", "linreg"])
def test_cross_load_jax_saved_model(tmp_path, kind):
    X = _blobs(5, n=600, k=6)
    y = (X[:, 0] > np.median(X[:, 0])).astype(np.float32)
    jdf, tdf = _frames({"features": X, "label": y})
    if kind == "pca":
        jm, col = JPCA(k=4, num_workers=1).setOutputCol("proj").fit(jdf), "proj"
    elif kind == "kmeans":
        jm, col = JKMeans(k=6, maxIter=5, num_workers=1).fit(jdf), "prediction"
    elif kind == "linreg":
        jm, col = JLinReg(num_workers=1, regParam=0.05, elasticNetParam=0.5).fit(jdf), "prediction"
    else:
        jm, col = JLogReg(num_workers=1, maxIter=20, regParam=0.05).fit(jdf), "probability"
    path = str(tmp_path / kind)
    jm.write().save(path)
    tm = interop.load_jax_model(path, device="cpu")
    assert type(tm).__module__.startswith("spark_rapids_ml_tpu_torch.")
    out_t = np.asarray(tm.transform(tdf).column(col))
    out_j = np.asarray(jm.transform(jdf).column(col))
    # the same fitted numbers through two f32 products
    if kind == "kmeans":
        np.testing.assert_array_equal(out_t, out_j)
    else:
        assert np.abs(out_t - out_j).max() < 1e-4 * max(np.abs(out_j).max(), 1.0)

    # the in-memory route: attributes (as numpy) and params of the JAX model
    params = {p.name: jm.getOrDefault(p) for p in jm.params if jm.isSet(p)}
    tm2 = interop.from_jax_attributes(
        type(jm).__name__, jm._get_model_attributes(), params, device="cpu"
    )
    np.testing.assert_array_equal(np.asarray(tm2.transform(tdf).column(col)), out_t)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import spark_rapids_ml_tpu_torch\n"
        "from spark_rapids_ml_tpu_torch import core, interop, feature, clustering, classification, knn, umap\n"
        "from spark_rapids_ml_tpu_torch import regression, evaluation, metrics\n"
        "from spark_rapids_ml_tpu_torch.ops import linreg_kernels\n"
        "from spark_rapids_ml_tpu_torch.models import regression as mregression\n"
        "from spark_rapids_ml_tpu_torch.ops import _build, linalg, kmeans_kernels, lbfgs, logreg_kernels\n"
        "from spark_rapids_ml_tpu_torch.ops import knn_kernels, umap_kernels, rf_kernels, tree_kernels, gbt_kernels\n"
        "from spark_rapids_ml_tpu_torch.ops import ivf_kernels\n"
        "from spark_rapids_ml_tpu_torch.knn import ApproximateNearestNeighbors\n"
        "from spark_rapids_ml_tpu_torch.models import knn as mknn, umap as mumap, tree as mtree\n"
        "from spark_rapids_ml_tpu_torch import GBTClassifier, GBTRegressor, GBTClassificationModel\n"
        "from spark_rapids_ml_tpu_torch.runtime import telemetry, counters, metricspec, lockspec, lockwitness\n"
        "from spark_rapids_ml_tpu_torch.utils import profiling\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'spark_rapids_ml_tpu' or m.startswith('spark_rapids_ml_tpu.')]\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_rapids_ml_tpu"), f"{f} imports {mod}"


def test_port_reads_no_tpuml_variable():
    """The port's settings are module constants: no file of the port (nor
    ``chip_smoke.py``) reads a ``TPUML_*`` environment variable."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for new in ("telemetry.py", "counters.py", "metricspec.py", "lockspec.py", "lockwitness.py", "profiling.py",
                "lbfgs.py", "linreg_kernels.py", "logreg_kernels.py", "core.py", "tuning.py", "faults.py",
                "retry.py", "admission.py", "scheduler.py"):
        assert any(f.endswith(os.sep + new) for f in files), new
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = ast.unparse(node.func)
            reads_env = fn in ("os.getenv", "getenv") or (fn.endswith(".get") and "environ" in fn)
            if reads_env and node.args:
                arg = node.args[0]
                assert not (isinstance(arg, ast.Constant) and str(arg.value).startswith("TPUML_")), (
                    f"{f}:{node.lineno} reads {arg.value}")
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript) and ast.unparse(node.value) == "os.environ":
                key = node.slice
                assert not (isinstance(key, ast.Constant) and str(key.value).startswith("TPUML_")), (
                    f"{f}:{node.lineno} reads {key.value}")


def test_entry_point_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    tdf = TDataFrame({"features": _low_rank(6, n=50)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPCA(k=2).fit(tdf)
    model = TPCA(k=2, device="cpu").fit(tdf)
    model.setDevice(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.transform(tdf)


def test_gbt_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from spark_rapids_ml_tpu_torch import GBTClassifier, GBTRegressor

    X = _low_rank(7, n=80)[:, :8]
    y = (X[:, 0] > np.median(X[:, 0])).astype(np.float32)
    tdf = TDataFrame({"features": X, "label": y})
    for est in (GBTClassifier(maxIter=2, maxDepth=3), GBTRegressor(maxIter=2, maxDepth=3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            est.fit(tdf)
        model = est.setDevice("cpu").fit(tdf)
        model.setDevice(None)
        for engine in (None, "bins"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                model._get_transform_func(engine=engine)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.transform(tdf)
