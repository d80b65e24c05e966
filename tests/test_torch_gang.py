"""Port parity: the gang paths (``core.GANG_FIT``): the batched
L-BFGS/OWL-QN and FISTA solvers, ``logreg_fit_batched``, the resolver and
the static buckets, the gang ``fitMultiple`` and the fold-masked gang
``CrossValidator``, against the JAX package on the CPU.

Each package is set its own way: the JAX side through
``TPUML_GANG_FIT`` / ``TPUML_GANG_FIT_BUDGET`` / ``TPUML_CV_FAILFAST``
(``monkeypatch.setenv``), the port through its module constants
``core.GANG_FIT`` / ``core.GANG_FIT_BUDGET`` / ``tuning.CV_FAILFAST``
(``monkeypatch.setattr``). The port runs with ``device="cpu"``, the JAX
side with ``num_workers=1``; both get the same numpy-seeded rows.

Tolerances, each stated where it is held:

* The port's own contracts are bitwise: a converged lane is frozen however
  long other lanes run (the other lanes' ``tol`` changed), and lanes of
  equal params are equal.
* The solvers against the JAX package's: ``minimize_lbfgs_batched`` at rtol
  1e-3, atol 1e-5 with the iterations within 1 on plain lanes (the JAX
  test's gang-vs-solo tolerance); ``solve_elasticnet_batched`` on the same statistics at rtol
  1e-5; ``logreg_fit_batched`` in f64 at rtol 1e-6 (the JAX side under
  its scoped x64) and in f32 at the JAX test's rtol 5e-3, atol
  1e-5·max(1, max|coef|), at stopping tolerances f32 resolves.
* End to end against the JAX package's sequential path (not its gang, whose
  own f32 test misses on an OWL-QN coefficient): the JAX test's setup
  (tol 1e-8) in f64 (``float32_inputs=False``) at rtol 1e-6 with the
  iterations within 1; in f32 the same rows, grid and maxIter at tol 1e-5
  at the JAX test's tolerances, against the port's sequential fits too. In
  f32 a tol of 1e-8 is below the objective's resolution (6e-8), so where a
  lane stops would be set by rounding. The CV: ``avgMetrics`` at rtol
  5e-3, atol 5e-4, the same best index, sub-models at rtol 2e-2, atol
  1e-4·max(1, max|coef|) (the JAX test's).
"""

import collections
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu.core import _x64_ctx
from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JMCE
from spark_rapids_ml_tpu.ops import lbfgs as jlbfgs
from spark_rapids_ml_tpu.ops import linreg_kernels as jlin
from spark_rapids_ml_tpu.ops import logreg_kernels as jlk
from spark_rapids_ml_tpu.regression import LinearRegression as JLinReg
from spark_rapids_ml_tpu.runtime import counters as jcounters
from spark_rapids_ml_tpu.runtime import telemetry as jtel
from spark_rapids_ml_tpu.runtime.envspec import EnvSpecError
from spark_rapids_ml_tpu.tuning import CrossValidator as JCV
from spark_rapids_ml_tpu.tuning import ParamGridBuilder as JPGB
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch import core, tuning
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator as TMCE
from spark_rapids_ml_tpu_torch.ops import lbfgs as tlbfgs
from spark_rapids_ml_tpu_torch.ops import linreg_kernels as tlin
from spark_rapids_ml_tpu_torch.ops import logreg_kernels as tlk
from spark_rapids_ml_tpu_torch.regression import LinearRegression as TLinReg
from spark_rapids_ml_tpu_torch.runtime import counters as tcounters
from spark_rapids_ml_tpu_torch.runtime import telemetry as ttel
from spark_rapids_ml_tpu_torch.tuning import CrossValidator as TCV
from spark_rapids_ml_tpu_torch.tuning import ParamGridBuilder as TPGB

import torch

# the JAX test's coefficient tolerance for a gang lane against a solo fit
JAX_RTOL = 5e-3


def _jax_atol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TPUML_GANG_FIT", raising=False)
    monkeypatch.delenv("TPUML_GANG_FIT_BUDGET", raising=False)
    monkeypatch.setattr(core, "GANG_FIT", "off")
    monkeypatch.setattr(core, "GANG_FIT_BUDGET", None)
    jcounters.reset()
    tcounters.reset()
    jtel.reset_telemetry()
    ttel.reset_telemetry()
    yield
    jtel.reset_telemetry()
    ttel.reset_telemetry()


def _gang(monkeypatch, value="auto", budget=None):
    """The gang on in both packages."""
    monkeypatch.setenv("TPUML_GANG_FIT", str(value))
    monkeypatch.setattr(core, "GANG_FIT", value)
    if budget is not None:
        monkeypatch.setenv("TPUML_GANG_FIT_BUDGET", str(budget))
        monkeypatch.setattr(core, "GANG_FIT_BUDGET", budget)


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------


def _quad_problem(seed=0, n=256, p=8):
    """The JAX test's least-squares problem with a lane axis, in both
    packages: lane b's loss is a function of row b alone."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, p))
    y = A @ rng.normal(size=p) + 0.1 * rng.normal(size=n)
    Aj, yj = jnp.asarray(A, jnp.float32), jnp.asarray(y, jnp.float32)
    At, yt = torch.tensor(A, dtype=torch.float32), torch.tensor(y, dtype=torch.float32)

    def jfun(W):
        r = W @ Aj.T - yj[None, :]
        return 0.5 * (r * r).mean(axis=1)

    def tfun(W):
        r = W @ At.T - yt[None, :]
        return 0.5 * (r * r).mean(dim=1)

    def tfun_solo(w):
        r = At @ w - yt
        return 0.5 * (r * r).mean()

    return jfun, tfun, tfun_solo, p


@pytest.mark.parametrize("owlqn", [False, True])
def test_lbfgs_batched_matches_jax(owlqn):
    """Three lanes through both packages' batched solvers, w and f at rtol
    1e-3, atol 1e-5: plain lanes of tol 1e-5 / 1e-7 / 1e-9 with the
    iterations within 1 (the JAX test's lockstep setup); OWL-QN lanes of l1
    0.001 / 0.05 / 0.5 at tol 1e-9 (the JAX test's OWL-QN setup, which holds
    no iteration count: 1e-9 is below f32's resolution, so where those
    lanes stop is set by rounding)."""
    jfun, tfun, _, p = _quad_problem(seed=2 if owlqn else 1)
    tols = [1e-9] * 3 if owlqn else [1e-5, 1e-7, 1e-9]
    l1s = [0.001, 0.05, 0.5]
    jl1 = jnp.asarray(l1s, jnp.float32)[:, None] * jnp.ones((3, p), jnp.float32) if owlqn else None
    tl1 = torch.tensor(l1s)[:, None] * torch.ones((3, p)) if owlqn else None
    jr = jlbfgs.minimize_lbfgs_batched(jfun, jnp.zeros((3, p), jnp.float32), max_iter=200,
                                       tol=jnp.asarray(tols, jnp.float32), l1_weights=jl1)
    tr = tlbfgs.minimize_lbfgs_batched(tfun, torch.zeros((3, p)), max_iter=200, tol=torch.tensor(tols),
                                       l1_weights=tl1)
    if not owlqn:
        assert np.all(np.abs(np.asarray(jr.n_iter) - tr.n_iter.numpy()) <= 1)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tr.f.numpy(), np.asarray(jr.f), rtol=1e-3, atol=1e-5)
    assert tr.converged.tolist() == np.asarray(jr.converged).tolist()
    if owlqn:
        assert int((tr.w[2] == 0.0).sum()) > 0


@pytest.mark.parametrize("owlqn", [False, True])
def test_freeze_bitwise_under_other_lane_tol_change(owlqn):
    """Lane 0 converges first; the other lanes' tol is loose in one run and
    brutal in the other, so the loop runs longer: lane 0 bit for bit."""
    _, tfun, _, p = _quad_problem()
    l1 = torch.full((3, p), 0.01) if owlqn else None
    short = tlbfgs.minimize_lbfgs_batched(tfun, torch.zeros((3, p)), max_iter=100,
                                          tol=torch.tensor([1e-4, 1e-3, 1e-3]), l1_weights=l1)
    long = tlbfgs.minimize_lbfgs_batched(tfun, torch.zeros((3, p)), max_iter=100,
                                         tol=torch.tensor([1e-4, 1e-12, 1e-12]), l1_weights=l1)
    assert int(long.n_iter[1]) > int(short.n_iter[1])
    assert int(long.n_iter.max()) > int(short.n_iter[0])  # the loop ran on past lane 0
    assert torch.equal(short.w[0], long.w[0]) and torch.equal(short.f[0], long.f[0])
    assert int(short.n_iter[0]) == int(long.n_iter[0])


def test_identical_lanes_bitwise_equal():
    _, tfun, _, p = _quad_problem(seed=3)
    out = tlbfgs.minimize_lbfgs_batched(tfun, torch.zeros((4, p)), max_iter=100, tol=torch.full((4,), 1e-8))
    for b in range(1, 4):
        assert torch.equal(out.w[0], out.w[b]) and int(out.n_iter[0]) == int(out.n_iter[b])


def test_owlqn_lanes_of_mixed_l1_match_port_solo():
    """Each OWL-QN lane against the port's solo ``minimize_lbfgs`` of its l1
    (rtol 1e-3, atol 1e-5); the strong-l1 lane is sparse."""
    _, tfun, tfun_solo, p = _quad_problem(seed=2)
    l1s = [0.001, 0.05, 0.5]
    out = tlbfgs.minimize_lbfgs_batched(tfun, torch.zeros((3, p)), max_iter=200, tol=torch.full((3,), 1e-9),
                                        l1_weights=torch.tensor(l1s)[:, None] * torch.ones((3, p)))
    for b, l1 in enumerate(l1s):
        solo = tlbfgs.minimize_lbfgs(tfun_solo, torch.zeros(p), max_iter=200, tol=1e-9,
                                     l1_weights=torch.full((p,), l1))
        np.testing.assert_allclose(out.w[b].numpy(), solo.w.numpy(), rtol=1e-3, atol=1e-5)
    assert int((out.w[2] == 0.0).sum()) > 0


def _linreg_stats(seed=4, n=2000, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=n) + X[:, 0] * 2.0).astype(np.float32)
    mask = np.ones((n,), np.float32)
    jst = jlin.linreg_suffstats(jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y), None, fit_intercept=True)
    tst = tlin.linreg_suffstats(torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(y), None,
                                fit_intercept=True)
    return jst, tst


LANES = [(0.1, 0.05), (0.01, 0.2), (0.3, 0.0)]


def test_elasticnet_batched_matches_jax_on_the_same_stats():
    """The JAX package's statistics into both batched solvers: rtol 1e-5."""
    jst, _ = _linreg_stats()
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    l1 = [a for a, _ in LANES]
    l2 = [b for _, b in LANES]
    jb, ji, jit = jlin.solve_elasticnet_batched(jst, jnp.asarray(l1, jnp.float32), jnp.asarray(l2, jnp.float32),
                                                standardization=True, max_iter=500,
                                                tol=jnp.full((3,), 1e-7, jnp.float32))
    tb, ti, tit = tlin.solve_elasticnet_batched(tst, l1, l2, standardization=True, max_iter=500,
                                                tol=[1e-7] * 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-7)
    assert np.all(np.abs(tit.numpy() - np.asarray(jit)) <= 2)


def test_elasticnet_batched_matches_port_solo_and_freezes():
    """Against the port's solo ``solve_elasticnet`` (rtol 1e-4, atol 1e-6,
    iterations within 2: the JAX test's); lane 0 bit for bit when the other
    lanes' tol is brutal."""
    _, tst = _linreg_stats()
    l1 = [a for a, _ in LANES]
    l2 = [b for _, b in LANES]
    tb, ti, tit = tlin.solve_elasticnet_batched(tst, l1, l2, standardization=True, max_iter=500, tol=[1e-7] * 3)
    for i, (a, b) in enumerate(LANES):
        beta, inter, it = tlin.solve_elasticnet(tst, a, b, standardization=True, max_iter=500, tol=1e-7)
        assert abs(int(tit[i]) - it) <= 2
        np.testing.assert_allclose(tb[i].numpy(), beta.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(ti[i]), float(inter), rtol=1e-4, atol=1e-6)
    sb, _, sit = tlin.solve_elasticnet_batched(tst, l1, l2, standardization=True, max_iter=500,
                                               tol=[1e-3, 1e-3, 1e-3])
    lb, _, lit = tlin.solve_elasticnet_batched(tst, l1, l2, standardization=True, max_iter=500,
                                               tol=[1e-3, 1e-12, 1e-12])
    assert int(lit.max()) > int(sit[0])
    assert torch.equal(sb[0], lb[0]) and int(sit[0]) == int(lit[0])


# ---------------------------------------------------------------------------
# logreg_fit_batched
# ---------------------------------------------------------------------------


def _clf(seed=0, n=600, d=6, classes=2):
    """The JAX test's labels (``_clf_data``) at a small size."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d) + 0.5
    if classes == 2:
        y = (X @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0).astype(float)
    else:
        W = rng.normal(size=(d, classes))
        y = np.argmax(X @ W + 0.5 * rng.normal(size=(n, classes)), axis=1).astype(float)
    return X, y


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("folds", [False, True], ids=["nofold", "folds"])
@pytest.mark.parametrize("use_l1", [False, True], ids=["lbfgs", "owlqn"])
@pytest.mark.parametrize("classes", [2, 3])
def test_logreg_fit_batched_matches_jax(classes, use_l1, folds, f64):
    """Three lanes of other penalties through both packages' batched fits:
    f64 at rtol 1e-6 (atol 1e-9) with equal iterations, f32 at the JAX
    test's tolerance with the iterations within 1."""
    X, y = _clf(seed=classes + 10 * use_l1, classes=classes)
    n = X.shape[0]
    fid = (np.arange(n) * 7 % 3).astype(np.int32)
    lane_fold = np.asarray([0, 1, 2], np.int32)
    regs = [0.01, 0.05, 0.2]
    ratio = 0.5 if use_l1 else 0.0
    l1 = [r * ratio for r in regs]
    l2 = [r * (1.0 - ratio) for r in regs]
    # f32: tolerances f32 resolves (a stop below its 6e-8 resolution is
    # set by rounding, in either package)
    tol = [1e-8, 1e-7, 1e-6] if f64 else [1e-5, 1e-4, 1e-5]
    npd = np.float64 if f64 else np.float32
    kw = dict(n_classes=classes, multinomial=classes > 2, fit_intercept=True, standardization=True,
              use_l1=use_l1, max_iter=60)
    fkw_j = dict(fold_id=jnp.asarray(fid), lane_fold=jnp.asarray(lane_fold), n_folds=3) if folds else {}
    fkw_t = dict(fold_id=torch.from_numpy(fid), lane_fold=lane_fold.tolist(), n_folds=3) if folds else {}
    with _x64_ctx(npd):
        jd = jnp.dtype(npd)
        jout = jlk.logreg_fit_batched(jnp.asarray(X, jd), jnp.ones((n,), jd), jnp.asarray(y, jd),
                                      l1=jnp.asarray(l1, jd), l2=jnp.asarray(l2, jd), tol=jnp.asarray(tol, jd),
                                      **kw, **fkw_j)
        jout = {k: np.asarray(v) for k, v in jout.items()}
    tout = tlk.logreg_fit_batched(torch.from_numpy(X.astype(npd)), torch.ones(n, dtype=torch.from_numpy(
        np.zeros(0, npd)).dtype), torch.from_numpy(y.astype(npd)), l1=l1, l2=l2, tol=tol, **kw, **fkw_t)
    coef = tout["coef_"].numpy()
    assert coef.shape == jout["coef_"].shape == (3, classes if classes > 2 else 1, X.shape[1])
    assert coef.dtype == npd
    if f64:
        assert tout["n_iter"].tolist() == jout["n_iter"].tolist()
        np.testing.assert_allclose(coef, jout["coef_"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tout["intercept_"].numpy(), jout["intercept_"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tout["objective"].numpy(), jout["objective"], rtol=1e-9)
    else:
        assert np.all(np.abs(tout["n_iter"].numpy() - jout["n_iter"]) <= 1)
        for b in range(3):
            np.testing.assert_allclose(coef[b], jout["coef_"][b], rtol=JAX_RTOL, atol=_jax_atol(jout["coef_"][b]))
            np.testing.assert_allclose(tout["intercept_"][b].numpy(), jout["intercept_"][b], rtol=JAX_RTOL,
                                       atol=_jax_atol(jout["intercept_"][b]))
    assert tout["converged"].tolist() == jout["converged"].tolist()


def test_logreg_fit_batched_fits_bfloat16_and_refuses_unknown_dtype():
    """The gang refuses an objective dtype it does not know and fits
    ``objective_dtype="bfloat16"`` (its product on the bf16 copy of X,
    widened; weights f32), as the JAX package's batched fit does: the
    same iterations, coefficients within the JAX test's f32 tolerance."""
    X, y = _clf()
    n = len(y)
    t = torch.from_numpy(X.astype(np.float32))
    kw = dict(n_classes=2, multinomial=False, fit_intercept=True, standardization=True, use_l1=False,
              max_iter=20)
    with pytest.raises(ValueError, match="objective_dtype"):
        tlk.logreg_fit_batched(t, torch.ones(n), torch.from_numpy(y.astype(np.float32)), l1=[0.0], l2=[0.1],
                               tol=[1e-6], objective_dtype="bfloat17", **kw)
    tout = tlk.logreg_fit_batched(t, torch.ones(n), torch.from_numpy(y.astype(np.float32)), l1=[0.0, 0.0],
                                  l2=[0.1, 0.01], tol=[1e-5, 1e-5], objective_dtype="bfloat16", **kw)
    with _x64_ctx(np.float32):
        jout = jlk.logreg_fit_batched(jnp.asarray(X, jnp.float32), jnp.ones((n,), jnp.float32),
                                      jnp.asarray(y, jnp.float32), l1=jnp.zeros(2, jnp.float32),
                                      l2=jnp.asarray([0.1, 0.01], jnp.float32), tol=jnp.full(2, 1e-5, jnp.float32),
                                      objective_dtype="bfloat16", **kw)
        jout = {k: np.asarray(v) for k, v in jout.items()}
    assert tout["coef_"].dtype == torch.float32
    assert np.all(np.abs(tout["n_iter"].numpy() - jout["n_iter"]) <= 1)
    for b in range(2):
        np.testing.assert_allclose(tout["coef_"][b].numpy(), jout["coef_"][b], rtol=JAX_RTOL,
                                   atol=_jax_atol(jout["coef_"][b]))


# ---------------------------------------------------------------------------
# the resolver and the buckets
# ---------------------------------------------------------------------------

RESOLVER_TABLE = [
    ("off", None, 8, 1.0),
    ("auto", None, 8, 1.0),
    ("3", None, 8, 1.0),
    ("auto", 1000.0, 8, 250.0),
    ("auto", 1000.0, 8, 5000.0),
    ("auto", 1e12, 8, 250.0),
    ("2", 1000.0, 8, 100.0),
    ("16", None, 8, 1e6),
    ("auto", None, 12, 16.0 * 3000 * 10),
    ("auto", None, 4, 2e9),
]


@pytest.mark.parametrize("setting,budget,n_lanes,lane_bytes", RESOLVER_TABLE)
def test_resolve_gang_fit_matches_jax(monkeypatch, setting, budget, n_lanes, lane_bytes):
    _gang(monkeypatch, setting if not setting.isdigit() else int(setting), budget)
    assert core.resolve_gang_fit(n_lanes, lane_bytes, torch.device("cpu")) == jcore.resolve_gang_fit(
        n_lanes, lane_bytes)


@pytest.mark.parametrize("setting,budget,match", [("bogus", None, "expected 'auto'"), (0, None, ">= 1"),
                                                   ("auto", -5.0, "> 0"), ("auto", 0.0, "> 0")])
def test_resolve_gang_fit_errors_match_jax(monkeypatch, setting, budget, match):
    _gang(monkeypatch, setting, budget)
    with pytest.raises(EnvSpecError):
        jcore.resolve_gang_fit(4, 1.0)
    with pytest.raises(core.GangFitConfigError, match=match):
        core.resolve_gang_fit(4, 1.0, torch.device("cpu"))
    assert issubclass(core.GangFitConfigError, ValueError)


def _param_sets(jest, test, maps):
    out = []
    for est in (jest, test):
        sets = []
        for kw in maps:
            e = est.copy()
            est._copy_tpu_params(e)
            e._set_params(**kw)
            sets.append(dict(e._tpu_params))
        out.append(sets)
    return out


def test_logreg_gang_buckets_match_jax():
    maps = [dict(regParam=r, elasticNetParam=e, maxIter=m, fitIntercept=f)
            for r in (0.1, 0.01, 0.0) for e in (0.0, 0.5) for m in (25, 40) for f in (True, False)]
    js, ts = _param_sets(JLogReg(), TLogReg(device="cpu"), maps)
    jg, tg = JLogReg()._gang_fit_groups(js), TLogReg(device="cpu")._gang_fit_groups(ts)
    assert tg == jg
    assert len(tg) == 8


def test_linreg_gang_buckets_match_jax():
    maps = [dict(regParam=r, elasticNetParam=e, maxIter=m) for r in (0.0, 0.1, 0.2) for e in (0.0, 0.5, 1.0)
            for m in (100, 300)]
    js, ts = _param_sets(JLinReg(), TLinReg(device="cpu"), maps)
    jg, tg = JLinReg()._gang_fit_groups(js), TLinReg(device="cpu")._gang_fit_groups(ts)
    assert tg == jg
    # the Cholesky lanes (regParam 0 or elasticNetParam 0) are in no bucket
    assert sorted(i for _, idx in tg for i in idx) == [i for i, m in enumerate(maps)
                                                      if m["regParam"] * m["elasticNetParam"] > 0]
    assert TLinReg(device="cpu")._gang_fit_groups(ts[:2]) is None


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _jax_test_frames(classes, dtype=np.float64):
    """The JAX test's ``_clf_data(seed=5, classes)`` rows in both packages."""
    rng = np.random.default_rng(5)
    n, d = 3000, 10
    X = rng.normal(size=(n, d))
    if classes == 2:
        y = (X @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0).astype(float)
    else:
        W = rng.normal(size=(d, classes))
        y = np.argmax(X @ W + 0.5 * rng.normal(size=(n, classes)), axis=1).astype(float)
    cols = {"features": X.astype(dtype), "label": y}
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


def _grid(pgb, est, reg, enet):
    return pgb.addGrid(est.getParam("regParam"), list(reg)).addGrid(est.getParam("elasticNetParam"),
                                                                    list(enet)).build()


def _fit_multiple(est, df, grid):
    return [m for _, m in sorted(est.fitMultiple(df, grid), key=lambda t: t[0])]


@pytest.mark.parametrize("classes", [2, 3])
def test_gang_fitmultiple_f64_matches_jax_sequential(monkeypatch, classes):
    """The JAX test's setup in f64: the port's gang against the JAX
    package's sequential fits and the port's, rtol 1e-6, iterations within
    1; each lane's report; the sequential models carry none."""
    jdf, tdf = _jax_test_frames(classes)
    kw = dict(maxIter=40, tol=1e-8, float32_inputs=False)
    jlr, tlr = JLogReg(num_workers=1, **kw), TLogReg(device="cpu", **kw)
    reg, enet = [0.01, 0.1, 1.0], [0.0, 0.5]
    jseq = _fit_multiple(jlr, jdf, _grid(JPGB(), jlr, reg, enet))
    tgrid = _grid(TPGB(), tlr, reg, enet)
    tseq = _fit_multiple(tlr, tdf, tgrid)
    _gang(monkeypatch)
    gang = _fit_multiple(tlr, tdf, tgrid)
    for a, s, b in zip(jseq, tseq, gang):
        assert b.coef_.dtype == np.float64
        for ref in (a, s):
            assert abs(ref.n_iter_ - b.n_iter_) <= 1
            np.testing.assert_allclose(b.coef_, np.asarray(ref.coef_), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(b.intercept_, np.asarray(ref.intercept_), rtol=1e-6, atol=1e-9)
        assert b._fit_report["gang_lanes"] == 3 and b._fit_report["gang_groups"] == 2
        assert s._fit_report == {}


@pytest.mark.parametrize("classes", [2, 3])
def test_gang_fitmultiple_f32_matches_sequential(monkeypatch, classes):
    """The JAX test's rows, grid and maxIter in f32 at tol 1e-5: the port's
    gang against the JAX package's sequential fits and the port's, at the
    JAX test's tolerances (iterations within 1, coefficients rtol 5e-3,
    atol 1e-5·max(1, max|coef|)). The JAX test's tol 1e-8 is held in f64
    above: in f32 it is below the objective's resolution (and 1e-6 is at
    its edge on one OWL-QN lane of the 3-class grid, where a stop one
    iteration later moves a coefficient by 2x the tolerance), so where a
    lane stops would be set by rounding."""
    jdf, tdf = _jax_test_frames(classes, np.float32)
    kw = dict(maxIter=40, tol=1e-5)
    jlr, tlr = JLogReg(num_workers=1, **kw), TLogReg(device="cpu", **kw)
    reg, enet = [0.01, 0.1, 1.0], [0.0, 0.5]
    jseq = _fit_multiple(jlr, jdf, _grid(JPGB(), jlr, reg, enet))
    tgrid = _grid(TPGB(), tlr, reg, enet)
    tseq = _fit_multiple(tlr, tdf, tgrid)
    _gang(monkeypatch)
    gang = _fit_multiple(tlr, tdf, tgrid)
    for a, s, b in zip(jseq, tseq, gang):
        for ref in (a, s):
            ca = np.asarray(ref.coef_)
            assert abs(ref.n_iter_ - b.n_iter_) <= 1
            np.testing.assert_allclose(b.coef_, ca, rtol=JAX_RTOL, atol=_jax_atol(ca))
        assert b._fit_report["gang_lanes"] == 3 and b._fit_report["gang_groups"] == 2


def test_gang_fitmultiple_linreg_matches_sequential(monkeypatch):
    """The JAX test's LinearRegression grid plus a Cholesky map that takes
    the loop: the gang against the JAX package's sequential fits and the
    port's (coefficients rtol 1e-5, atol 1e-8, the JAX test's; intercepts
    atol 1e-6); the gang lanes carry the solo report's keys with the
    gang's."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(2000, 10)).astype(np.float32)
    y = (X @ rng.normal(size=10) + 0.3 * rng.normal(size=2000)).astype(np.float32)
    cols = {"features": X, "label": y}
    jln, tln = JLinReg(maxIter=300, tol=1e-10, num_workers=1), TLinReg(maxIter=300, tol=1e-10, device="cpu")
    jgrid = _grid(JPGB(), jln, [0.01, 0.1], [0.5, 1.0]) + [{jln.getParam("regParam"): 0.1}]
    tgrid = _grid(TPGB(), tln, [0.01, 0.1], [0.5, 1.0]) + [{tln.getParam("regParam"): 0.1}]
    jseq = _fit_multiple(jln, JDataFrame(dict(cols)), jgrid)
    tseq = _fit_multiple(tln, TDataFrame(dict(cols)), tgrid)
    _gang(monkeypatch)
    gang = _fit_multiple(tln, TDataFrame(dict(cols)), tgrid)
    for a, s, b in zip(jseq, tseq, gang):
        for ref in (a, s):
            np.testing.assert_allclose(b.coefficients, np.asarray(ref.coefficients), rtol=1e-5, atol=1e-8)
            # mean_y - β·mean_x: f32 cancellation of O(1) terms
            np.testing.assert_allclose(b.intercept, ref.intercept, rtol=1e-5, atol=1e-6)
    for b in gang[:4]:
        assert b._fit_report["gang_lanes"] == 4 and b._fit_report["gang_groups"] == 1
        assert {"suffstats_s", "stats_cached", "solve_s", "n_iter", "shifted_gram_launches"} <= set(b._fit_report)
        assert b._fit_report["n_iter"] == b._model_attributes["n_iter"] > 1
    # the Cholesky map took the loop: the solo report alone
    assert "gang_lanes" not in gang[4]._fit_report and gang[4]._fit_report["n_iter"] == 1
    assert tcounters.snapshot()["gang_dispatches"] == 1 and tcounters.snapshot()["gang_lanes_total"] == 4


def _cv_frames(n=2400, seed=10, f64=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    y = (X @ rng.normal(size=10) + 0.5 * rng.normal(size=n) > 0).astype(float)
    cols = {"features": X if f64 else X.astype(np.float32), "label": y}
    return JDataFrame(dict(cols)), TDataFrame(dict(cols))


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_gang_cv_matches_jax_per_fold(monkeypatch, f64):
    """The port's fold-masked gang CV against the JAX package's per-fold
    CV (the JAX test's setup): avgMetrics rtol 5e-3 (atol 5e-4), the same
    best index, sub-models rtol 2e-2 (atol 1e-4·max), ``gang_fold``."""
    jdf, tdf = _cv_frames(f64=f64)
    kw = dict(maxIter=40, tol=1e-8) if not f64 else dict(maxIter=40, tol=1e-8, float32_inputs=False)
    jlr, tlr = JLogReg(num_workers=1, **kw), TLogReg(device="cpu", **kw)
    cv_kw = dict(numFolds=3, seed=13, collectSubModels=True)
    jcv = JCV(estimator=jlr, estimatorParamMaps=_grid(JPGB(), jlr, [0.01, 0.1], [0.0, 0.5]),
              evaluator=JMCE(metricName="logLoss"), **cv_kw)
    tcv = TCV(estimator=tlr, estimatorParamMaps=_grid(TPGB(), tlr, [0.01, 0.1], [0.0, 0.5]),
              evaluator=TMCE(metricName="logLoss"), **cv_kw)
    m_seq = jcv.fit(jdf)
    _gang(monkeypatch)
    m_gang = tcv.fit(tdf)
    np.testing.assert_allclose(m_gang.avgMetrics, m_seq.avgMetrics, rtol=5e-3, atol=5e-4)
    assert np.argmin(m_seq.avgMetrics) == np.argmin(m_gang.avgMetrics)
    for f in range(3):
        for a, b in zip(m_seq.subModels[f], m_gang.subModels[f]):
            ca = np.asarray(a.coef_)
            assert b.coef_.dtype == (np.float64 if f64 else np.float32)
            np.testing.assert_allclose(b.coef_, ca, rtol=2e-2, atol=1e-4 * max(1.0, np.abs(ca).max()))
            assert b._fit_report["gang_lanes"] == 6 and b._fit_report["gang_fold"] == f
    # 3 folds x 4 maps in two buckets (plain and OWL-QN) of six lanes
    snap = tcounters.snapshot()
    assert snap["gang_dispatches"] == 2 and snap["gang_lanes_total"] == 12


def test_gang_cv_counters_match_jax(monkeypatch):
    """The JAX test's gang-CV counters: one bucket of 3 folds x 2 maps."""
    jdf, tdf = _cv_frames(n=1200, seed=12)
    _gang(monkeypatch)
    snaps = []
    for lr_cls, cv_cls, pgb, mce, df, cnt, kw in (
            (JLogReg, JCV, JPGB, JMCE, jdf, jcounters, dict(num_workers=1)),
            (TLogReg, TCV, TPGB, TMCE, tdf, tcounters, dict(device="cpu"))):
        lr = lr_cls(maxIter=15, tol=1e-6, **kw)
        cv_cls(estimator=lr, estimatorParamMaps=_grid(pgb(), lr, [0.01, 0.1], [0.0]),
               evaluator=mce(metricName="accuracy"), numFolds=3, seed=1).fit(df)
        snaps.append({k: cnt.snapshot().get(k, 0) for k in ("gang_dispatches", "gang_lanes_total")})
    assert snaps[1] == snaps[0] == {"gang_dispatches": 1, "gang_lanes_total": 6}


def test_gang_budget_clamp_splits_dispatches(monkeypatch):
    """A budget of two lanes' bytes (the port's own ``_gang_lane_bytes``:
    its rows are not padded to the JAX package's 3,008) splits the bucket
    of four into two dispatches of two, in both packages."""
    jdf, tdf = _jax_test_frames(2, np.float32)
    tlr = TLogReg(maxIter=20, tol=1e-6, device="cpu")
    jlr = JLogReg(maxIter=20, tol=1e-6, num_workers=1)
    tgrid = _grid(TPGB(), tlr, [0.01, 0.1, 1.0, 10.0], [0.0])
    inputs = tlr._pre_process_data(tdf)
    tlr._get_gang_fit_func(tdf)
    budget = 2 * tlr._gang_lane_bytes(inputs)
    assert budget == 2 * 16.0 * 3000
    _gang(monkeypatch, budget=budget)
    gang = _fit_multiple(tlr, tdf, tgrid)
    assert all(m._fit_report["gang_lanes"] == 2 and m._fit_report["gang_groups"] == 2 for m in gang)
    _fit_multiple(jlr, jdf, _grid(JPGB(), jlr, [0.01, 0.1, 1.0, 10.0], [0.0]))
    want = {"gang_dispatches": 2, "gang_lanes_total": 4}
    assert {k: tcounters.snapshot()[k] for k in want} == {k: jcounters.snapshot()[k] for k in want} == want


def test_defaults_inert():
    """GANG_FIT off: fitMultiple repeats bit for bit, equal to one fit per
    map, no gang counter, no report; the CV equals its per-fold path."""
    _, tdf = _jax_test_frames(2, np.float32)
    lr = TLogReg(maxIter=25, tol=1e-7, device="cpu")
    grid = _grid(TPGB(), lr, [0.01, 0.1], [0.0, 0.5])
    a = _fit_multiple(lr, tdf, grid)
    b = _fit_multiple(lr, tdf, grid)
    for x, z, pm in zip(a, b, grid):
        one = lr.fit(tdf, pm)
        for m in (z, one):
            assert np.array_equal(x.coef_, m.coef_) and np.array_equal(x.intercept_, m.intercept_)
        assert x._fit_report == {}
    snap = tcounters.snapshot()
    assert snap.get("gang_dispatches", 0) == 0 and snap.get("gang_lanes_total", 0) == 0
    assert lr._gang_cv_fit_multiple(tdf, grid, 3, 0) is None


def test_cv_reraises_config_error_in_tolerant_mode(monkeypatch):
    """A bad GANG_FIT raises through CV_FAILFAST=False, as a bad
    TPUML_GANG_FIT raises through TPUML_CV_FAILFAST=0."""
    jdf, tdf = _cv_frames(n=600)
    monkeypatch.setattr(tuning, "CV_FAILFAST", False)
    monkeypatch.setenv("TPUML_CV_FAILFAST", "0")
    _gang(monkeypatch, "bogus")
    for lr, cv_cls, pgb, mce, df, err in ((JLogReg(maxIter=5, num_workers=1), JCV, JPGB, JMCE, jdf, EnvSpecError),
                                          (TLogReg(maxIter=5, device="cpu"), TCV, TPGB, TMCE, tdf,
                                           core.GangFitConfigError)):
        cv = cv_cls(estimator=lr, estimatorParamMaps=_grid(pgb(), lr, [0.01, 0.1], [0.0]),
                    evaluator=mce(metricName="accuracy"), numFolds=2)
        with pytest.raises(err):
            cv.fit(df)


def test_tolerant_mode_falls_back_to_the_per_fold_path(monkeypatch):
    """A gang solve that fails under CV_FAILFAST=False is logged and the
    per-fold path runs: the result equals the CV with the gang off; with
    CV_FAILFAST=True it raises."""
    _, tdf = _cv_frames(n=600)
    lr = TLogReg(maxIter=10, device="cpu")
    grid = _grid(TPGB(), lr, [0.01, 0.1], [0.0])
    mk = lambda: TCV(estimator=lr, estimatorParamMaps=grid, evaluator=TMCE(metricName="accuracy"), numFolds=2)
    off = mk().fit(tdf)

    def broken(*a, **k):
        raise RuntimeError("gang solve failed")

    monkeypatch.setattr(tlk, "minimize_lbfgs_batched", broken)
    _gang(monkeypatch)
    with pytest.raises(RuntimeError, match="gang solve failed"):
        mk().fit(tdf)
    monkeypatch.setattr(tuning, "CV_FAILFAST", False)
    assert mk().fit(tdf).avgMetrics == off.avgMetrics


def _spans(d):
    names = [n for n in os.listdir(d) if n.startswith("trace-")]
    assert len(names) == 1, names
    with open(os.path.join(d, names[0])) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in xs}
    return [(e["name"], by_id[e["args"]["parent_id"]]["name"] if "parent_id" in e["args"] else None, e["args"])
            for e in xs]


def test_gang_span_tree_matches_jax(monkeypatch, tmp_path):
    """The (span, parent) multiset of a gang fitMultiple (two buckets and a
    map of another maxIter, a lane of its own, that takes the loop) equals
    the JAX package's over the names both open, and the port opens no name
    the JAX package does not."""
    jdf, tdf = _cv_frames(n=600)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setenv("TPUML_TRACE", jdir)
    monkeypatch.setattr(ttel, "TRACE_DIR", tdir)
    _gang(monkeypatch)
    extra = lambda est: [{est.getParam("regParam"): 0.3, est.getParam("maxIter"): 7}]
    jlr, tlr = JLogReg(maxIter=10, num_workers=1), TLogReg(maxIter=10, device="cpu")
    _fit_multiple(jlr, jdf, _grid(JPGB(), jlr, [0.01, 0.1], [0.0, 0.5]) + extra(jlr))
    _fit_multiple(tlr, tdf, _grid(TPGB(), tlr, [0.01, 0.1], [0.0, 0.5]) + extra(tlr))
    js, ts = _spans(jdir), _spans(tdir)
    jp = collections.Counter((n, p) for n, p, _ in js)
    tp = collections.Counter((n, p) for n, p, _ in ts)
    shared = {n for n, _ in jp} & {n for n, _ in tp}
    assert {n for n, _ in tp} - shared == set()
    assert {k: v for k, v in tp.items() if k[0] in shared} == {k: v for k, v in jp.items() if k[0] in shared}
    assert tp[("LogisticRegression.gang_fit", "LogisticRegression.fit")] == 2
    assert tp[("fit.dispatch", "LogisticRegression.fit")] == 1
    assert sorted((a["lanes"], a["bucket"]) for n, _, a in ts if n.endswith(".gang_fit")) == sorted(
        (a["lanes"], a["bucket"]) for n, _, a in js if n.endswith(".gang_fit"))
