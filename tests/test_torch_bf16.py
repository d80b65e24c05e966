"""Port parity: the bf16 contracts of kernels K2 and K3 and the fits they
carry (``KMeans(matmul_dtype="bfloat16")``, resident and streamed;
``LogisticRegression(objective_dtype="bfloat16")`` and its bf16 placement
of X; the bf16 gang) against the JAX package.

K2's bf16 contract: rows and centres rounded to bf16 in the score product,
the row weight rounded to bf16 times the bf16 rows in the sums, f32
accumulation; the norms, cost and counts f32. K3's: bf16 X, and where the
JAX package runs its Pallas kernel (d % 128 == 0, d <= 2,048, K <= 120) A
and R rounded to bf16 before the two products; elsewhere its XLA
objective (X widened, A and R f32). The JAX Pallas kernels run in
interpret mode. A product of two bf16 values is exact in f32, so the two
packages differ by f32 accumulation order alone: the kernel-level
tolerances are f32 ones. The fits are held at the JAX tests' own bf16
tolerances or tighter (``test_kmeans.py``, ``test_pallas_kernels.py``,
``test_logistic_regression.py``).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.core import _x64_ctx
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.ops import kmeans_pallas as jkp
from spark_rapids_ml_tpu.ops import logreg_kernels as jlk
from spark_rapids_ml_tpu.ops import logreg_pallas as jlp
from spark_rapids_ml_tpu.ops.kmeans_kernels import _chunk_stats as j_chunk_stats
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
from spark_rapids_ml_tpu_torch.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as tkk
from spark_rapids_ml_tpu_torch.ops import logreg_kernels as tlk

BF16 = torch.bfloat16


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# K2's bf16 contract
# ---------------------------------------------------------------------------


def _lloyd_inputs(seed=9, n=2048, d=128, k=37):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    m = rng.uniform(0.1, 2.0, size=n).astype(np.float32)  # fractional weights
    m[-300:] = 0.0  # masked rows
    C = (X[:k] + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    return X, m, C


def test_k2_bf16_plain_matches_pallas_interpret(monkeypatch):
    """The plain version's bf16 contract against ``lloyd_step_pallas``
    (``matmul_dtype=bfloat16``, interpret mode; its tile shrunk to divide
    the rows, as the JAX test does): counts equal; sums and cost to f32
    accumulation (products exact). The f32 contract is no match."""
    X, m, C = _lloyd_inputs()
    monkeypatch.setattr(jkp, "_TILE", 512)
    jax.clear_caches()
    try:
        sj, cj, costj = jkp.lloyd_step_pallas(jnp.asarray(X), jnp.asarray(m), jnp.asarray(C),
                                              matmul_dtype=jnp.bfloat16, interpret=True)
        sj, cj, costj = np.asarray(sj), np.asarray(cj), float(costj)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    st, ct, costt = tkk.lloyd_step(*_t(X, m, C), matmul_dtype=BF16)
    np.testing.assert_array_equal(ct.numpy(), cj)
    scale = np.abs(sj).max()
    # f32 sums of <= 2,048 exact products a centre: a few units of 2^-24
    # times sqrt(rows) of the largest entry
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-5 * scale)
    assert abs(float(costt) - costj) <= 1e-5 * costj
    s32, c32, _ = tkk.lloyd_step(*_t(X, m, C))
    assert np.abs(s32.numpy() - sj).max() > 100 * 1e-5 * scale or not np.array_equal(c32.numpy(), cj)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_k2_bf16_xla_route_matches_jax_chunk_stats(dtype, monkeypatch):
    """``chunk_stats_xla`` under the bf16 option (the float64 fits' route;
    f32 here too) against the XLA branch of the JAX package's
    ``_chunk_stats``: bf16-rounded operands multiplied in X's dtype. Row
    validity 0/1 (the fits' mask): that branch counts Σ m, K2 the rows
    with m > 0."""
    X, m, C = _lloyd_inputs(seed=4, n=1024, d=40, k=11)
    m = (m > 0).astype(np.float32)
    X, m, C = X.astype(dtype), m.astype(dtype), C.astype(dtype)
    monkeypatch.setattr(jkp, "kmeans_pallas_ok", lambda *a: False)
    with _x64_ctx(dtype):
        sj, cj, costj = j_chunk_stats(jnp.asarray(X), jnp.asarray(m), jnp.asarray(C), csize=256,
                                      matmul_dtype=jnp.bfloat16)
        sj, cj, costj = np.asarray(sj), np.asarray(cj), float(costj)
    st, ct, costt = tkk.chunk_stats_xla(*_t(X, m, C), matmul_dtype=BF16)
    assert st.dtype == torch.from_numpy(X).dtype
    np.testing.assert_array_equal(ct.numpy(), cj)
    eps = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=eps * np.abs(sj).max())
    assert abs(float(costt) - costj) <= eps * costj


def test_kmeans_lloyd_bf16_final_cost_in_f32():
    """The Lloyd iterations run the bf16 contract, the final cost pass
    f32: the reported cost is the f32 pass's at the converged centres."""
    X, m, C = _lloyd_inputs(seed=5, n=1024, d=32, k=8)
    Xt, mt, Ct = _t(X, m, C)
    centers, cost, it = tkk.kmeans_lloyd(Xt, mt, Ct, max_iter=4, tol=0.0, matmul_dtype=BF16)
    assert it == 4
    assert cost == float(tkk.lloyd_step(Xt, mt, centers)[2])
    ref, _, _ = tkk.kmeans_lloyd(Xt, mt, Ct, max_iter=4, tol=0.0)
    assert not torch.equal(centers, ref)  # the option changes the walk


def _blobs(n=900, d=16, k=6, seed=3):
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(k, d)) * 4.0
    return (cent[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_kmeans_bf16_fits_match_jax(init):
    """``KMeans(matmul_dtype="bfloat16")`` resident and streamed against
    the JAX package's resident bf16 fit (the same seeds): centres within
    1e-3 (the JAX test holds bf16 to f32 at 2e-2), costs at rtol 1e-4."""
    X = _blobs()
    kw = dict(k=6, seed=2, initMode=init, maxIter=20, matmul_dtype="bfloat16")
    jm = JKMeans(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    tm = TKMeans(device="cpu", **kw).fit(TDataFrame({"features": X}))
    ts = TKMeans(device="cpu", streaming=True, stream_chunk_rows=128, **kw).fit(TDataFrame({"features": X}))
    jc = np.asarray(jm.cluster_centers_)
    for model in (tm, ts):
        np.testing.assert_allclose(model.cluster_centers_, jc, rtol=0, atol=1e-3)
        assert abs(model.trainingCost - jm.trainingCost) <= 1e-4 * jm.trainingCost
    assert ts._ingest_report["passes"]["cost"] == 1


def test_kmeans_matmul_dtype_typo_raises():
    """The estimator resolves its string option (a typo raises); the ops
    take only ``torch.bfloat16`` or None, so any other value, a string
    spelling included, raises there."""
    X = _blobs(n=200)
    with pytest.raises(ValueError, match="matmul_dtype"):
        TKMeans(k=3, matmul_dtype="fp8", device="cpu").fit(TDataFrame({"features": X}))
    for bad in ("float16", "bfloat16", torch.float32):
        with pytest.raises(ValueError, match="matmul_dtype"):
            tkk.lloyd_step(*_t(X, np.ones(len(X), np.float32), X[:3]), matmul_dtype=bad)


# ---------------------------------------------------------------------------
# K3's bf16 contract
# ---------------------------------------------------------------------------


def _k3_inputs(seed, n, d, K, multinomial, a_std=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, K if multinomial else 2, size=n).astype(np.float32)
    m = (np.arange(n) < n - 13).astype(np.float32)
    A = (rng.normal(size=(K, d)) * a_std).astype(np.float32)
    b = (rng.normal(size=(K,)) * 0.1).astype(np.float32)
    return X, y, m, A, b


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 10)])
def test_k3_bf16_plain_matches_pallas_interpret(multinomial, K):
    """K3 on bf16 X at d = 128 (the Pallas contract: A and R rounded)
    against ``_loss_grad_pallas`` in interpret mode on the same bf16 X:
    to f32 accumulation (relative 1e-5 of the largest entry). Left
    unrounded, gA misses by ~1e-3."""
    n, d = 320, 128
    X, y, m, A, b = _k3_inputs(K, n, d, K, multinomial)
    assert tlk.bf16_round_ops(d, K)
    mesh = make_mesh(1)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp")))  # noqa: E731
    Xb = jnp.asarray(X).astype(jnp.bfloat16)
    f = jlp.make_fused_data_loss(put(Xb), put(y), put(m), mesh, K, multinomial, interpret=True)
    loss_j, (gA_j, gb_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    gA_j, scale = np.asarray(gA_j), float(np.abs(np.asarray(gA_j)).max())
    Xt = torch.from_numpy(X).to(BF16)
    yt, mt, At, bt = _t(y, m, A, b)
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(Xt, yt, mt, At, bt, multinomial)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_allclose(gA_t.numpy(), gA_j, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(gb_t.numpy(), np.asarray(gb_j), rtol=0, atol=1e-4)
    _, gA_u, _ = tlk.logreg_loss_grad_plain(Xt, yt, mt, At, bt, multinomial, round_ops=False)
    assert np.abs(gA_u.numpy() - gA_j).max() > 10 * 1e-5 * scale


@pytest.mark.parametrize("d,K,multinomial", [(100, 1, False), (100, 5, True), (128, 130, True), (2176, 1, False)])
def test_k3_bf16_xla_contract_matches_jax_autograd(d, K, multinomial):
    """Outside the Pallas shape terms (d % 128 != 0, K > 120, d > 2,048)
    the JAX package runs its XLA objective on bf16 X: X widened, A and R
    f32, the gradient by autograd. K3 keeps that contract there."""
    n = 256
    X, y, m, A, b = _k3_inputs(d + K, n, d, K, multinomial)
    assert not tlk.bf16_round_ops(d, K)
    Xj = jnp.asarray(X).astype(jnp.bfloat16).astype(jnp.float32)
    yj, mj = jnp.asarray(y), jnp.asarray(m)

    def f(Aj, bj):  # logreg_kernels.logreg_fit's loss where the gate refuses Pallas
        z = Xj @ Aj.T + bj[None, :]
        if multinomial:
            ll = jax.nn.logsumexp(z, axis=1) - jnp.take_along_axis(z, yj.astype(jnp.int32)[:, None], axis=1)[:, 0]
        else:
            ll = jax.nn.softplus(z[:, 0]) - yj * z[:, 0]
        return (ll * mj).sum()

    loss_j, (gA_j, gb_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    gA_j = np.asarray(gA_j)
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(torch.from_numpy(X).to(BF16), *_t(y, m, A, b), multinomial)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_allclose(gA_t.numpy(), gA_j, rtol=0, atol=1e-5 * np.abs(gA_j).max())
    np.testing.assert_allclose(gb_t.numpy(), np.asarray(gb_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [1, 100, 127, 128, 256, 384, 2048, 2049, 2176, 3000])
@pytest.mark.parametrize("K", [1, 2, 10, 119, 120, 121, 300])
def test_bf16_round_ops_is_the_jax_pallas_gate(d, K, monkeypatch):
    """The contract K3's wrapper picks is the JAX package's Pallas gate on
    bf16 X (with its backend term forced), shape for shape."""
    monkeypatch.setattr(jlp, "FORCE_INTERPRET", True)
    assert tlk.bf16_round_ops(d, K) == jlp.logreg_pallas_ok(d, K, jnp.bfloat16)


def test_k3_bf16_kernel_variants():
    """The bf16 instances a card launch takes: the rows kernel for the
    binomial main path (d <= 1,024, d % 4 == 0, aligned), the general
    kernel for every other shape."""
    assert tlk._k3_variant_bf16(256, 1, False) == 21
    assert tlk._k3_variant_bf16(1024, 1, False) == 81
    assert tlk._k3_variant_bf16(128, 1, False) == 11
    assert tlk._k3_variant_bf16(256, 1, False, aligned=False) == 0
    assert tlk._k3_variant_bf16(258, 1, False) == 0
    assert tlk._k3_variant_bf16(2048, 1, False) == 0
    assert tlk._k3_variant_bf16(1024, 64, True) == 0
    assert tlk._k3_variant_bf16(512, 300, True) == 0
    assert tlk.logreg_kernel_ok(BF16) and tlk.logreg_kernel_ok(torch.float32)
    assert not tlk.logreg_kernel_ok(torch.float64)


# ---------------------------------------------------------------------------
# LogisticRegression(objective_dtype="bfloat16")
# ---------------------------------------------------------------------------


def _cls(n, d, K, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if K == 2:
        y = (X @ rng.normal(size=d) > 0).astype(np.float32)
    else:
        y = (X @ rng.normal(size=(d, K))).argmax(axis=1).astype(np.float32)
    return X, y


def _jax_fit(X, y, pallas, **kw):
    jlp.FORCE_INTERPRET = pallas
    jax.clear_caches()
    try:
        return JLogReg(num_workers=1, **kw).fit(JDataFrame({"features": X, "label": y}))
    finally:
        jlp.FORCE_INTERPRET = False
        jax.clear_caches()


# (d, classes): d = 128 takes the Pallas contract (the JAX side in
# interpret mode), d = 100 the XLA one
FIT_CASES = [(128, 2), (128, 4), (100, 2), (100, 4)]


@pytest.mark.parametrize("d,K", FIT_CASES)
def test_logreg_bf16_fit_matches_jax_iterate_by_iterate(d, K):
    """Three L-BFGS iterations (tol 0) of the bf16 fit in both packages,
    X placed in bf16 by both estimators: coefficients within 1e-5 of
    their scale. A converged multinomial fit amplifies f32-level
    differences through the line search, so the walk is held early and
    the converged fit at the JAX tests' tolerance below."""
    X, y = _cls(1024, d, K)
    kw = dict(regParam=1e-2, maxIter=3, tol=0.0, objective_dtype="bfloat16")
    jm = _jax_fit(X, y, d % 128 == 0, **kw)
    tm = TLogReg(device="cpu", **kw).fit(TDataFrame({"features": X, "label": y}))
    jc = np.asarray(jm.coefficientMatrix)
    np.testing.assert_allclose(tm.coefficientMatrix, jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(tm.interceptVector, np.asarray(jm.interceptVector), rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,K", FIT_CASES)
def test_logreg_bf16_fit_matches_jax_converged(d, K):
    """The converged bf16 fits (maxIter 60) at ``test_pallas_kernels``'
    bf16 tolerance (rtol 0.05, atol 0.02), and the predictions equal but
    at the boundary; the bf16 fit beside the f32 one at
    ``test_logistic_regression``'s (rtol 0.08, atol 0.03)."""
    X, y = _cls(1024, d, K, seed=11)
    kw = dict(regParam=1e-3, maxIter=60, objective_dtype="bfloat16")
    jm = _jax_fit(X, y, d % 128 == 0, **kw)
    df = TDataFrame({"features": X, "label": y})
    tm = TLogReg(device="cpu", **kw).fit(df)
    f32 = TLogReg(device="cpu", regParam=1e-3, maxIter=60).fit(df)
    np.testing.assert_allclose(tm.coefficientMatrix, np.asarray(jm.coefficientMatrix), rtol=0.05, atol=0.02)
    pt = tm.transform(df).column("prediction")
    pj = np.asarray(jm.transform(JDataFrame({"features": X}))["prediction"])
    assert np.mean(pt == pj) > 0.99
    np.testing.assert_allclose(tm.coefficientMatrix, f32.coefficientMatrix, rtol=0.08, atol=0.03)


def test_logreg_bf16_places_x_in_bf16():
    """``objective_dtype="bfloat16"`` places X on the device in bf16 from
    the estimator-level setting (labels, weights and masks stay f32); the
    f32 default places f32."""
    df = TDataFrame({"features": np.ones((64, 4), np.float32), "label": np.zeros(64, np.float32)})
    est = TLogReg(objective_dtype="bfloat16", device="cpu")
    assert est._x_placement_dtype() == BF16
    assert TLogReg(device="cpu")._x_placement_dtype() is None
    inputs = est._pre_process_data(df)
    assert inputs.X.dtype == BF16
    assert inputs.mask.dtype == inputs.y.dtype == inputs.dtype == torch.float32
    assert TLogReg(device="cpu")._pre_process_data(df).X.dtype == torch.float32


def test_logreg_bf16_f64_fit_never_narrowed():
    """An f64 fit (``float32_inputs=False`` on f64 rows) under the bf16
    objective: X stays f64 on the device and the fit equals the f64 fit
    without the option bit for bit; ``objective_operand`` returns an f64
    X itself."""
    X, y = _cls(400, 12, 2, seed=3)
    df = TDataFrame({"features": X.astype(np.float64), "label": y.astype(np.float64)})
    kw = dict(float32_inputs=False, regParam=1e-3, maxIter=30, device="cpu")
    est = TLogReg(objective_dtype="bfloat16", **kw)
    assert est._pre_process_data(df).X.dtype == torch.float64
    b16 = est.fit(df)
    f64 = TLogReg(**kw).fit(df)
    np.testing.assert_array_equal(b16.coefficientMatrix, f64.coefficientMatrix)
    X64 = torch.from_numpy(X.astype(np.float64))
    assert tlk.objective_operand(X64, "bfloat16") is X64


def test_logreg_bf16_convert_guard_warns(monkeypatch, caplog):
    """An f32 X past the in-fit convert guard is read in f32, with the JAX
    package's warning (pass X placed in bf16 instead); below it the fit
    reads a bf16 copy. A typo raises ``ValueError``."""
    X = torch.zeros((64, 4))
    assert tlk.objective_operand(X, "bfloat16").dtype == BF16
    monkeypatch.setattr(tlk, "BF16_CONVERT_MAX_BYTES", 512)
    lg = logging.getLogger("spark_rapids_ml_tpu_torch.logreg_fit")  # the package logger does not propagate
    lg.addHandler(caplog.handler)
    try:
        assert tlk.objective_operand(X, "bfloat16") is X
    finally:
        lg.removeHandler(caplog.handler)
    assert any("objective_dtype=bfloat16 requested" in r.getMessage() for r in caplog.records)
    assert tlk.objective_operand(X, "bfloat16", warn=False) is X
    with pytest.raises(ValueError, match="objective_dtype"):
        tlk.objective_operand(X, "float16")
    with pytest.raises(ValueError, match="objective_dtype"):
        TLogReg(objective_dtype="fp8", device="cpu").fit(
            TDataFrame({"features": np.ones((8, 2), np.float32), "label": np.arange(8.0) % 2}))


def test_logreg_fit_bf16_moments_from_x_as_it_arrived():
    """``logreg_fit`` on an f32 X under the bf16 objective: the moments
    from the f32 rows, the data passes on the bf16 copy; equal to the
    JAX package's ``logreg_fit`` with the same arguments (XLA contract at
    d = 20)."""
    X, y = _cls(600, 20, 2, seed=5)
    X = X * np.linspace(0.5, 3.0, 20, dtype=np.float32) + 1.0
    n = len(y)
    kw = dict(n_classes=2, multinomial=False, fit_intercept=True, standardization=True, use_l1=False,
              max_iter=5, objective_dtype="bfloat16")
    with _x64_ctx(np.float32):
        jout = jlk.logreg_fit(jnp.asarray(X), jnp.ones((n,), jnp.float32), jnp.asarray(y),
                              l1=jnp.float32(0.0), l2=jnp.float32(1e-3), tol=jnp.float32(0.0), **kw)
        jc = np.asarray(jout["coef_"])
    tout = tlk.logreg_fit(*_t(X), torch.ones(n), *_t(y), l1=0.0, l2=1e-3, tol=0.0, **kw)
    np.testing.assert_allclose(tout["coef_"].numpy(), jc, rtol=0, atol=1e-5 * np.abs(jc).max())


# ---------------------------------------------------------------------------
# the bf16 gang
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [2, 3])
def test_bf16_gang_matches_its_sequential_lanes(K):
    """``logreg_fit_batched(objective_dtype="bfloat16")`` against each
    lane's own ``logreg_fit`` on the same bf16 X, at d = 20 (the XLA
    contract both take): the same iterations, coefficients at 1e-4 of
    their scale."""
    X, y = _cls(500, 20, K, seed=K)
    n = len(y)
    regs = [1e-3, 1e-2, 1e-1]
    kw = dict(n_classes=K, multinomial=K > 2, fit_intercept=True, standardization=True, use_l1=False,
              max_iter=30, objective_dtype="bfloat16")
    Xt, yt = _t(X, y)
    gang = tlk.logreg_fit_batched(Xt, torch.ones(n), yt, l1=[0.0] * 3, l2=regs, tol=[1e-6] * 3, **kw)
    for b, reg in enumerate(regs):
        solo = tlk.logreg_fit(Xt, torch.ones(n), yt, l1=0.0, l2=reg, tol=1e-6, **kw)
        assert abs(int(gang["n_iter"][b]) - int(solo["n_iter"])) <= 1
        scale = float(solo["coef_"].abs().max())
        np.testing.assert_allclose(gang["coef_"][b].numpy(), solo["coef_"].numpy(), rtol=0, atol=1e-4 * scale)


def test_bf16_gang_estimator_fit_multiple(monkeypatch):
    """The estimator's gang ``fitMultiple`` under the bf16 objective: one
    bf16-placed X for every map, each model equal to that map's own bf16
    fit (bit for bit where the gang is off)."""
    from spark_rapids_ml_tpu_torch import core

    X, y = _cls(500, 20, 2, seed=8)
    df = TDataFrame({"features": X, "label": y})
    est = TLogReg(objective_dtype="bfloat16", maxIter=30, device="cpu")
    maps = [{est.getParam("regParam"): r} for r in (1e-3, 1e-2)]
    solo = [TLogReg(objective_dtype="bfloat16", maxIter=30, regParam=r, device="cpu").fit(df) for r in (1e-3, 1e-2)]
    loop = dict(est.fitMultiple(df, maps))
    for i in range(2):
        np.testing.assert_array_equal(loop[i].coefficientMatrix, solo[i].coefficientMatrix)
    monkeypatch.setattr(core, "GANG_FIT", "auto")
    gang = dict(est.fitMultiple(df, maps))
    for i in range(2):
        np.testing.assert_allclose(gang[i].coefficientMatrix, solo[i].coefficientMatrix, rtol=0.05, atol=0.02)


def test_widened_product_blocks_rows_and_saves_only_the_bf16_x(monkeypatch):
    """``widened_product`` on a bf16 X: the value and M's gradient equal
    the product with X widened whole, each widening is one block of rows,
    and autograd saves no f32 (n, d) copy of X."""
    from spark_rapids_ml_tpu_torch.ops import linalg as tlin

    monkeypatch.setattr(tlin, "_MOMENT_CHUNK", 64)
    widened = []

    def spy(X, lo, dtype):
        out = tlin._rows_as(X, lo, dtype)
        widened.append(out.shape[0])
        return out

    monkeypatch.setattr(tlk, "_rows_as", spy)
    rng = np.random.default_rng(3)
    n, d = 300, 8
    Xb = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(BF16)
    M = torch.from_numpy(rng.normal(size=(d, 5)).astype(np.float32)).requires_grad_(True)
    G = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append((t.dtype, tuple(t.shape))) or t,
                                                  lambda t: t):
        out = tlk.widened_product(Xb, M)
    (gM,) = torch.autograd.grad(out, M, G)
    Mr = M.detach().clone().requires_grad_(True)
    ref = Xb.float() @ Mr
    (gr,) = torch.autograd.grad(ref, Mr, G)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gM.numpy(), gr.numpy(), rtol=1e-5, atol=1e-5)
    assert widened and max(widened) <= 64
    assert saved == [(BF16, (n, d))]


def test_bf16_gang_saves_no_widened_x(monkeypatch):
    """The bf16 gang's evaluations widen X a block of rows at a time and
    keep no f32 (n, d) copy for the backward pass: its temporaries beside
    the bf16 X stay one block (the budget's ``16·n·K`` a lane holds), and
    the fit equals the one with a block of all rows."""
    from spark_rapids_ml_tpu_torch.ops import linalg as tlin

    X, y = _cls(500, 20, 3, seed=5)
    n, d = X.shape
    kw = dict(n_classes=3, multinomial=True, fit_intercept=True, standardization=True, use_l1=False,
              max_iter=15, objective_dtype="bfloat16")
    Xt, yt = _t(X, y)
    whole = tlk.logreg_fit_batched(Xt, torch.ones(n), yt, l1=[0.0] * 2, l2=[1e-3, 1e-2], tol=[1e-6] * 2, **kw)
    monkeypatch.setattr(tlin, "_MOMENT_CHUNK", 128)
    widened, saved = [], []

    def spy(X_, lo, dtype):
        out = tlin._rows_as(X_, lo, dtype)
        widened.append(out.shape[0])
        return out

    monkeypatch.setattr(tlk, "_rows_as", spy)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append((t.dtype, tuple(t.shape))) or t,
                                                  lambda t: t):
        blocks = tlk.logreg_fit_batched(Xt, torch.ones(n), yt, l1=[0.0] * 2, l2=[1e-3, 1e-2], tol=[1e-6] * 2,
                                        **kw)
    assert widened and max(widened) <= 128
    assert (BF16, (n, d)) in saved
    assert not [s for s in saved if s[0] != BF16 and s[1] == (n, d)]
    np.testing.assert_allclose(blocks["coef_"].numpy(), whole["coef_"].numpy(), rtol=0, atol=1e-5)
