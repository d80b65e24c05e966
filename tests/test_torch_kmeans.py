"""Port parity: ``spark_rapids_ml_tpu_torch.ops.kmeans_kernels`` (kernel K2's
plain version) and the k-means|| seeding against the JAX package.

The JAX Pallas Lloyd step runs in interpret mode on the CPU. Assignments
(hence counts) must agree exactly: the data keep every row clear of a
near-tie, so a different f32 summation order cannot flip one. Sums and cost
agree to f32 rounding relative to their scale.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it there);
here a numpy model of its 3xTF32 scores is held to the on-card band and to
the Pallas kernel, and its argmin walk and launch geometry are walked.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.models.clustering import KMeans as JKMeans
from spark_rapids_ml_tpu.models.clustering import _weighted_kmeanspp as j_wkpp
from spark_rapids_ml_tpu.ops import kmeans_kernels as jkk
from spark_rapids_ml_tpu.ops.kmeans_pallas import lloyd_step_pallas
from spark_rapids_ml_tpu.parallel.mesh import make_mesh, shard_rows
from spark_rapids_ml_tpu_torch.models.clustering import KMeans as TKMeans
from spark_rapids_ml_tpu_torch.models.clustering import _weighted_kmeanspp as t_wkpp
from spark_rapids_ml_tpu_torch.ops import kmeans_kernels as tkk
from spark_rapids_ml_tpu_torch.ops import knn_kernels as tkn


def _blobs(rng, n, d, k, spread=0.3):
    centers = rng.normal(size=(k, d)) * 3.0
    lab = rng.integers(0, k, size=n)
    X = centers[lab] + rng.normal(size=(n, d)) * spread
    return X.astype(np.float32), centers


@pytest.mark.parametrize("k", [37, 128])  # 37: not a multiple of 8
def test_lloyd_step_plain_matches_pallas_interpret(k):
    n, d = 4096, 256  # the Pallas kernel takes whole 2048-row tiles
    rng = np.random.default_rng(k)
    X, centers = _blobs(rng, n, d, k)
    C = (centers + rng.normal(size=centers.shape) * 0.1).astype(np.float32)
    m = (rng.random(n) > 0.1).astype(np.float32)

    s_j, c_j, cost_j = lloyd_step_pallas(
        jnp.asarray(X), jnp.asarray(m), jnp.asarray(C), interpret=True
    )
    s_t, c_t, cost_t = tkk.lloyd_step(torch.from_numpy(X), torch.from_numpy(m), torch.from_numpy(C))
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    # f32 sums of ~n/k rows in two orders
    assert np.abs(s_t.numpy() - np.asarray(s_j)).max() / np.abs(np.asarray(s_j)).max() < 1e-5
    assert abs(float(cost_t) - float(cost_j)) / float(cost_j) < 1e-5


def test_lloyd_step_tie_goes_to_lowest_index():
    # rows at the origin are equidistant from c and -c, and every row is
    # equidistant from a duplicated centre: jnp.argmin takes the first
    d = 256
    c = np.zeros((4, d), np.float32)
    c[0, 0], c[1, 0] = 1.0, -1.0
    c[2, 1] = 5.0
    c[3] = c[2]
    X = np.zeros((2048, d), np.float32)
    X[1024:, 1] = 5.0
    m = np.ones(2048, np.float32)
    s_j, c_j, _ = lloyd_step_pallas(jnp.asarray(X), jnp.asarray(m), jnp.asarray(c), interpret=True)
    s_t, c_t, _ = tkk.lloyd_step(torch.from_numpy(X), torch.from_numpy(m), torch.from_numpy(c))
    np.testing.assert_array_equal(c_t.numpy(), [1024, 0, 1024, 0])
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_min_sq_dists_and_count_closest_match_jax():
    n, d, k, csize = 1000, 256, 9, 128
    rng = np.random.default_rng(5)
    X, centers = _blobs(rng, n, d, k)
    C = centers.astype(np.float32)
    mesh = make_mesh(1)
    Xj, mj = shard_rows(X, mesh, csize)
    md_j = np.asarray(jkk.min_sq_dists(Xj, mj, jnp.asarray(C), mesh=mesh, csize=csize))
    cc_j = np.asarray(jkk.count_closest(Xj, mj, jnp.asarray(C), mesh=mesh, csize=csize))

    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows as tshard

    Xt, mt = tshard(X, torch.device("cpu"), csize)
    md_t = tkk.min_sq_dists(Xt, mt, torch.from_numpy(C), csize=csize).numpy()
    cc_t = tkk.count_closest(Xt, mt, torch.from_numpy(C)).numpy()
    # ||x||² - 2x·c + ||c||² cancels: absolute error ~ ulp(||x||²) ~ 1e-4
    assert np.abs(md_t - md_j).max() < 5e-3
    np.testing.assert_array_equal(cc_t, cc_j)


def _numpy_owner(X):
    """A host-only seeding owner: the same callbacks feed both packages, so
    the seeding's host logic is all that is compared."""
    n = X.shape[0]

    def min_d2_vs(cands):
        return ((X[:, None, :].astype(np.float64) - cands[None]) ** 2).sum(-1).min(axis=1)

    def count_closest(cands):
        a = ((X[:, None, :].astype(np.float64) - cands[None]) ** 2).sum(-1).argmin(axis=1)
        return np.bincount(a, minlength=len(cands))

    return {
        "offset": 0,
        "n_local": n,
        "gather_local": lambda idx: X[idx],
        "assemble": lambda rows: rows,
        "min_d2_vs": min_d2_vs,
        "reduce_sum": lambda x: x,
        "count_closest": count_closest,
    }


@pytest.mark.parametrize("k,steps", [(12, 2), (5, 3)])
def test_seeding_host_logic_picks_identical_centres(k, steps):
    rng = np.random.default_rng(21)
    X, _ = _blobs(rng, 600, 16, 8, spread=1.0)
    owner = _numpy_owner(X)
    cj = JKMeans._seed_scalable_kmeanspp(600, k, steps, 2.0, np.random.default_rng(9), owner)
    ct = TKMeans._seed_scalable_kmeanspp(600, k, steps, 2.0, np.random.default_rng(9), owner)
    np.testing.assert_array_equal(ct, cj)


def test_weighted_kmeanspp_identical_draws():
    rng = np.random.default_rng(4)
    cands = rng.normal(size=(60, 8))
    w = rng.integers(1, 50, size=60).astype(np.float64)
    np.testing.assert_array_equal(
        t_wkpp(cands, w, 7, np.random.default_rng(2)),
        j_wkpp(cands, w, 7, np.random.default_rng(2)),
    )


# ---------------------------------------------------------------------------
# K2 on the card (csrc/lloyd_step.cu) runs only there; these tests hold its
# arithmetic, its argmin walk and its launch arithmetic in numpy.
# ---------------------------------------------------------------------------

# chip_smoke.py's K2 band: two f32 scores within TAU_UNITS·u·√d·(‖x‖² +
# 2 max‖c‖²) may order either way
_TAU_UNITS, _U32 = 4.0, 2.0**-24
_INT_MAX = 0x7FFFFFFF


def _rz_f32(x):
    """f64 values to f32, rounded toward zero (the tensor cores' f32
    accumulation)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _split(a):
    return tuple(t.numpy().astype(np.float64) for t in tkn.tf32_split(torch.from_numpy(a)))


def _k2_scores_model(X, C, three=True):
    """The kernel's scores ``csq - 2·run`` in numpy: the centres split into
    TF32 hi and lo once (the prologue), each stage's rows split as the
    consumers split them, both zero-padded to whole k = 8 steps; per step
    each TF32 product (lo·hi', hi·lo', hi·hi' in that order, or hi·hi' alone
    for one-pass TF32) adds 8 exact products to the f32 accumulator,
    truncated; a fresh accumulator per slab of ``K2_SLAB`` features, folded
    into the running f32 score with a rounded add. ``csq`` is the wrapper's
    f32 ``(C*C).sum(1)``."""
    n, d = X.shape
    dp = -(-d // 8) * 8
    x = np.zeros((n, dp), np.float32)
    c = np.zeros((C.shape[0], dp), np.float32)
    x[:, :d], c[:, :d] = X, C
    ch, cl = _split(c)  # once a launch
    run = np.zeros((n, c.shape[0]), np.float32)
    for s0 in range(0, dp, tkk.K2_SLAB):
        xh, xl = _split(x[:, s0:s0 + tkk.K2_SLAB])  # each stage's rows
        pairs = ((xl, ch), (xh, cl), (xh, ch)) if three else ((xh, ch),)
        acc = np.zeros_like(run)
        for k0 in range(0, xh.shape[1], 8):
            for a, b in pairs:
                acc = _rz_f32(acc + a[:, k0:k0 + 8] @ b[:, s0 + k0:s0 + k0 + 8].T)
        run = run + acc  # f32: rounded to nearest
    csq = (torch.from_numpy(C) ** 2).sum(dim=1).numpy()
    return csq[None, :] - np.float32(2.0) * run


def _k2_band(X, C):
    x, c = X.astype(np.float64), C.astype(np.float64)
    return _TAU_UNITS * _U32 * np.sqrt(X.shape[1]) * ((x * x).sum(1) + 2.0 * (c * c).sum(1).max())


def _k2_rows(rng, n, d):
    if d == 256:  # chip_smoke.py's blobs: shrinking centre scales, unit noise
        centres = rng.normal(size=(64, d)) * (4.0 * 0.9 ** np.arange(d))
        return (centres[rng.integers(0, 64, n)] + rng.normal(size=(n, d))).astype(np.float32)
    return (rng.normal(size=(n, d)) + 3.0).astype(np.float32)  # its ragged shapes


@pytest.mark.parametrize("k", [37, 130])
@pytest.mark.parametrize("d", [124, 256, 300])
def test_3xtf32_score_error_within_k2_band(d, k):
    rng = np.random.default_rng(d + k)
    X = _k2_rows(rng, 256, d)
    C = X[rng.integers(0, 256, k)] + 0.1 * rng.normal(size=(k, d)).astype(np.float32)  # centres near rows
    x, c = X.astype(np.float64), C.astype(np.float64)
    ref = (c * c).sum(1)[None, :] - 2.0 * x @ c.T
    tau = _k2_band(X, C)[:, None]
    three = np.abs(_k2_scores_model(X, C) - ref) / tau
    one = np.abs(_k2_scores_model(X, C, three=False) - ref) / tau
    assert three.max() <= 0.5, three.max()  # inside the band with a factor 2 to spare
    assert one.max() > 1.0, one.max()  # one-pass TF32 falls outside it


def _k2_lloyd_model(X, m, C):
    """The kernel's outputs from the modelled scores: the first index of
    each row's minimum, sums and counts over rows with m > 0 (in f64: the
    atomics' order is free), cost Σ m·max(best + ‖x‖², 0)."""
    k, d = C.shape
    s = _k2_scores_model(X, C)
    a = s.argmin(axis=1)
    best = s[np.arange(len(a)), a].astype(np.float64)
    x = X.astype(np.float64)
    sums = np.zeros((k, d))
    np.add.at(sums, a, x * m[:, None])
    counts = np.bincount(a[m > 0], minlength=k)
    cost = (np.maximum(best + (x * x).sum(1), 0.0) * m).sum()
    return sums, counts, cost


@pytest.mark.parametrize("k,d", [(37, 256), (130, 124)])
def test_k2_model_matches_pallas_interpret(k, d):
    n = 4096  # the Pallas kernel takes whole 2048-row tiles
    rng = np.random.default_rng(k + d)
    X, centers = _blobs(rng, n, d, k)
    C = (centers + rng.normal(size=centers.shape) * 0.1).astype(np.float32)
    m = (rng.random(n) > 0.1).astype(np.float32)
    s_j, c_j, cost_j = lloyd_step_pallas(jnp.asarray(X), jnp.asarray(m), jnp.asarray(C), interpret=True)
    sums, counts, cost = _k2_lloyd_model(X, m, C)
    np.testing.assert_array_equal(counts, np.asarray(c_j))
    s_j = np.asarray(s_j, np.float64)
    # f32 sums of ~n/k rows in two orders
    assert np.abs(sums - s_j).max() / np.abs(s_j).max() < 1e-5
    # each row's best score is off the exact one by at most half its band
    # (the truncating accumulation leans one way, so these add up), then
    # f32 rounding of the sum
    slack = 0.5 * (m * _k2_band(X, C)).sum()
    assert abs(cost - float(cost_j)) <= slack + 1e-5 * float(cost_j), (cost, float(cost_j), slack)


def _take_min(s, i, bs, bi):
    """(s, i) replaces (bs, bi) in a lowest-index-on-ties minimum."""
    return (s, i) if s < bs or (s == bs and i < bi) else (bs, bi)


def _k2_argmin_model(S):
    """The kernel's argmin over the (128, k) scores of one row block, walked
    as the consumers walk it: per centre tile of 128 (columns past k at
    +inf, as ``csq_pad`` makes them), thread (warp w, lane 4g + t) holds
    fragments e of rows 16w + g + 8·((e >> 1) & 1) and columns 8·(e >> 2) +
    2t + (e & 1), takes each row's minimum in increasing e (strict <), then
    the quad's by xor shuffles 1 and 2 (lowest index on ties); a later tile
    replaces the running pair only when strictly smaller. Returns (best,
    arg, how often each (row, column) was read)."""
    k = S.shape[1]
    tiles = -(-k // 128)
    Sp = np.full((128, tiles * 128), np.inf, np.float32)
    Sp[:, :k] = S
    best = np.full(128, np.inf, np.float32)
    arg = np.zeros(128, np.int64)
    hits = np.zeros(Sp.shape, int)
    for lt in range(tiles):
        c0 = 128 * lt
        th = {}
        for warp in range(8):
            for lane in range(32):
                g, t = divmod(lane, 4)
                r0 = warp * 16 + g
                bv, ba = [np.float32(np.inf)] * 2, [_INT_MAX] * 2
                for e in range(64):
                    h = (e >> 1) & 1
                    col = c0 + 8 * (e >> 2) + 2 * t + (e & 1)
                    hits[r0 + 8 * h, col] += 1
                    if Sp[r0 + 8 * h, col] < bv[h]:
                        bv[h], ba[h] = Sp[r0 + 8 * h, col], col
                th[warp, lane] = (bv, ba)
        for off in (1, 2):  # each lane takes its partner's pair, as the shuffles do
            th = {(w, ln): tuple(zip(*(_take_min(th[w, ln ^ off][0][h], th[w, ln ^ off][1][h], th[w, ln][0][h],
                                                 th[w, ln][1][h]) for h in (0, 1))))
                  for (w, ln) in th}
        for (warp, lane), (bv, ba) in th.items():
            g = lane // 4
            assert (bv, ba) == th[warp, 4 * g]  # the quad agrees
            for h in (0, 1):
                r = warp * 16 + g + 8 * h
                if bv[h] < best[r]:  # strict <: later tiles hold higher indices
                    best[r], arg[r] = bv[h], ba[h]
    return best, arg, hits


@pytest.mark.parametrize("k", [1, 37, 128, 130, 300])
def test_k2_argmin_walk_covers_the_tile_and_keeps_the_first_minimum(k):
    rng = np.random.default_rng(k)
    # small integers: exact ties everywhere, inside a thread, a quad and
    # across tiles
    S = rng.integers(0, 6, size=(128, k)).astype(np.float32)
    if k >= 6:  # row 0: a tie inside one quad (lanes t = 2 and t = 1 of j = 0)
        S[0, :] = 9
        S[0, [5, 3]] = -1
    if k >= 10:  # row 3: inside one thread (t = 0 at j = 1 and j = 0)
        S[3, :] = 9
        S[3, [9, 1]] = -1
    if k > 128:  # row 1: across a tile edge; row 2: inside the second tile
        S[1, :] = 9
        S[1, [127, 128]] = -1
        S[2, :] = 9
        S[2, [k - 1, 128]] = -2
    best, arg, hits = _k2_argmin_model(S)
    assert (hits == 1).all()  # every score of every tile read once
    np.testing.assert_array_equal(arg, S.argmin(axis=1))
    np.testing.assert_array_equal(best, S.min(axis=1))
    if k >= 6:
        assert arg[0] == 3
    if k > 128:
        assert (arg[1], arg[2]) == (127, 128)


def test_k2_kernel_constants():
    src = (Path(tkk.__file__).parent.parent / "csrc" / "lloyd_step.cu").read_text()
    assert f"constexpr int BM = {tkk._LLOYD_ROWS};" in src
    assert f"constexpr int BN = {tkk._LLOYD_CENTRES};" in src
    assert f"constexpr int BK = {tkk.K2_SLAB};" in src
    assert f"constexpr int MAX_STAGES = {max(tkk._STAGES)};" in src
    assert "constexpr int WALKERS = PRODUCERS - 32;" in src and "constexpr int PRODUCERS = 128;" in src
    assert tkk._WALK_WARPS == (128 - 32) // 32
    assert "return 1024 + (size_t)stages * (SLOT * 4 + 8) + 2 * BM * 8;" in src
    assert "constexpr int SLOT = (BM + 2 * BN) * BK;" in src


@pytest.mark.parametrize("d", [61, 124, 256, 257, 3000])
@pytest.mark.parametrize("k", [1, 37, 130, 1024, 4097])
@pytest.mark.parametrize("n", [1, 1_037, 100_003, 12_000_000])
def test_k2_geometry(n, k, d):
    dk = -(-d // 4) * 4  # the wrapper's padded width
    g = tkk._lloyd_geometry(n, k, dk)
    assert g.stages == max(tkk._STAGES) and g.smem == tkk._lloyd_smem(g.stages) <= 232_448
    assert g.row_blocks == -(-n // 128) and 1 <= g.grid <= min(g.row_blocks, 132)
    assert g.split_floats == k * dk  # each of the centres' hi and lo: 2 MB at k = 1024
    assert g.csq_floats % 128 == 0 and k <= g.csq_floats < k + 128
    assert g.cost_floats == 3 * g.row_blocks
    # the kernel's walk: block b takes row blocks b, b + grid, ... (nloc of
    # them), each written once
    b = np.arange(g.grid)
    nloc = (g.row_blocks - 1 - b) // g.grid + 1
    seen = np.concatenate([bb + np.arange(nl) * g.grid for bb, nl in zip(b, nloc)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(g.row_blocks))
    assert tkk._lloyd_geometry(n, k, dk, blocks_per_sm=2).grid == min(g.row_blocks, 264)


def test_k2_geometry_forced_and_refused():
    assert tkk._lloyd_geometry(1000, 10, 8, stages=2).stages == 2
    assert tkk._lloyd_geometry(1000, 10, 8, smem_per_block=160_000).stages == 3
    with pytest.raises(NotImplementedError):
        tkk._lloyd_geometry(1000, 10, 8, smem_per_block=90_000)


def test_k2_operands_pad_and_align():
    rng = np.random.default_rng(3)
    # d % 4 != 0: both padded with zero features, scores unchanged
    X = torch.from_numpy(rng.normal(size=(50, 61)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(7, 61)).astype(np.float32))
    Xk, Ck = tkk.lloyd_operands(X, C)
    assert Xk.shape == (50, 64) and Ck.shape == (7, 64)
    assert (Xk[:, 61:] == 0).all() and (Ck[:, 61:] == 0).all()
    torch.testing.assert_close(Xk @ Ck.T, X @ C.T, rtol=0, atol=1e-5)
    # a base 4 bytes off 16-byte alignment: that operand is copied, the
    # aligned one passed as it is
    buf = torch.from_numpy(rng.normal(size=(50 * 256 + 1,)).astype(np.float32))
    Xm = buf[1:].view(50, 256)
    C2 = torch.from_numpy(rng.normal(size=(7, 256)).astype(np.float32))
    assert Xm.data_ptr() % 16 and C2.data_ptr() % 16 == 0
    Xk, Ck = tkk.lloyd_operands(Xm, C2)
    assert Xk.data_ptr() % 16 == 0 and Xk.data_ptr() != Xm.data_ptr() and torch.equal(Xk, Xm)
    assert Ck.data_ptr() == C2.data_ptr()
