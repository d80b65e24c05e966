"""Port parity: ``spark_rapids_ml_tpu_torch.ops.kmeans_kernels`` (kernel K2's
plain version) and the k-means|| seeding against the JAX package.

The JAX Pallas Lloyd step runs in interpret mode on the CPU. Assignments
(hence counts) must agree exactly: the data keep every row clear of a
near-tie, so a different f32 summation order cannot flip one. Sums and cost
agree to f32 rounding relative to their scale.
"""

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
