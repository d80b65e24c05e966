"""Port parity: ``spark_rapids_ml_tpu_torch.ops.linalg`` (kernel K1's plain
version and the covariance / eigen glue) against the JAX package.

The JAX Pallas kernel runs in interpret mode on the CPU, as
``tests/test_pallas_kernels.py`` runs it. Inputs come from a seeded numpy
generator and pass to both packages as numpy arrays. Both sides compute in
f32 with different summation orders, so results agree to f32 rounding
relative to the result's scale (tolerances below), not bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import linalg as jlinalg
from spark_rapids_ml_tpu.parallel.mesh import make_mesh, shard_rows
from spark_rapids_ml_tpu_torch.ops import linalg as tlinalg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize(
    "n,tile,offset,masked",
    [
        (700, 128, 2.0, 0.1),     # ragged n: last tile overhangs
        (100, 256, 0.0, 0.0),     # n smaller than one tile
        (512, 128, 1e3, 0.3),     # large |mu|: the shift must absorb it
    ],
)
def test_shifted_gram_plain_matches_pallas_interpret(n, tile, offset, masked):
    d = 256
    rng = np.random.default_rng(n)
    X = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    m = (rng.random(n) >= masked).astype(np.float32)
    mu = X[:64].mean(axis=0)

    G_j, s_j = jlinalg._shifted_gram_pallas(
        jnp.asarray(X), jnp.asarray(m), jnp.asarray(mu), tile=tile, interpret=True
    )
    G_t, s_t = tlinalg.shifted_gram(torch.from_numpy(X), torch.from_numpy(m), torch.from_numpy(mu))
    # f32 sums of n products in two orders: relative error ~ sqrt(n)·2^-24
    assert _rel(G_t, G_j) < 1e-5
    assert _rel(s_t, s_j) < 1e-4


def test_shifted_gram_ragged_d_matches_float64():
    # d not a multiple of 128 (the reference's d = 3000 is such a width);
    # the JAX package only sends lane-aligned d to Pallas, so the oracle
    # here is float64 numpy
    n, d = 333, 200
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, d)).astype(np.float32)
    m = (rng.random(n) > 0.2).astype(np.float32)
    mu = X.mean(axis=0)
    G, s = tlinalg.shifted_gram(torch.from_numpy(X), torch.from_numpy(m), torch.from_numpy(mu))
    xs = (X.astype(np.float64) - mu) * m[:, None]
    assert _rel(G, xs.T @ xs) < 1e-5
    assert np.abs(s.numpy() - xs.sum(axis=0)).max() < 1e-3


@pytest.mark.parametrize("sorted_rows", [False, True])
def test_mean_and_cov_chunked_matches_jax(sorted_rows):
    # num_workers=1 on both sides: same padding, same strided μ̂ estimate
    n, d, csize = 1000, 256, 96
    rng = np.random.default_rng(7)
    X = (rng.normal(size=(n, d)) * 0.5 + 50.0).astype(np.float32)
    if sorted_rows:  # drifting magnitude: the leading-chunk estimate would fail
        X = X[np.argsort(X[:, 0])]
    mesh = make_mesh(1)
    Xj, mj = shard_rows(X, mesh, csize)
    mean_j, cov_j, n_j = jlinalg.mean_and_cov_chunked(Xj, mj, mesh, csize)

    from spark_rapids_ml_tpu_torch.parallel.mesh import shard_rows as tshard

    Xt, mt = tshard(X, torch.device("cpu"), csize)
    assert Xt.shape[0] == Xj.shape[0]
    mean_t, cov_t, n_t = tlinalg.mean_and_cov_chunked(Xt, mt, csize)

    assert float(n_t) == float(n_j) == n
    # means ~50 in f32: ulp 4e-6; covariances ~0.25 after the rank-1 fix
    assert np.abs(mean_t.numpy() - np.asarray(mean_j)).max() < 1e-4
    assert _rel(cov_t, cov_j) < 1e-4
    cov64 = np.cov(X.astype(np.float64), rowvar=False)
    assert _rel(cov_t, cov64) < 1e-3


def test_mean_and_cov_and_standardize_moments_match_jax():
    n, d = 300, 40
    rng = np.random.default_rng(13)
    X = (rng.normal(size=(n, d)) * 2.0 + 10.0).astype(np.float32)
    m = (rng.random(n) > 0.2).astype(np.float32)
    Xt, mt = torch.from_numpy(X), torch.from_numpy(m)
    Xj, mj = jnp.asarray(X), jnp.asarray(m)
    for port, ref in zip(tlinalg.mean_and_cov(Xt, mt), jlinalg.mean_and_cov(Xj, mj)):
        assert _rel(port, ref) < 1e-5  # centred before the Gram on both sides
    for port, ref in zip(tlinalg.standardize_moments(Xt, mt), jlinalg.standardize_moments(Xj, mj)):
        assert _rel(port, ref) < 1e-5


@pytest.mark.parametrize("ddof", [0, 1])
def test_standardize_moments_in_chunks_match_numpy(monkeypatch, ddof):
    # chunks of 64 rows over 300: the last chunk is ragged; ddof=1 is the
    # sample std LogisticRegression standardizes by
    n, d = 300, 24
    rng = np.random.default_rng(17)
    X = (rng.normal(size=(n, d)) * 3.0 + 50.0).astype(np.float32)
    m = (rng.random(n) > 0.25).astype(np.float32)
    monkeypatch.setattr(tlinalg, "_MOMENT_CHUNK", 64)
    mean, std, cnt = tlinalg.standardize_moments(torch.from_numpy(X), torch.from_numpy(m), ddof=ddof)
    Xv = X[m > 0].astype(np.float64)
    assert float(cnt) == len(Xv)
    # means ~50 in f32 (ulp 4e-6), centred second pass: f32 rounding only
    assert np.abs(mean.numpy() - Xv.mean(axis=0)).max() < 1e-4
    assert _rel(std, Xv.std(axis=0, ddof=ddof)) < 1e-5


def test_topk_eigh_and_sign_flip_match_jax():
    d, k = 64, 6
    rng = np.random.default_rng(11)
    B = rng.normal(size=(d, d))
    # well-separated spectrum so eigenvectors are determined up to sign
    cov = (B @ np.diag(np.linspace(10.0, 0.1, d)) @ B.T / d).astype(np.float32)
    ev_j, V_j = jlinalg.topk_eigh(jnp.asarray(cov), k)
    ev_t, V_t = tlinalg.topk_eigh(torch.from_numpy(cov), k)
    assert np.allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-4)
    # sign_flip fixes the sign both packages report: max-|.| entry positive
    idx = np.abs(V_t.numpy()).argmax(axis=0)
    assert (V_t.numpy()[idx, np.arange(k)] > 0).all()
    assert np.abs(V_t.numpy() - np.asarray(V_j)).max() < 1e-3
    flipped = tlinalg.sign_flip(-V_t)
    assert torch.equal(flipped, V_t)
