"""Port parity: ``spark_rapids_ml_tpu_torch.ops.logreg_kernels`` (kernel K3's
plain version and its ``torch.autograd.Function``) and ``ops.lbfgs``
against the JAX package.

The JAX fused loss runs its Pallas kernel in interpret mode on the CPU.
Both sides compute in f32 with different summation orders, so values agree
to f32 rounding relative to their scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.ops.lbfgs import minimize_lbfgs as j_minimize
from spark_rapids_ml_tpu.ops.logreg_pallas import make_fused_data_loss as j_fused
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch.ops import logreg_kernels as tlk
from spark_rapids_ml_tpu_torch.ops.lbfgs import minimize_lbfgs as t_minimize


def _problem(seed, n, d, K, multinomial):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, K if multinomial else 2, size=n).astype(np.float32)
    m = (np.arange(n) < n - 13).astype(np.float32)
    A = (rng.normal(size=(K, d)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(K,)) * 0.1).astype(np.float32)
    return X, y, m, A, b


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 5)])
def test_fused_loss_grad_plain_matches_pallas_interpret(multinomial, K):
    n, d = 320, 256
    X, y, m, A, b = _problem(K, n, d, K, multinomial)
    mesh = make_mesh(1)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp")))  # noqa: E731
    f = j_fused(put(X), put(y), put(m), mesh, K, multinomial, interpret=True)
    loss_j, (gA_j, gb_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))

    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(*t, multinomial)
    # f32 sums over n rows: relative ~ sqrt(n)·2^-24
    assert abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)) < 1e-5
    assert np.abs(gA_t.numpy() - np.asarray(gA_j)).max() / np.abs(np.asarray(gA_j)).max() < 1e-4
    assert np.abs(gb_t.numpy() - np.asarray(gb_j)).max() < 1e-3


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 5)])
def test_autograd_function_matches_autograd_of_plain_loss(multinomial, K):
    n, d = 200, 40
    X, y, m, A, b = _problem(10 + K, n, d, K, multinomial)
    Xt, yt, mt = (torch.from_numpy(v) for v in (X, y, m))
    f = tlk.make_fused_data_loss(Xt, yt, mt, multinomial)

    A1 = torch.from_numpy(A).requires_grad_(True)
    b1 = torch.from_numpy(b).requires_grad_(True)
    loss1 = f(A1, b1)
    g1 = torch.autograd.grad(3.0 * loss1, (A1, b1))  # a cotangent != 1

    A2 = torch.from_numpy(A).requires_grad_(True)
    b2 = torch.from_numpy(b).requires_grad_(True)
    z = Xt @ A2.T + b2[None, :]
    if multinomial:
        ll = torch.logsumexp(z, 1) - z.gather(1, yt.long()[:, None])[:, 0]
    else:
        ll = torch.nn.functional.softplus(z[:, 0]) - yt * z[:, 0]
    loss2 = (ll * mt).sum()
    g2 = torch.autograd.grad(3.0 * loss2, (A2, b2))

    assert abs(float(loss1.detach()) - float(loss2.detach())) < 1e-4 * abs(float(loss2.detach()))
    for a, r in zip(g1, g2):
        assert (a - r).abs().max() <= 1e-5 * r.abs().max() + 1e-6


@functools.partial(jax.jit, static_argnames=("use_l1",))
def _jax_solve(X, y, l1w, l2, use_l1):
    def fj(w):
        z = X @ w
        return jnp.mean(jax.nn.softplus(z) - y * z) + 0.5 * l2 * jnp.vdot(w, w)

    return j_minimize(
        fj, jnp.zeros((X.shape[1],), jnp.float32), max_iter=100, tol=1e-7,
        l1_weights=l1w if use_l1 else None,
    )


@pytest.mark.parametrize("l1", [0.0, 0.02])  # 0: L-BFGS with L2; > 0: OWL-QN
def test_minimize_lbfgs_matches_jax(l1):
    n, p = 400, 12
    rng = np.random.default_rng(31)
    X = rng.normal(size=(n, p)).astype(np.float32)
    w_true = rng.normal(size=p) * (rng.random(p) > 0.5)
    y = (X @ w_true + rng.normal(size=n) * 0.5 > 0).astype(np.float32)
    l2 = 0.05
    l1w = np.full((p,), l1, np.float32)

    res_j = _jax_solve(jnp.asarray(X), jnp.asarray(y), jnp.asarray(l1w), l2, l1 > 0)

    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def ft(w):
        z = Xt @ w
        return torch.mean(torch.nn.functional.softplus(z) - yt * z) + 0.5 * l2 * torch.dot(w, w)

    res_t = t_minimize(
        ft, torch.zeros(p), max_iter=100, tol=1e-7,
        l1_weights=torch.from_numpy(l1w) if l1 > 0 else None,
    )
    # same algorithm on the same problem: the optimum agrees to the f32
    # resolution of the objective; OWL-QN lands exact zeros in the same slots
    assert abs(res_t.f - float(res_j.f)) < 1e-5
    assert np.abs(res_t.w.numpy() - np.asarray(res_j.w)).max() < 2e-3
    if l1 > 0:
        np.testing.assert_array_equal(res_t.w.numpy() == 0, np.asarray(res_j.w) == 0)
