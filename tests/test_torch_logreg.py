"""Port parity: ``spark_rapids_ml_tpu_torch.ops.logreg_kernels`` (kernel K3's
plain version and its ``torch.autograd.Function``) and ``ops.lbfgs``
against the JAX package.

The JAX fused loss runs its Pallas kernel in interpret mode on the CPU.
Both sides compute in f32 with different summation orders, so values agree
to f32 rounding relative to their scale.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.classification import LogisticRegression as JLogReg
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.ops.lbfgs import minimize_lbfgs as j_minimize
from spark_rapids_ml_tpu.ops.logreg_pallas import make_fused_data_loss as j_fused
from spark_rapids_ml_tpu.parallel.mesh import make_mesh
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.classification import LogisticRegression as TLogReg
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


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 5), (True, 10)])
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


# shapes that the card sends to K3's tile kernel (binomial d > 1024,
# multinomial past d <= 256 or K <= 16): d = 1,152 and 20 classes at
# d = 384 go through the JAX package's Pallas kernel in interpret mode;
# d = 3,000 (not a multiple of 128, so ``logreg_pallas_ok`` refuses it)
# through its XLA route, autodiff of the plain loss
@pytest.mark.parametrize("d,K,multinomial,pallas", [(1152, 1, False, True), (384, 20, True, True),
                                                    (3000, 1, False, False)])
def test_fused_loss_grad_plain_matches_jax_on_tile_shapes(d, K, multinomial, pallas):
    n = 320
    X, y, m, A, b = _problem(d + K, n, d, K, multinomial)
    if pallas:
        mesh = make_mesh(1)
        put = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp")))  # noqa: E731
        f = j_fused(put(X), put(y), put(m), mesh, K, multinomial, interpret=True)
    else:
        Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(m)

        def f(Aj, bj):  # logreg_kernels.logreg_fit's loss where the gate refuses Pallas
            z = (Xj @ Aj.T + bj[None, :])[:, 0]
            return ((jax.nn.softplus(z) - yj * z) * mj).sum()

    loss_j, (gA_j, gb_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))

    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(*t, multinomial)
    # the tolerances of test_fused_loss_grad_plain_matches_pallas_interpret
    assert abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)) < 1e-5
    assert np.abs(gA_t.numpy() - np.asarray(gA_j)).max() / np.abs(np.asarray(gA_j)).max() < 1e-4
    assert np.abs(gb_t.numpy() - np.asarray(gb_j)).max() < 1e-3


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 5), (True, 10)])
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


@pytest.mark.parametrize("d", [124, 252, 256])
@pytest.mark.parametrize("K", [2, 5, 10, 16])
def test_k3_routing_table(K, d, monkeypatch):
    # binomial K = 1: the row-per-warp kernel with NV float4 chunks a lane
    assert tlk._k3_variant(256, 1, False) == 21
    assert tlk._k3_variant(1024, 1, False) == 81
    # multinomial 2 <= K <= 16, d <= 256, d % 4 == 0: the register-row
    # multinomial kernel for K classes, 100·NV + K
    assert tlk._k3_variant(d, K, True) == 100 * (1 if d <= 128 else 2) + K
    # past those, under the tile kernel's cap: 2000 + IPT (multinomial),
    # 1000 + IPT (binomial), IPT the gradient items a thread
    tile = 2000 + tlk._tile_geometry(1, d, K, True).ipt
    assert tlk._k3_variant(d, K, True, aligned=False) == tile
    assert tlk._k3_variant(d - 2, K, True) == 2000 + tlk._tile_geometry(1, d - 2, K, True).ipt
    assert tlk._k3_variant(256, 17, True) == 2002  # 5 groups x 65 chunks
    assert tlk._k3_variant(260, K, True) == 2000 + tlk._tile_geometry(1, 260, K, True).ipt
    assert tlk._k3_variant(300, K, True) == 2000 + tlk._tile_geometry(1, 300, K, True).ipt
    assert tlk._k3_variant(512, 10, True) == 2002
    assert tlk._k3_variant(256, 32, True) == 2004
    assert tlk._k3_variant(3000, 1, False) == 1004  # 751 chunks
    assert tlk._k3_variant(3001, 1, False) == 1004
    assert tlk._k3_variant(d, 1, False, aligned=False) == 1001
    assert tlk._k3_variant(16380, 1, False) == 1016
    assert tlk._k3_variant(4, 300, True) == 2001  # more classes than a block has threads
    # past the cap: the general kernel
    assert tlk._k3_variant(1024, 64, True) == 0  # 16 groups x 257 chunks
    assert tlk._k3_variant(d, 130, True) == 0
    assert tlk._k3_variant(3000, K, True) == 0
    assert tlk._k3_variant(16384, 1, False) == 0
    assert tlk._k3_variant(4092, 4, True) == 0  # its items fit, a ring of 8 rows does not
    # a CPU tensor takes the plain version and never consults the table
    def no_table(*a, **k):
        raise AssertionError("the routing table was consulted for a CPU tensor")

    monkeypatch.setattr(tlk, "_k3_variant", no_table)
    t = [torch.from_numpy(v) for v in _problem(K, 40, d, K, True)]
    for a, r in zip(tlk.logreg_loss_grad(*t, True), tlk.logreg_loss_grad_plain(*t, True)):
        assert torch.equal(a, r)


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


@pytest.mark.parametrize("multinomial,K", [(False, 1), (True, 1), (True, 2), (True, 10), (True, 32), (True, 64)])
def test_tile_geometry_fits_at_every_d(multinomial, K):
    """The tile kernel's launch at every d up to past its cap: where it
    takes the shape, a two-slot ring whose block fits an H100's shared
    memory (232,448 B for one block an SM, 115,680 B each for two), the
    most rows a tile that fit (binomial, two blocks an SM wherever they
    fit) or the best-balanced (multinomial, one block), each thread IPT
    items at most; where it refuses, the items or the smallest ring do not
    fit."""
    src = (Path(tlk.__file__).parent.parent / "csrc" / "logreg_loss_grad.cu").read_text()
    assert tlk._TILE_STAGES == 2 and "constexpr int TILE_STAGES = 2;" in src
    seen = 0
    for d in range(1, 16_450):
        geo = tlk._tile_geometry(10_000, d, K, multinomial)
        kp = -(-K // 4) * 4 if multinomial else 1
        items = (kp // (4 if multinomial else 1)) * (-(-d // 4) + 1)
        smem = {bm: tlk._tile_smem(d, K, multinomial, bm) for bm in tlk._TILE_BM[multinomial]}
        if geo is None:
            assert items > 256 * max(tlk._TILE_IPT[multinomial]) or min(smem.values()) > 232_448
            continue
        seen += 1
        budget = 115_680 if geo.blocks_per_sm == 2 else 232_448
        assert geo.smem == smem[geo.BM] <= budget and geo.BM >= 1
        assert geo.items == items <= 256 * geo.ipt and (geo.ipt == 1 or items > 128 * geo.ipt)
        fit = [bm for bm, b in smem.items() if b <= budget]
        if multinomial:
            assert geo.blocks_per_sm == 1
            assert tlk._tile_rows_score(geo.BM, K, True) == max(tlk._tile_rows_score(b, K, True) for b in fit)
        else:
            assert geo.blocks_per_sm == (2 if min(smem.values()) <= 115_680 else 1) and geo.BM == max(fit)
        assert geo.grid == min(-(-10_000 // geo.BM), 132 * geo.blocks_per_sm)
    assert seen > 0


def _halve_model(lanes_vals):
    """The CUDA ``halve<H>`` steps H = 16 ... 1 on (32 lanes, 32 values):
    lane L keeps the half of its values whose bit H matches its own and
    adds its partner's (L ^ H) copy of that half."""
    s = [list(v) for v in lanes_vals]
    for H in (16, 8, 4, 2, 1):
        new = []
        for L in range(32):
            up = bool(L & H)
            keep = s[L][H:2 * H] if up else s[L][:H]
            send = s[L ^ H][H:2 * H] if up else s[L ^ H][:H]  # the partner's copy of that half
            new.append([a + b for a, b in zip(keep, send)])
        s = new
    return [v[0] for v in s]


@pytest.mark.parametrize("n,d,K,multinomial,vec", [
    (200_003, 3000, 1, False, True), (1_037, 3001, 1, False, False), (97, 512, 10, True, True),
    (5, 257, 20, True, False), (2_000, 256, 32, True, True), (11, 16380, 1, False, True),
    (300, 124, 1, False, False), (20_011, 4, 300, True, True),
])
def test_tile_kernel_work_split_covers_everything_once(n, d, K, multinomial, vec):
    """A numpy model of ``logreg_tile_kernel``'s work split at the launch
    :func:`_tile_geometry` gives: each row in exactly one tile of one
    block; each (row, column) of a tile in exactly one copy of the copy
    walk; each (row, chunk) of the logits in exactly one warp's share
    (binomial) or each (8-row block, 4-class chunk) in one warp's pair,
    whose recursive-halving warp sum leaves lane L with value L
    (multinomial); each (class, column) of the block partial, the
    intercept column included, in exactly one item of one thread; and
    each element of the second pass in one lane."""
    geo = tlk._tile_geometry(n, d, K, multinomial)
    T, W8, BM = 256, 8, geo.BM
    dp = -(-d // 4) * 4
    nc = dp // 4
    # rows: tiles b, b + grid, ... of BM rows
    rows = np.zeros(n, np.int64)
    tiles = -(-n // BM)
    for blk in range(geo.grid):
        for t in range(blk, tiles, geo.grid):
            rows[t * BM:min(n, t * BM + BM)] += 1
    assert (rows == 1).all()
    # the copy walk: (r, c) advanced by (THREADS // W, THREADS % W)
    w = nc if vec else dp
    cover = np.zeros((BM, w), np.int64)
    for tid in range(T):
        r, c = tid // w, tid % w
        while r < BM:
            cover[r, c] += 1
            r, c = r + T // w, c + T % w
            if c >= w:
                c, r = c - w, r + 1
    assert (cover == 1).all()
    # logits
    if multinomial:
        kp = -(-K // 4) * 4
        pairs = np.zeros((BM // 8, kp // 4), np.int64)
        for warp in range(W8):
            for p in range(warp, (BM // 8) * (kp // 4), W8):
                pairs[p // (kp // 4), p % (kp // 4)] += 1
        assert (pairs == 1).all()
        vals = [[1000 * L + i for i in range(32)] for L in range(32)]
        assert _halve_model(vals) == [sum(1000 * L2 + L for L2 in range(32)) for L in range(32)]
    else:
        wpr = 1 if BM >= W8 else W8 // BM
        share = np.zeros((BM, nc), np.int64)
        for warp in range(W8):
            for rw in range(warp, BM * wpr, W8):
                r, h = rw % BM, rw // BM
                for lane in range(32):
                    share[r, lane + 32 * h::32 * wpr] += 1
        assert (share == 1).all()
    # the gradient items: (class group, chunk) = divmod(tid + 256 i, nc + 1)
    kg = 4 if multinomial else 1
    grad = np.zeros((K, d + 1), np.int64)
    for tid in range(T):
        for i in range(geo.ipt):
            e = tid + T * i
            if e >= geo.items:
                continue
            g, j = divmod(e, nc + 1)
            for k in range(g * kg, g * kg + kg):
                if k >= K:
                    continue
                if j < nc:
                    for col in range(4 * j, min(4 * j + 4, d)):
                        grad[k, col] += 1
                else:
                    grad[k, d] += 1
    assert (grad == 1).all()
    # the second pass: 32 elements a block, a lane each
    per = K * (d + 1)
    elems = np.zeros(per + 1, np.int64)
    for blk in range(-(-(per + 1) // 32)):
        for lane in range(32):
            if blk * 32 + lane <= per:
                elems[blk * 32 + lane] += 1
    assert (elems == 1).all()


@pytest.mark.parametrize("d,n_classes", [(1152, 2), (384, 20)])
def test_logreg_fit_matches_jax_on_tile_shapes(d, n_classes):
    """LogisticRegression fitted by the port (on the CPU: K3's plain
    version) and by the JAX package at widths the card sends to the tile
    kernel: binomial d = 1,152 and 20 classes at d = 384, 1,000 rows. Both
    run to convergence (tol 1e-10, as the reference's benchmark runs with
    1e-30); held within the tolerances of test_torch_slice.py's
    LogisticRegression parity test."""
    rng = np.random.default_rng(d + n_classes)
    X = rng.normal(size=(1000, d)).astype(np.float32)
    W = rng.normal(size=(d, n_classes)) * 0.2
    y = (X @ W + rng.gumbel(size=(1000, n_classes))).argmax(axis=1).astype(np.float32)
    kw = dict(maxIter=200, regParam=0.01, elasticNetParam=0.0, tol=1e-10)
    jdf, tdf = JDataFrame({"features": X, "label": y}), TDataFrame({"features": X, "label": y})
    jm = JLogReg(num_workers=1, **kw).fit(jdf)
    tm = TLogReg(device="cpu", **kw).fit(tdf)
    scale = np.abs(jm.coefficientMatrix).max()
    assert np.abs(tm.coefficientMatrix - jm.coefficientMatrix).max() < 2e-3 * scale
    assert np.abs(tm.interceptVector - jm.interceptVector).max() < 2e-3 * max(scale, 1.0)
    ot, oj = tm.transform(tdf), jm.transform(jdf)
    assert (np.asarray(ot.column("prediction")) == np.asarray(oj.column("prediction"))).mean() > 0.995
    assert np.abs(np.asarray(ot.column("probability")) - np.asarray(oj.column("probability"))).max() < 5e-3

