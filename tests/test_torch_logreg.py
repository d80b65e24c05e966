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
    # past the cap, multinomial 2 <= K <= 256: the route (two 3xTF32
    # products), 3000 + the wgmma N that holds K classes, 3256 past 128
    assert tlk._k3_variant(1024, 64, True) == 3064  # 16 groups x 257 chunks
    assert tlk._k3_variant(256, 64, True) == 3064  # 16 groups x 65 chunks
    assert tlk._k3_variant(d, 130, True) == 3256
    assert tlk._k3_variant(3000, K, True) == 3016 + 16 * (K > 16)
    assert tlk._k3_variant(4092, 4, True) == 3016  # its items fit, a ring of 8 rows does not
    assert tlk._k3_variant(2048, 120, True) == 3128
    assert tlk._k3_variant(5000, 2, True) == 3016
    assert tlk._k3_variant(d, 256, True, aligned=False) == 3256
    assert tlk._k3_variant(1024, 33, True) == 3064 and tlk._k3_variant(1024, 32, True) == 3032
    # past 256 classes, up to 12,288: the route's class-tiled instance
    # (tiles of 128 classes, an online softmax across them)
    assert tlk._k3_variant(d, 257, True) == 3900
    assert tlk._k3_variant(2048, 1000, True) == 3900
    assert tlk._k3_variant(d, 12_288, True, aligned=False) == 3900
    assert tlk._route_code(12_289) is None and tlk._route_geometry(1, d, 12_289) is None
    # binomial rows past the tile kernel's cap take the cluster kernel,
    # 5016 (16 chunks a thread); past its widest d, 262,144, the general
    # kernel
    assert tlk._k3_variant(16384, 1, False) == 5016
    assert tlk._k3_variant(20000, 1, False) == 5016
    assert tlk._k3_variant(262_145, 1, False) == 0
    # a CPU tensor takes the plain version and never consults the table
    def no_table(*a, **k):
        raise AssertionError("the routing table was consulted for a CPU tensor")

    monkeypatch.setattr(tlk, "_k3_variant", no_table)
    t = [torch.from_numpy(v) for v in _problem(K, 40, d, K, True)]
    for a, r in zip(tlk.logreg_loss_grad(*t, True), tlk.logreg_loss_grad_plain(*t, True)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("d", [4, 61, 124, 256, 2048, 5000])
def test_k3_routing_takes_every_multinomial_K_past_256(d):
    """Every multinomial K the general kernel took before the class-tiled
    instance (257 to 12,288, where its RT x K logit tile fits) goes to
    that instance, or to the tile kernel where its block gradient fits
    (small d), at any alignment; past 12,288 nothing takes it, and the
    wrapper raises."""
    for K in range(257, 12_289):
        for aligned in (True, False):
            v = tlk._k3_variant(d, K, True, aligned)
            assert v == 3900 or (2000 < v < 3000 and tlk._tile_geometry(1, d, K, True) is not None)
    assert tlk._k3_variant(d, 12_289, True) == 0 and tlk._route_code(12_289) is None
    # the wrapper raises before it picks a kernel (tensors with no data)
    meta = [torch.empty(s, device="meta") for s in ((4, d), (4,), (4,), (12_289, d), (12_289,))]
    with pytest.raises(ValueError, match="12,288"):
        tlk.logreg_loss_grad(*meta, True)


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


# shapes past the tile kernel's cap that the card sends to the route, both
# inside the JAX package's Pallas gate (d % 128 == 0, K <= 120): its
# Pallas kernel in interpret mode is the oracle
@pytest.mark.parametrize("d,K", [(256, 64), (384, 100)])
def test_fused_loss_grad_plain_matches_pallas_on_route_shapes(d, K):
    n = 192
    X, y, m, A, b = _problem(d + K, n, d, K, True)
    assert tlk._k3_variant(d, K, True) >= 3000
    mesh = make_mesh(1)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P("dp")))  # noqa: E731
    f = j_fused(put(X), put(y), put(m), mesh, K, True, interpret=True)
    loss_j, (gA_j, gb_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))

    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(*t, True)
    # the tolerances of test_fused_loss_grad_plain_matches_pallas_interpret
    assert abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)) < 1e-5
    assert np.abs(gA_t.numpy() - np.asarray(gA_j)).max() / np.abs(np.asarray(gA_j)).max() < 1e-4
    assert np.abs(gb_t.numpy() - np.asarray(gb_j)).max() < 1e-3


@pytest.mark.parametrize("d,K", [(256, 300), (130, 257)])
def test_fused_loss_grad_plain_matches_jax_xla_past_pallas_gate(d, K, monkeypatch):
    """Past 256 classes (the class-tiled instance on the card) the JAX
    package runs outside its Pallas gate (K <= 120), so its oracle is the
    XLA logits path of its ``logreg_fit`` (``spark_rapids_ml_tpu/ops/
    logreg_kernels.py``: logits, ``logsumexp`` less the label's logit, the
    masked sum), differentiated by JAX; held within the tolerances of
    test_fused_loss_grad_plain_matches_pallas_interpret."""
    from spark_rapids_ml_tpu.ops import logreg_pallas as jp

    monkeypatch.setattr(jp, "FORCE_INTERPRET", True)
    assert not jp.logreg_pallas_ok(d, K, jnp.float32)
    assert tlk._k3_variant(d, K, True) == 3900
    n = 320
    X, y, m, A, b = _problem(d + K, n, d, K, True)
    Xj, yi, mj = jnp.asarray(X), jnp.asarray(y).astype(jnp.int32), jnp.asarray(m)

    def data_loss(Aeff, beff):
        logits = Xj @ Aeff.T + beff[None, :]
        ll = jax.nn.logsumexp(logits, axis=1) - jnp.take_along_axis(logits, yi[:, None], axis=1)[:, 0]
        return (ll * mj).sum()

    loss_j, (gA_j, gb_j) = jax.value_and_grad(data_loss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(*t, True)
    assert abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)) < 1e-5
    assert np.abs(gA_t.numpy() - np.asarray(gA_j)).max() / np.abs(np.asarray(gA_j)).max() < 1e-4
    assert np.abs(gb_t.numpy() - np.asarray(gb_j)).max() < 1e-3


_COL_OF = "return 32 * (w >> 1) + 4 * (4 * (g >> 2) + 2 * (w & 1) + h) + (g & 3);"


def _col_of(w, h, g):
    """The route's gradient kernel's column, inside a warpgroup's
    64-column slab, of accumulator row 16 w + 8 h + g: the source's
    ``col_of`` (its body is ``_COL_OF``)."""
    return 32 * (w >> 1) + 4 * (4 * (g >> 2) + 2 * (w & 1) + h) + (g & 3)


def _route_block_tiles(n_tiles, grid):
    """Tiles of each block of a persistent grid: b, b + grid, ..."""
    return [list(range(b, n_tiles, grid)) for b in range(grid)]


# the class-tiled instance (K > 256): K = 257 (a second class tile of one
# class), 300, 1,000 and 4,097 (33 tiles, the last of one class), ragged
# last chunks under a small R^T scratch
_CT = 8 * 128 * 128  # R^T's hi and lo for 128 rows of one class tile


@pytest.mark.parametrize("n,d,K,sms,scratch", [
    (1_000, 300, 2, 132, 512 << 20), (777, 1023, 17, 5, 512 << 20), (97, 64, 64, 3, 512 << 20),
    (1_111, 200, 128, 7, 512 << 20), (2_003, 129, 130, 4, 512 << 20), (600, 70, 256, 132, 256 * 2048),
    (700, 250, 33, 2, 64 * 1024),
    (700, 300, 257, 132, 3 * 2 * _CT), (1_000, 130, 300, 7, 3 * 3 * _CT), (500, 40, 1000, 5, 8 * _CT),
    (300, 20, 4097, 132, 512 << 20), (300, 20, 4097, 3, 33 * _CT),
])
def test_route_work_split_covers_everything_once(n, d, K, sms, scratch, monkeypatch):
    """A numpy model of the route's work split at the launch
    :func:`_route_geometry` and :func:`_route_chunks` give, for each N
    instance and the class-tiled one, ragged n and d, chunked rows and
    grids smaller than the tiles: the chunks cover the rows once; the
    logits kernel's persistent blocks take each row of a chunk in exactly
    one tile of ``block_m`` rows, each warpgroup its 64 rows (or, split,
    its 128 classes; class-tiled: each class tile of the row tile in
    turn, so every (row, class) once); the gradient kernel's (column tile,
    class tile, row range) tiles, walked by grid_b blocks in stages of 32
    rows (whole stages inside a range), cover every (class, column, row)
    exactly once, columns through ``col_of``'s permutation, so every
    (column, class) item once in each row range; the intercept and loss
    partials are one a logits block, the gradient partials one a range."""
    monkeypatch.setattr(tlk, "_ROUTE_SCRATCH", scratch)  # R^T's cap, so that small n makes chunks
    geo = tlk._route_geometry(n, d, K, sms)
    code = geo.code
    tiled = code == 3900
    bn = 128 if code in (3256, 3900) else code - 3000
    assert tiled == (K > 256) and geo.class_tiles == (-(-K // 128) if tiled else 1)
    assert geo.npt * geo.class_tiles >= K > geo.npt * (geo.class_tiles - 1)
    assert geo.npt == bn or (code == 3256 and geo.npt == 2 * bn)
    assert geo.smem == tlk._route_smem(code, geo.stages) <= 232_448
    chunks = tlk._route_chunks(n, geo, sms)
    assert len(chunks) > 1 or scratch == 512 << 20
    cover = np.zeros((K, d, n), np.uint8)
    rows_seen = np.zeros(n, np.int64)
    logit_seen = np.zeros((n, K), np.uint8)
    r_next = 0
    for r0, rows, grid_a, ranges, range_rows, grid_b in chunks:
        assert r0 == r_next and rows <= geo.chunk_rows and geo.chunk_rows % 128 == 0 or len(chunks) == 1
        r_next = r0 + rows
        # logits kernel: tiles of block_m rows on grid_a blocks
        tiles_a = -(-rows // geo.block_m)
        assert 1 <= grid_a <= min(tiles_a, sms)
        for blk in _route_block_tiles(tiles_a, grid_a):
            for t in blk:
                for wg in range(2):
                    if code == 3256:  # both warpgroups take the tile's 64 rows
                        lo, hi = t * 64, min(rows, t * 64 + 64)
                    else:
                        lo, hi = t * 128 + 64 * wg, min(rows, t * 128 + 64 * wg + 64)
                    rows_seen[r0 + lo:r0 + max(lo, hi)] += 1
                    for c in range(geo.class_tiles):  # then the classes of each class tile
                        c0 = c * geo.npt + (wg * bn if code == 3256 else 0)
                        logit_seen[r0 + lo:r0 + max(lo, hi), c0:min(K, c0 + bn)] += 1
        # gradient kernel
        assert range_rows % 32 == 0 and ranges * range_rows >= rows > (ranges - 1) * range_rows
        tiles_b = geo.col_tiles * geo.class_tiles * ranges
        assert 1 <= grid_b <= min(tiles_b, sms) and geo.col_tiles * geo.block_m >= d
        for blk in _route_block_tiles(tiles_b, grid_b):
            for t in blk:
                ct, cc = t % geo.col_tiles, t // geo.col_tiles % geo.class_tiles
                rr = t // (geo.col_tiles * geo.class_tiles)
                k0 = rr * range_rows
                stages = -(-min(range_rows, rows - k0) // 32)
                assert stages >= 1 and (rr == ranges - 1 or stages * 32 == range_rows)
                seen = np.zeros(0, np.int64)
                for s in range(stages):
                    seen = np.concatenate([seen, np.arange(k0 + 32 * s, min(k0 + 32 * s + 32, rows))])
                for wg in range(2):
                    slab = 0 if code == 3256 else 64 * wg
                    cls = np.arange(bn) + (wg * bn if code == 3256 else 0) + cc * geo.npt
                    cls = cls[cls < K]
                    cols = np.array([ct * geo.block_m + slab + _col_of(w, h, g)
                                     for w in range(4) for h in range(2) for g in range(8)])
                    cols = cols[cols < d]
                    cover[np.ix_(cls, cols, r0 + seen)] += 1
    assert r_next == n
    if code != 3256:
        assert (rows_seen == 1).all()
    else:
        assert (rows_seen == 2).all()  # the two warpgroups' halves of the classes
    assert (logit_seen == 1).all()
    assert (cover == 1).all()
    assert sorted(_col_of(w, h, g) for w in range(4) for h in range(2) for g in range(8)) \
        == list(range(64))
    src = (Path(tlk.__file__).parent.parent / "csrc" / "logreg_loss_grad.cu").read_text()
    assert _COL_OF in src


@pytest.mark.parametrize("grad", [False, True])
def test_route_fragment_loads_hit_32_banks(grad):
    """The A-fragment loads of both route kernels from the 128-byte
    swizzled X tile (the source's ``foff``): for every warp, register and
    k-step, the 32 lanes read 32 distinct banks, and the offsets address
    the element the fragment names (row/column, reduction index)."""
    for wg in range(2):
        for w in range(4):
            for kk in range(4):
                for c in range(4):
                    banks, elems = set(), set()
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        kf = kk * 8 + t + 4 * (c >> 1)
                        if grad:
                            colb = 64 * wg + _col_of(w, c & 1, g)
                            off = (colb >> 5) * 4096 + kf * 128 + ((((colb & 31) >> 2) ^ (kf & 7)) << 4) \
                                + 4 * (colb & 3)
                            # the TMA box (32 columns x 32 rows) of column colb, row kf
                            box, rr, cc = colb // 32, kf, colb % 32
                        else:
                            mr = 64 * wg + 16 * w + g + 8 * (c & 1)
                            off = mr * 128 + 4 * (kf & 3) + (((2 * kk + (c >> 1)) ^ g) << 4)
                            box, rr, cc = 0, mr, kf
                        # the 128-byte swizzle: chunk cc // 4 of row rr at chunk (cc // 4) ^ (rr % 8)
                        assert off == box * 4096 + rr * 128 + (((cc // 4) ^ (rr % 8)) << 4) + 4 * (cc % 4)
                        banks.add((off // 4) % 32)
                        elems.add(off)
                    assert len(banks) == 32 and len(elems) == 32


def _route_model(X, y, m, A, b, bn, mask_padded=True):
    """A torch model of the route's arithmetic on the CPU: both products
    in 3xTF32 (``tf32_split`` of each operand, lo*hi' + hi*lo' + hi*hi'
    into a fresh f32 accumulator for each 32-deep stage, folded into the
    running sum with a rounded add), the logits' epilogue over ``bn``
    classes (the wgmma N) with the padded ones masked out of the max and
    the sum (or, ``mask_padded=False``, taken in with logit 0), R's TF32 hi
    and lo as the gradient's B operand, and the gradient over stages of 32
    rows. Returns (loss, gA, gb)."""
    from spark_rapids_ml_tpu_torch.ops.knn_kernels import tf32_split

    n, d = X.shape
    K = A.shape[0]
    Ap = torch.zeros((bn, d))
    Ap[:K] = A

    def product(P, Q):  # P (M, depth) @ Q (N, depth)^T, 32-deep stages
        run = torch.zeros((P.shape[0], Q.shape[0]))
        for k0 in range(0, P.shape[1], 32):
            ph, pl = tf32_split(P[:, k0:k0 + 32])
            qh, ql = tf32_split(Q[:, k0:k0 + 32])
            run = run + (pl @ qh.T + ph @ ql.T + ph @ qh.T)
        return run

    bp = torch.zeros(bn)
    bp[:K] = b
    z = product(X, Ap) + bp[None, :]
    live = torch.arange(bn) < K
    if mask_padded:
        z = torch.where(live[None, :], z, torch.tensor(-float("inf")))
    mx = z.max(dim=1).values
    ex = torch.exp(z - mx[:, None])
    se = ex.sum(dim=1)
    lse = torch.log(se) + mx
    onehot = torch.nn.functional.one_hot(y.long(), bn).float()
    loss = ((lse - (z * onehot).sum(dim=1)) * m).sum()
    R = (ex / se[:, None] - onehot) * m[:, None] * live[None, :]
    rh, rl = tf32_split(R)
    Rs = rh + rl  # the B operand's hi and lo: (hi + lo) is R to 2^-22
    gA = product(X.T.contiguous(), Rs.T.contiguous()).T[:K]
    return loss, gA, R.sum(dim=0)[:K]


@pytest.mark.parametrize("n,d,K", [(700, 300, 20), (257, 130, 130), (500, 64, 37)])
def test_route_arithmetic_model_within_band(n, d, K):
    """The route's arithmetic (:func:`_route_model`) is held by
    ``chip_smoke.py``'s f64 band (``logreg_reference`` and ``held``, the
    check the card's route passes), and the same arithmetic without the
    padded-class mask is refused by it."""
    import chip_smoke

    code = tlk._route_code(K)
    bn = 256 if code == 3256 else code - 3000
    assert bn > K  # padded classes live
    rng = np.random.default_rng(n + d + K)
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) + 1.0)
    y = torch.from_numpy(rng.integers(0, K, size=n).astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    A = torch.from_numpy((rng.normal(size=(K, d)) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=K) * 0.1).astype(np.float32))
    lr, gAr, gbr, T_gA, T_gb, T_loss = chip_smoke.logreg_reference(torch, tlk, X, y, m, A, b, True)
    loss, gA, gb = _route_model(X, y, m, A, b, bn)
    for out, ref, T in ((gA, gAr, T_gA), (gb, gbr, T_gb), (loss, lr, T_loss)):
        assert chip_smoke.held(torch, out, ref, T, n)[1] <= 1.0
    loss_u, gA_u, _ = _route_model(X, y, m, A, b, bn, mask_padded=False)
    assert chip_smoke.held(torch, gA_u, gAr, T_gA, n)[1] > 1.0


def _tiled_lse(z, K, rescale=True):
    """The class-tiled instance's running (max, sum) of each row of the
    logits ``z`` (n, K), in the kernel's order and ``z``'s dtype: tiles of
    128 classes; in a tile the row's max over its live classes, the new
    running max M' = max(M, tile max), each of the quad's four lanes t
    summing exp(z - M') over its classes 8 j + 2 t + p in (j, p) order, the
    quad's sums combined by the xor-1 then the xor-2 shuffle, and S' = S
    exp(M - M') + that sum (``rescale=False``: S + that sum, the negative
    control). Returns (M, S)."""
    n = z.shape[0]
    M = torch.full((n,), -float("inf"), dtype=z.dtype)
    S = torch.zeros((n,), dtype=z.dtype)
    for c0 in range(0, K, 128):
        zt = torch.full((n, 128), -float("inf"), dtype=z.dtype)
        zt[:, :min(128, K - c0)] = z[:, c0:c0 + 128]
        Mn = torch.maximum(M, zt.max(dim=1).values)
        ex = torch.exp(zt - Mn[:, None]).reshape(n, 16, 4, 2)  # [j][t][p]: class 8 j + 2 t + p
        lane = torch.zeros((n, 4), dtype=z.dtype)
        for j in range(16):
            for p in range(2):
                lane = lane + ex[:, j, :, p]
        tsum = (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])
        S = (S * torch.exp(M - Mn) if rescale else S) + tsum
        M = Mn
    return M, S


@pytest.mark.parametrize("K", [257, 300, 1000, 4097])
def test_route_tiled_online_softmax_model(K):
    """The class-tiled instance's merge of the class tiles' (max, sum)
    (:func:`_tiled_lse`, in f64) gives torch.logsumexp of each row to
    1e-12 relative on logits spread over +-80, whose max moves between
    tiles, and, read back against each row's stored logits as the kernel
    reads them, the plain version's residuals R = (softmax - onehot) m and
    so its gradient; without the rescale it does not."""
    n, d = 64, 8
    rng = np.random.default_rng(K)
    z = torch.from_numpy(rng.uniform(-80.0, 80.0, size=(n, K)))
    z[:, -1] = torch.from_numpy(rng.uniform(60.0, 80.0, size=n))  # the max in the last tile
    M, S = _tiled_lse(z, K)
    lse = torch.logsumexp(z, dim=1)
    assert ((torch.log(S) + M - lse).abs() <= 1e-12 * lse.abs()).all()
    y = torch.from_numpy(rng.integers(0, K, size=n).astype(np.float64))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float64))
    onehot = torch.nn.functional.one_hot(y.long(), K).double()
    R = (torch.exp(z - M[:, None]) / S[:, None] - onehot) * m[:, None]
    R_plain = (torch.softmax(z, dim=1) - onehot) * m[:, None]
    assert (R - R_plain).abs().max() <= 1e-12
    # and so the gradient R^T X over any rows X
    X = torch.from_numpy(rng.normal(size=(n, d)))
    assert (R.T @ X - R_plain.T @ X).abs().max() <= 1e-12 * (R_plain.abs().T @ X.abs()).max()
    M_u, S_u = _tiled_lse(z, K, rescale=False)
    assert ((torch.log(S_u) + M_u - lse).abs() > 1e-3).any()


def _route_tiled_model(X, y, m, A, b, rescale=True):
    """A torch model of the class-tiled instance's f32 arithmetic on the
    CPU: each class tile's logits by the route's 3xTF32 products in
    32-deep stages (:func:`_route_model`'s), + b, merged by
    :func:`_tiled_lse` in f32; R from the stored logits, its TF32 hi and
    lo the gradient's B operand, the gradient over stages of 32 rows.
    Returns (loss, gA, gb)."""
    from spark_rapids_ml_tpu_torch.ops.knn_kernels import tf32_split

    K = A.shape[0]

    def product(P, Q):  # P (M, depth) @ Q (N, depth)^T, 32-deep stages
        run = torch.zeros((P.shape[0], Q.shape[0]))
        for k0 in range(0, P.shape[1], 32):
            ph, pl = tf32_split(P[:, k0:k0 + 32])
            qh, ql = tf32_split(Q[:, k0:k0 + 32])
            run = run + (pl @ qh.T + ph @ ql.T + ph @ qh.T)
        return run

    z = torch.cat([product(X, A[c0:c0 + 128]) for c0 in range(0, K, 128)], dim=1) + b[None, :]
    M, S = _tiled_lse(z, K, rescale)
    onehot = torch.nn.functional.one_hot(y.long(), K).float()
    loss = ((torch.log(S) + M - (z * onehot).sum(dim=1)) * m).sum()
    R = (torch.exp(z - M[:, None]) * (1.0 / S)[:, None] - onehot) * m[:, None]
    rh, rl = tf32_split(R)
    gA = torch.cat([product(X.T.contiguous(), (rh + rl)[:, c0:c0 + 128].T.contiguous()).T
                    for c0 in range(0, K, 128)], dim=0)
    return loss, gA, R.sum(dim=0)


@pytest.mark.parametrize("n,d,K", [(300, 130, 257), (200, 64, 300)])
def test_route_tiled_arithmetic_model_within_band(n, d, K):
    """The class-tiled instance's arithmetic (:func:`_route_tiled_model`)
    is held by ``chip_smoke.py``'s f64 band (the check the card's kernel
    passes), and its negative control, the class tiles merged without
    rescaling the sum, is refused by it."""
    import chip_smoke

    assert tlk._route_code(K) == 3900
    rng = np.random.default_rng(n + d + K)
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) + 1.0)
    y = torch.from_numpy(rng.integers(0, K, size=n).astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    A = torch.from_numpy((rng.normal(size=(K, d)) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=K) * 0.1).astype(np.float32))
    lr, gAr, gbr, T_gA, T_gb, T_loss = chip_smoke.logreg_reference(torch, tlk, X, y, m, A, b, True)
    loss, gA, gb = _route_tiled_model(X, y, m, A, b)
    for out, ref, T in ((gA, gAr, T_gA), (gb, gbr, T_gb), (loss, lr, T_loss)):
        assert chip_smoke.held(torch, out, ref, T, n)[1] <= 1.0
    _, gA_u, _ = _route_tiled_model(X, y, m, A, b, rescale=False)
    assert chip_smoke.held(torch, gA_u, gAr, T_gA, n)[1] > 1.0


def test_logreg_fit_matches_jax_on_route_shape():
    """LogisticRegression with 64 classes at d = 256 (past the tile
    kernel's cap: the route on the card) fitted by the port (on the CPU:
    K3's plain version) and by the JAX package, 3,000 rows, both until the
    f32 objective stops improving; held within
    test_logreg_fit_matches_jax_on_tile_shapes's tolerances. regParam 0.05
    and a label map of small weights keep the 16,448-parameter problem well
    conditioned, so that the two solvers' stopping points agree to those
    tolerances."""
    d, n_classes, n = 256, 64, 3000
    assert tlk._k3_variant(d, n_classes, True) == 3064
    rng = np.random.default_rng(d + n_classes)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, n_classes)) * 0.05
    y = (X @ W + rng.gumbel(size=(n, n_classes))).argmax(axis=1).astype(np.float32)
    kw = dict(maxIter=200, regParam=0.05, elasticNetParam=0.0, tol=1e-10)
    jdf, tdf = JDataFrame({"features": X, "label": y}), TDataFrame({"features": X, "label": y})
    jm = JLogReg(num_workers=1, **kw).fit(jdf)
    tm = TLogReg(device="cpu", **kw).fit(tdf)
    scale = np.abs(jm.coefficientMatrix).max()
    assert np.abs(tm.coefficientMatrix - jm.coefficientMatrix).max() < 2e-3 * scale
    assert np.abs(tm.interceptVector - jm.interceptVector).max() < 2e-3 * max(scale, 1.0)
    ot, oj = tm.transform(tdf), jm.transform(jdf)
    assert (np.asarray(ot.column("prediction")) == np.asarray(oj.column("prediction"))).mean() > 0.995
    assert np.abs(np.asarray(ot.column("probability")) - np.asarray(oj.column("probability"))).max() < 5e-3


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



# --- the cluster kernel (binomial 16,380 < d <= 262,144) --------------------

_CLUSTER_SRC = Path(tlk.__file__).parent.parent / "csrc" / "logreg_loss_grad.cu"


@pytest.mark.parametrize("lo,hi", [(1, 16_380), (16_381, 40_000), (40_001, 100_000), (100_001, 180_000),
                                   (180_001, 262_144)])
def test_k3_routing_sends_binomial_rows_past_the_tile_cap_to_the_cluster_kernel(lo, hi):
    """Every binomial d past the tile kernel's cap (16,380) up to the
    cluster kernel's widest, 262,144, aligned or not, goes to the cluster
    kernel's code; every d up to the cap keeps the row-per-warp or tile
    kernel it had."""
    assert tlk._CLUSTER_D_MAX == 262_144
    for d in range(lo, hi + 1):
        for aligned in (True, False):
            v = tlk._k3_variant(d, 1, False, aligned)
            if d <= 16_380:
                tile = tlk._tile_geometry(1, d, 1, False)
                assert v in (11, 21, 41, 81) or v == 1000 + tile.ipt
            else:
                assert v == 5016 and tlk._cluster_geometry(1, d) is not None
    # multinomial shapes never take it
    assert tlk._k3_variant(min(hi, 2048), 2, True) < tlk._CLUSTER


def test_cluster_geometry_at_many_d():
    """The cluster kernel's launch at many d across its range: the least
    cluster size whose slice fits the instance's 256 x 16 chunks; the C
    slices of W chunks cover every column once, the last rank's non-empty;
    the most ring slots, 3 to 8, that fit one CTA an SM, the source's
    shared bytes; the constants shared with the CUDA source."""
    src = _CLUSTER_SRC.read_text()
    assert "constexpr int CL_MAX_STAGES = 8;" in src and tlk._CLUSTER_STAGES == (3, 8)
    assert "constexpr int CL_XSLOTS = 2 * CL_LAG + 2;" in src and "constexpr int CL_LAG = 2;" in src
    assert tlk._CLUSTER_XSLOTS == 6
    assert "constexpr int CL_IPT = 16;" in src and tlk._CLUSTER_IPT == 16
    ds = list(range(16_381, 16_400)) + list(range(20_000, 262_145, 997)) + [32_768, 32_769, 65_536, 65_537,
                                                                           131_072, 131_073, 262_144]
    for d in ds:
        geo = tlk._cluster_geometry(100_000, d)
        chunks = -(-d // 4)
        assert geo.C == next(c for c in tlk._CLUSTER_SIZES if -(-chunks // c) <= 256 * 16)
        assert geo.W == -(-chunks // geo.C) and 2048 <= geo.W <= 4096
        cols = np.zeros(d, np.int64)
        for r in range(geo.C):
            c0, c1 = 4 * geo.W * r, min(d, 4 * geo.W * (r + 1))
            assert c1 > c0  # no empty rank
            cols[c0:c1] += 1
        assert (cols == 1).all()
        assert geo.smem == tlk._cluster_smem(geo.W, geo.stages) <= 232_448
        assert 3 <= geo.stages <= 8
        assert geo.stages == 8 or tlk._cluster_smem(geo.W, geo.stages + 1) > 232_448
        assert geo.clusters == 132 // geo.C
    assert tlk._cluster_geometry(1, 262_145) is None
    # the geometry at every size the probe forces stays inside the card
    # (none where the slice passes 16 chunks a thread), one cluster a row
    for C in tlk._CLUSTER_SIZES:
        geo = tlk._cluster_geometry(5, 65_536, C=C)
        if C < 4:
            assert geo is None
            continue
        assert geo.C == C and geo.smem <= 232_448 and geo.clusters == 5


def _cluster_copy_model(xq, d, c0, ncols, row):
    """The cluster kernel's staging of one row slice off 16-byte
    alignment (the source's ``shift`` and ``cut``): (position in the staged
    row of each float, the bulk copy's (source float, row position,
    floats), the 4-byte copies' floats)."""
    dl = (xq + row * d + c0) & 3
    head = min((4 - dl) & 3, ncols)
    groups = (ncols - head) // 4
    bulk = (row * d + c0 + head, dl + head, 4 * groups)
    singles = list(range(head)) + list(range(head + 4 * groups, ncols))
    return dl, bulk, singles


@pytest.mark.parametrize("d,n,xq", [(16_381, 9, 0), (20_958, 7, 0), (20_958, 7, 1), (30_001, 5, 3),
                                    (65_536, 3, 2), (200_003, 3, 1), (100_000, 4, 0)])
def test_cluster_kernel_work_split_covers_everything_once(d, n, xq):
    """A numpy model of the cluster kernel's work split at its geometry:
    each row in one cluster's walk; each rank's slice of each
    row staged once, the bulk copy 16-byte aligned at both ends (source
    and row position), the rest by 4-byte copies, inside the staged row's
    4 (W + 1) floats, each float at its shift's place, which the readers'
    two 16-byte chunks hold; each chunk of a slice in one thread's items;
    the exchange slots never overwritten before every rank has read
    them."""
    geo = tlk._cluster_geometry(n, d, sms=3 * 16)
    RW, RS = 4 * geo.W, 4 * geo.W + 4
    rows = np.zeros(n, np.int64)
    for cid in range(geo.clusters):
        rows[cid::geo.clusters] += 1
    assert (rows == 1).all()
    vec = d % 4 == 0 and xq % 4 == 0
    for rank in range(geo.C):
        c0 = rank * RW
        ncols = max(0, min(d - c0, RW))
        nw = -(-ncols // 4)
        for row in range(n):
            dl, (src, pos, count), singles = _cluster_copy_model(xq, d, c0, ncols, row)
            if vec:
                assert dl == 0 and not singles
            staged = np.full(RS, -1, np.int64)
            assert (xq + src) % 4 == 0 and pos % 4 == 0 and count % 4 == 0
            staged[pos:pos + count] = np.arange(count) + src - (row * d + c0)
            for c in singles:
                assert staged[dl + c] == -1
                staged[dl + c] = c
            assert sorted(staged[staged >= 0]) == list(range(ncols))
            assert all(staged[dl + c] == c for c in range(ncols)) and dl + ncols <= RS
            # the readers' chunk j: 16-byte chunks j and j + 1 of the row
            assert 4 * (nw - 1) + 4 + (4 if dl else 0) <= RS
        items = np.zeros(nw, np.int64)
        for tid in range(256):
            for i in range(tlk._CLUSTER_IPT):
                if tid + 256 * i < nw:
                    items[tid + 256 * i] += 1
        assert (items == 1).all()
    # the exchange: rank A writes row t's partial into slot t % 6 after it
    # read row t - 1 - lag's (every rank had written it), which rank B
    # wrote after it read row t - 2 - 2 lag: at least row t - 6
    lag = min(2, geo.stages - 2)
    assert tlk._CLUSTER_XSLOTS >= 2 * lag + 2


def _warp_sum(v):
    """The source's ``warp_sum`` (xor butterfly) over the last axis of 32
    lanes, in ``v``'s dtype; every lane ends with the same sum."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ off]
    return v


def _cluster_model(X, y, m, A, b, sms=4, drop_rank=False):
    """A numpy f32 model of the cluster kernel's arithmetic at its
    geometry (``sms`` SMs): each rank's partial logit of a row, a thread's
    chunks into four accumulators by i % 4 (added pairwise), the warp's xor
    butterfly, the 8 warps in order; the C partials added in rank order
    (``drop_rank``: the last left out, the negative control), then b;
    residuals (sigmoid(z) - y) m; each cluster's gradient slice, loss and
    intercept over its rows in order; the second pass's order over the
    cluster partials.
    Returns (loss, gA (1, d), gb (1,))."""
    f32 = np.float32
    n, d = X.shape
    geo = tlk._cluster_geometry(n, d, sms)
    RW, nchunk = 4 * geo.W, 256 * tlk._CLUSTER_IPT
    a = A[0].astype(f32)
    z = np.zeros(n, f32)
    for rank in range(geo.C - (1 if drop_rank else 0)):
        c0 = rank * RW
        xs = np.zeros((n, 4 * nchunk), f32)
        asl = np.zeros(4 * nchunk, f32)
        ncols = max(0, min(d - c0, RW))
        xs[:, :ncols] = X[:, c0:c0 + ncols]
        asl[:ncols] = a[c0:c0 + ncols]
        prod = (xs * asl).reshape(n, tlk._CLUSTER_IPT, 256, 4)  # [row, i, tid, component]
        s4 = np.zeros((n, 4, 256), f32)
        for i in range(tlk._CLUSTER_IPT):
            for q in range(4):
                s4[:, i & 3] = s4[:, i & 3] + prod[:, i, :, q]
        thread = (s4[:, 0] + s4[:, 1]) + (s4[:, 2] + s4[:, 3])
        warps = _warp_sum(thread.reshape(n, 8, 32))[:, :, 0]
        part = np.zeros(n, f32)
        for w in range(8):
            part = part + warps[:, w]
        z = z + part
    z = z + f32(b[0])
    r = ((f32(1) / (f32(1) + np.exp(-z))) - y) * m
    ll = (np.maximum(z, f32(0)) + np.log1p(np.exp(-np.abs(z))) - y * z) * m
    # per cluster: its rows in order
    clusters = min(geo.clusters, n)
    gpart = np.zeros((clusters, d), f32)
    lpart = np.zeros((clusters, 2), f32)
    for cid in range(clusters):
        for row in range(cid, n, clusters):
            gpart[cid] = gpart[cid] + r[row] * X[row]
            lpart[cid] = lpart[cid] + np.array([ll[row], r[row]], f32)
    # the second pass: warp w adds partials w, w + 8, ..., then the warps in order
    def reduce(p):
        acc = np.zeros((8,) + p.shape[1:], f32)
        for k in range(p.shape[0]):
            acc[k % 8] = acc[k % 8] + p[k]
        out = np.zeros(p.shape[1:], f32)
        for w in range(8):
            out = out + acc[w]
        return out
    gA = reduce(gpart)[None, :]
    lb = reduce(lpart)
    return lb[0], gA, lb[1:2]


@pytest.mark.parametrize("n,d,offset", [(203, 16_381, 0.0), (97, 30_001, 1.0), (40, 70_001, 0.5)])
def test_cluster_arithmetic_model_within_band(n, d, offset):
    """The cluster kernel's arithmetic (:func:`_cluster_model`) is held by
    ``chip_smoke.py``'s f64 band (``logreg_reference`` and ``held``, the
    check the card's kernel passes), and its negative control, the last
    rank's partial left out of every logit, is refused by it."""
    import chip_smoke

    rng = np.random.default_rng(n + d)
    X = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    m = (rng.random(n) > 0.1).astype(np.float32)
    A = (rng.normal(size=(1, d)) * 0.02).astype(np.float32)
    b = np.array([0.1], np.float32)
    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    lr, gAr, gbr, T_gA, T_gb, T_loss = chip_smoke.logreg_reference(torch, tlk, *t, False)
    loss, gA, gb = _cluster_model(X, y, m, A, b)
    for out, ref, T in ((gA, gAr, T_gA), (gb, gbr, T_gb), (np.float32(loss), lr, T_loss)):
        assert chip_smoke.held(torch, torch.as_tensor(out), ref, T, n)[1] <= 1.0
    _, gA_d, _ = _cluster_model(X, y, m, A, b, drop_rank=True)
    assert chip_smoke.held(torch, torch.from_numpy(gA_d), gAr, T_gA, n)[1] > 1.0


@pytest.mark.parametrize("d,n", [(16_512, 96), (20_000, 64)])
def test_fused_loss_grad_plain_matches_jax_xla_on_cluster_shapes(d, n):
    """Binomial rows past the tile kernel's cap (the cluster kernel on the
    card) lie past the JAX package's Pallas gate (d <= 2,048), so its oracle
    is the XLA logits path of its ``logreg_fit`` (softplus(z) - y z, the
    masked sum), differentiated by JAX; held within the tolerances of
    test_fused_loss_grad_plain_matches_pallas_interpret."""
    from spark_rapids_ml_tpu.ops import logreg_pallas as jp

    assert not jp.logreg_pallas_ok(d, 1, jnp.float32)
    assert tlk._k3_variant(d, 1, False) >= tlk._CLUSTER
    X, y, m, A, b = _problem(d, n, d, 1, False)
    Xj, yj, mj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(m)

    def data_loss(Aeff, beff):
        z = (Xj @ Aeff.T + beff[None, :])[:, 0]
        return ((jax.nn.softplus(z) - yj * z) * mj).sum()

    loss_j, (gA_j, gb_j) = jax.value_and_grad(data_loss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    t = [torch.from_numpy(v) for v in (X, y, m, A, b)]
    loss_t, gA_t, gb_t = tlk.logreg_loss_grad(*t, False)
    assert abs(float(loss_t) - float(loss_j)) / abs(float(loss_j)) < 1e-5
    assert np.abs(gA_t.numpy() - np.asarray(gA_j)).max() / np.abs(np.asarray(gA_j)).max() < 1e-4
    assert np.abs(gb_t.numpy() - np.asarray(gb_j)).max() < 1e-3


def test_logreg_fit_matches_jax_on_cluster_shape():
    """``logreg_fit`` of the port (on the CPU: K3's plain version) and of
    the JAX package (its XLA logits path) at binomial d = 16,512, past the
    tile kernel's cap (the cluster kernel on the card), 300 rows,
    regParam 0.05 (a well-conditioned optimum that both reach), until the
    f32 objective stops improving; held within
    test_logreg_fit_matches_jax_on_tile_shapes's tolerances."""
    from spark_rapids_ml_tpu.ops.logreg_kernels import logreg_fit as j_fit

    d, n = 16_512, 300
    assert tlk._k3_variant(d, 1, False) >= tlk._CLUSTER
    rng = np.random.default_rng(d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) * 0.05 + rng.logistic(size=n) > 0).astype(np.float32)
    mask = np.ones(n, np.float32)
    kw = dict(n_classes=2, multinomial=False, fit_intercept=True, standardization=True, l1=0.0, l2=0.05,
              use_l1=False, max_iter=200, tol=1e-10)
    rj = j_fit(jnp.asarray(X), jnp.asarray(mask), jnp.asarray(y), **kw)
    rt = tlk.logreg_fit(torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(y), **kw)
    cj, ct = np.asarray(rj["coef_"]), rt["coef_"].numpy()
    scale = np.abs(cj).max()
    assert np.abs(ct - cj).max() < 2e-3 * scale
    assert np.abs(rt["intercept_"].numpy() - np.asarray(rj["intercept_"])).max() < 2e-3 * max(scale, 1.0)
