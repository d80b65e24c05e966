"""Port parity: kernel K10's STEP epilogue, its slot hash and the UMAP epoch
loop past the JAX Pallas kernel's gate (``spark_rapids_ml_tpu_torch.ops.
umap_kernels``), on the CPU.

Inputs are made with a seeded numpy generator. The STEP epilogue's plain
version is held in f64 to 1e-12 against the ROWS plain version, an
``index_add_`` and the step (one f64 sum in another order). The slot hash
is held bit for bit against a numpy ``uint32`` model, and its uniforms by a
KS test. At C = 10 and neg = 20 (outside the JAX gate, C <= 8 and neg <=
16) the port's epoch loop fed JAX's draws is held against the JAX XLA loop
(atol 5e-4, as ``tests/test_torch_umap.py``), and the ROWS plain version
against the JAX Pallas kernel in interpret mode (atol 1e-5, f32 sums in
two orders); a 10-component fit only statistically (trustworthiness above
0.85 in both packages and within 0.03). The kernel's split of a row's
active terms over a warp's lanes and ``chip_smoke.py``'s K10 bands run
here as models: the bands hold the f32 plain version and catch the
controls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest
from sklearn.manifold import trustworthiness

import chip_smoke
from spark_rapids_ml_tpu.data import DataFrame as JDataFrame
from spark_rapids_ml_tpu.ops import umap_kernels as juk
from spark_rapids_ml_tpu.ops import umap_pallas as jup
from spark_rapids_ml_tpu.umap import UMAP as JUMAP
from spark_rapids_ml_tpu_torch import DataFrame as TDataFrame
from spark_rapids_ml_tpu_torch.ops import umap_kernels as tuk
from spark_rapids_ml_tpu_torch.umap import UMAP as TUMAP

A, B = juk.find_ab_params(1.0, 0.1)


def _mixed_rows(n_head, n_tab, K=8, seed=0):
    """CSR rows of an edge list whose heads have 0, 1 or several rows
    (every 7th head no edge, every 5th 2K + 3 edges, the rest 1..K)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, K + 1, size=n_head)
    deg[::5] = 2 * K + 3
    deg[::7] = 0
    heads = np.repeat(np.arange(n_head), deg)
    tails = rng.integers(0, n_tab, size=heads.size)
    w = rng.uniform(0.1, 1.0, size=heads.size).astype(np.float32)
    row_heads, tails_pad, p_pad = juk.build_row_adjacency(heads, tails, w, n_head, K=K, row_bucket=256)
    return rng, row_heads, tails_pad, p_pad


@pytest.mark.parametrize("self_table", [True, False])
@pytest.mark.parametrize("drawn", [True, False])
def test_step_plain_is_rows_plain_index_add_and_step(self_table, drawn):
    n_head, C, neg, scale, alpha = 300, 3, 4, 2.0 if self_table else 1.0, 0.7
    n_tab = n_head if self_table else 450
    rng, row_heads, tails_pad, p_pad = _mixed_rows(n_head, n_tab)
    R, K = tails_pad.shape
    emb = torch.from_numpy(rng.normal(size=(n_head, C)))
    table = emb if self_table else torch.from_numpy(rng.normal(size=(n_tab, C)))
    heads, tails, p = (torch.from_numpy(x) for x in (row_heads, tails_pad, p_pad.astype(np.float64)))
    perm = torch.from_numpy(rng.permutation(n_tab).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, R, size=neg).astype(np.int32))
    u, seed = (None, 9) if drawn else (torch.from_numpy(rng.random((R, K))), None)
    rows = tuk.head_rows(heads, p, n_head, C)
    counts = rows.off.diff()
    assert (counts == 0).any() and (counts == 1).any() and (counts >= 3).any()
    out = torch.empty_like(emb)
    got = tuk.sgd_epoch_step(emb, table, rows, tails, p, perm, offs, A, B, 1.0, scale, alpha, u=u, seed=seed,
                             out=out)
    assert got is out
    uu = tuk.slot_uniforms_plain(9, R, K, torch.float64) if drawn else u
    sums = tuk.sgd_epoch_rows_plain(table, emb[heads.long()], tails, p, perm, offs, uu, A, B, 1.0, scale)
    ref = emb + alpha * torch.zeros_like(emb).index_add_(0, heads.long(), sums)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[counts == 0].numpy(), emb[counts == 0].numpy())  # copied


def test_head_rows_trims_padding_and_checks_order():
    _, row_heads, tails_pad, p_pad = _mixed_rows(100, 100)
    heads, p = torch.from_numpy(row_heads), torch.from_numpy(p_pad)
    rows = tuk.head_rows(heads.long(), p, 100, 2)
    off = rows.off
    assert rows.heads.dtype == torch.int32 and torch.equal(rows.heads, heads)
    assert rows.part is None and rows.arrive is None and rows.rows_per_warp == 0  # the CPU's
    live = int(torch.nonzero(p.sum(1) > 0).max()) + 1
    assert off.dtype == torch.int64 and off.shape == (101,) and int(off[-1]) == live < p.shape[0]
    np.testing.assert_array_equal(off.diff().numpy(), np.bincount(row_heads[:live], minlength=100))
    with pytest.raises(ValueError):
        tuk.head_rows(heads.flip(0), p.flip(0), 100, 2)


def _np_mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x21F0AAAD)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0xD35A2D97)
    return x ^ (x >> np.uint32(15))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**32 - 1])
def test_slot_bits_match_numpy_uint32(seed):
    R, K = 257, 24
    key = _np_mix32(np.array([(seed + 0x9E3779B9) % 2**32], np.uint32))
    ctr = np.arange(R * K, dtype=np.uint32).reshape(R, K)
    ref = _np_mix32(_np_mix32(ctr ^ key) + key)
    got = tuk.slot_bits_plain(seed, R, K)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    u = tuk.slot_uniforms_plain(seed, R, K, torch.float64).numpy()
    np.testing.assert_array_equal(u, (ref >> np.uint32(8)).astype(np.float64) * 2.0**-24)
    np.testing.assert_array_equal(tuk.slot_uniforms_plain(seed, R, K).numpy(), u.astype(np.float32))


def test_slot_uniforms_are_uniform_and_seeds_differ():
    R, K = 1 << 13, 32  # 2^18 draws
    u = tuk.slot_uniforms_plain(1234, R, K, torch.float64).numpy()
    assert kstest(u.ravel(), "uniform").pvalue > 1e-3
    assert u.min() >= 0.0 and u.max() < 1.0
    # neighbouring slots and rows, and consecutive epochs' seeds, uncorrelated
    v = tuk.slot_uniforms_plain(1235, R, K, torch.float64).numpy()
    for x, y in ((u[:, :-1], u[:, 1:]), (u[:-1], u[1:]), (u, v)):
        assert abs(np.corrcoef(x.ravel(), y.ravel())[0, 1]) < 0.01
    masks = [(tuk.slot_uniforms_plain(s, R, K) < 0.2).numpy() for s in (0, 1, 2)]
    assert not np.array_equal(masks[0], masks[1]) and not np.array_equal(masks[1], masks[2])
    assert abs(masks[0].mean() - 0.2) < 0.005


def test_kernel_term_split_covers_each_active_term_once():
    """The kernel's term t of a 32-slot chunk: active slot j = t / (neg + 1)
    from an f32 product and one correction step, sample si = t - j (neg +
    1); every (j, si) once, in f32 arithmetic as on the card."""
    rng = np.random.default_rng(0)
    for neg in (0, 1, 4, 5, 20, 99, 5000):
        np1 = neg + 1
        inv = np.float32(1.0) / np.float32(np1)
        for na in (1, 7, 32):
            t = np.arange(na * np1)
            j = ((t.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
            si = t - j * np1
            j = np.where(si < 0, j - 1, np.where(si >= np1, j + 1, j))
            si = t - j * np1
            assert (si >= 0).all() and (si < np1).all() and (j < na).all()
            np.testing.assert_array_equal(j * np1 + si, t)
        mask = rng.integers(0, 2, size=32).astype(bool)
        rank = np.cumsum(mask) - 1  # the compaction: active lane -> its rank
        assert np.array_equal(np.flatnonzero(mask)[rank[mask]], np.flatnonzero(mask))


def _step_writes(heads, off, R, rpw):
    """A model of the STEP epilogue's walk (``csrc/umap_sgd_epoch.cu``):
    warp w takes rows [w·rpw, (w + 1)·rpw) of the live ones, writes the
    heads whose rows are all its own and the heads without rows before
    its rows' heads (the last warp: after them too), and leaves a partial
    of a head it shares in its slot 0 (the head of its first row) or 1;
    the last of a shared head's warps to arrive adds their partials. Returns
    how many times each head is written."""
    live, n_head = int(off[-1]), len(off) - 1
    writes = np.zeros(n_head, np.int64)
    slots, arrivals = {}, {}
    for w in range(-(-R // rpw)):
        rb, re = w * rpw, min((w + 1) * rpw, live)
        if rb >= live:
            writes[:] += w == 0
            continue
        prev, cur = (heads[rb - 1] if rb else -1), heads[rb]
        writes[prev + 1:cur] += 1

        def flush(hd):
            h0, h1 = off[hd], off[hd + 1]
            if h0 >= rb and h1 <= re:
                writes[hd] += 1
                return
            slot = (w, 0 if h0 <= rb else 1)
            assert slot not in slots
            slots[slot] = hd
            wf, wl = h0 // rpw, (h1 - 1) // rpw
            arrivals[wf] = arrivals.get(wf, 0) + 1
            if arrivals[wf] == wl - wf + 1:
                assert all(slots[(v, 0 if h0 <= v * rpw else 1)] == hd for v in range(wf, wl + 1))
                writes[hd] += 1

        for r in range(rb, re):
            if heads[r] != cur:
                flush(cur)
                writes[cur + 1:heads[r]] += 1
                cur = heads[r]
        flush(cur)
        if re == live:
            writes[cur + 1:] += 1
    return writes


@pytest.mark.parametrize("rpw", [1, 2, 3, 4, 7])
def test_step_walk_writes_every_head_once(rpw):
    rng = np.random.default_rng(rpw)
    for n_head in (1, 5, 60):
        # hubs of many rows, heads without rows (first and last among them)
        counts = rng.choice([0, 0, 1, 1, 2, 3, 11], size=n_head)
        counts[0] = counts[-1] = 0 if n_head > 2 else counts[0]
        off = np.concatenate([[0], np.cumsum(counts)])
        heads = np.repeat(np.arange(n_head), counts)
        for pad in (0, 5):
            R = max(int(off[-1]) + pad, 1)
            heads_all = np.concatenate([heads, np.full(R - heads.size, n_head - 1)])
            np.testing.assert_array_equal(_step_writes(heads_all, off, R, rpw), np.ones(n_head))


def test_kernel_modulo_by_an_invariant_divisor():
    """The kernel's x mod n_tab: q = (t + ((x - t) >> s1)) >> s2 with t =
    umulhi(x, m), m = floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d)."""
    rng = np.random.default_rng(0)
    for d in (1, 2, 3, 7, 24, 4096, 65_536, 70_000, 1_000_003, 2**31 - 1, 2**31, 2**32 - 5):
        l = next(i for i in range(33) if (1 << i) >= d)
        m = ((1 << 32) * ((1 << l) - d)) // d + 1
        assert m < 1 << 32
        s1, s2 = min(l, 1), max(l - 1, 0)
        x = np.concatenate([rng.integers(0, 2**32, size=20_000, dtype=np.uint64),
                            np.array([0, 1, d - 1, d, d + 1, 2**32 - 1], dtype=np.uint64) % 2**32])
        t = (x * np.uint64(m)) >> np.uint64(32)
        q = (t + ((x - t) >> np.uint64(s1))) >> np.uint64(s2)
        np.testing.assert_array_equal(x - q * np.uint64(d), x % np.uint64(d))


def test_k10_geometry_covers_the_rows():
    for R, resident in ((98_304, 4_224), (65_536, 4_224), (200_704, 4_224), (100, 4_224), (1, 8), (1_000, 8)):
        rpw, warps = tuk.k10_geometry(R, resident)
        assert rpw >= 1 and warps * rpw >= R > (warps - 1) * rpw
    assert tuk.k10_geometry(98_304, 4_224) == (5, 19_661)


def test_umap_sgd_draws_from_its_generator_and_the_hash():
    """``draws=None``: a seed from the generator once, then each epoch's
    permutation and offsets from it and the slot uniforms of seed + e."""
    rng, row_heads, tails_pad, p_pad = _mixed_rows(200, 200)
    R = tails_pad.shape[0]
    emb0 = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    args = (torch.from_numpy(row_heads), torch.from_numpy(tails_pad), torch.from_numpy(p_pad))
    got = tuk.umap_sgd(emb0, emb0, *args, torch.Generator().manual_seed(5), n_epochs=3, a=A, b=B)
    g = torch.Generator().manual_seed(5)
    base = int(torch.randint(0, 2**31 - 1, (1,), generator=g))
    emb = emb0.clone()
    rows = tuk.head_rows(args[0], args[2], 200, 2)
    for e in range(3):
        perm = torch.randperm(200, generator=g, dtype=torch.int32)
        offs = torch.randint(0, R, (5,), generator=g, dtype=torch.int32)
        emb = tuk.sgd_epoch_step_plain(emb, emb, rows, args[1], args[2], perm, offs, A, B, 1.0, 2.0,
                                       tuk.epoch_alpha(1.0, e, 3), seed=base + e)
    np.testing.assert_array_equal(got.numpy(), emb.numpy())


def _rows(n, n_tab, K, seed, deg=6):
    rng = np.random.default_rng(seed)
    heads = np.repeat(np.arange(n, dtype=np.int64), deg)
    tails = rng.integers(0, n_tab, size=n * deg)
    w = rng.uniform(0.1, 1.0, size=n * deg).astype(np.float32)
    return (rng, *juk.build_row_adjacency(heads, tails, w, n, K=K, row_bucket=256))


def test_jax_gate_refuses_ten_components_and_twenty_negatives(monkeypatch):
    monkeypatch.setattr(jup, "FORCE_INTERPRET", True)
    assert jup.umap_sgd_pallas_ok(600, 8, 2, 5)
    assert not jup.umap_sgd_pallas_ok(600, 8, 10, 5) and not jup.umap_sgd_pallas_ok(600, 8, 2, 20)


@pytest.mark.parametrize("self_table", [True, False])
def test_epoch_loop_c10_neg20_fed_jax_draws_matches_xla_loop(self_table):
    C, neg, n_epochs = 10, 20, 3
    n_head, n_tab = (400, 400) if self_table else (100, 300)
    rng, row_heads, tails_pad, p_pad = _rows(n_head, n_tab, 8, seed=13)
    R, K = tails_pad.shape
    emb0 = (rng.normal(size=(n_head, C)) * 0.5).astype(np.float32)
    table = emb0 if self_table else rng.normal(size=(n_tab, C)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(n_epochs=n_epochs, a=A, b=B, gamma=1.0, initial_alpha=1.0, negative_sample_rate=neg,
              self_table=self_table)
    emb_j = jnp.asarray(emb0)
    for e in range(n_epochs):
        emb_j = juk.optimize_embedding_rows(
            emb_j, emb_j if self_table else jnp.asarray(table), jnp.asarray(row_heads), jnp.asarray(tails_pad),
            jnp.asarray(p_pad), key, epoch_offset=e, epoch_span=1, **kw)

    def jax_draws(e):
        k1, k2, k3 = juk.epoch_rng_keys(key, e)
        return (torch.from_numpy(np.array(jax.random.uniform(k1, (R, K)))),
                torch.from_numpy(np.array(jax.random.permutation(k2, n_tab), np.int32)),
                torch.from_numpy(np.array(jax.random.randint(k3, (neg,), 0, R), np.int32)))

    emb_t = tuk.umap_sgd(torch.from_numpy(emb0), torch.from_numpy(table), torch.from_numpy(row_heads),
                         torch.from_numpy(tails_pad), torch.from_numpy(p_pad), None, draws=jax_draws, **kw)
    assert emb_t.shape == (n_head, C)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=5e-4)


def test_sgd_epoch_rows_c10_neg20_matches_pallas_interpret():
    C, neg = 10, 20
    rng, row_heads, tails_pad, p_pad = _rows(300, 300, 8, seed=4)
    R, K = tails_pad.shape
    src = rng.normal(size=(300, C)).astype(np.float32)
    h = src[row_heads]
    u = rng.random((R, K)).astype(np.float32)
    perm = rng.permutation(300).astype(np.int32)
    offs = rng.integers(0, R, size=neg).astype(np.int32)
    nid = tuk.negative_ids(torch.from_numpy(perm), torch.from_numpy(offs), R, K)  # (R, K, neg)
    neg_ids = nid.permute(0, 2, 1).reshape(R, neg * K).to(torch.int32).numpy()  # slot-major per s
    ref = jup.sgd_epoch_rows(
        jnp.asarray(src), jnp.asarray(h), jnp.asarray(tails_pad), jnp.asarray(p_pad), jnp.asarray(neg_ids),
        jnp.asarray(u), jnp.zeros((1, 1), jnp.int32), a=A, b=B, gamma=1.0, attract_scale=2.0, rng="xla",
        interpret=True)
    got = tuk.sgd_epoch_rows(*(torch.from_numpy(x) for x in (src, h, tails_pad, p_pad, perm, offs, u)), A, B, 1.0,
                             2.0)
    assert got.shape == (R, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_umap_ten_components_matches_jax_statistically():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(5, 12)) * 5
    X = (centers[rng.integers(0, 5, size=500)] + 0.3 * rng.normal(size=(500, 12))).astype(np.float32)
    kw = dict(n_neighbors=12, n_components=10, min_dist=0.0, random_state=42, init="random")
    jm = JUMAP(num_workers=1, **kw).fit(JDataFrame({"features": X}))
    tm = TUMAP(device="cpu", **kw).fit(TDataFrame({"features": X}))
    assert tm.embedding_.shape == (500, 10) and np.isfinite(tm.embedding_).all()
    tj = trustworthiness(X, jm.embedding_, n_neighbors=12)
    tt = trustworthiness(X, tm.embedding_, n_neighbors=12)
    assert tj > 0.85 and tt > 0.85 and abs(tt - tj) < 0.03, (tt, tj)
    out = np.asarray(tm.transform(TDataFrame({"features": X[:50]})).column("embedding"))
    assert out.shape == (50, 10) and np.isfinite(out).all()


@pytest.mark.parametrize("shape", ["fit", "transform", "umap_cluster_transform"])
def test_chip_smoke_k10_bands_hold_the_plain_f32_and_catch_the_controls(shape):
    """``chip_smoke.check_sgd_epoch`` on the CPU, where both epilogues'
    wrappers take their plain versions in f32: every band holds and every
    control is caught (a failure raises SystemExit). The umap_cluster
    transform's case: C = 10, K = 30."""
    fit = shape == "fit"
    C, K = (10, 30) if shape == "umap_cluster_transform" else (2, 15)
    rng, row_heads, tails_pad, p_pad = _mixed_rows(400, 400, K=24, seed=2) if fit else _rows(400, 400, K, 2, K)
    R, K = tails_pad.shape
    src = torch.from_numpy((rng.random((400, C)) * 20 - 10).astype(np.float32))
    emb = src if fit else src + 0.5
    heads = torch.from_numpy(row_heads) if fit else torch.arange(R) % 400
    if not fit:  # one row a head: the transform's rows are its queries
        emb = torch.from_numpy((rng.random((R, C)) * 20 - 10).astype(np.float32))
        heads = torch.arange(R)
    perm = torch.from_numpy(rng.permutation(400).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, R, size=5).astype(np.int32))
    u = torch.from_numpy(rng.random((R, K)).astype(np.float32))
    res = chip_smoke.check_sgd_epoch(torch, tuk, shape, src, emb, heads, torch.from_numpy(tails_pad),
                                     torch.from_numpy(p_pad), perm, offs, u, A, B, 0, 2.0 if fit else 1.0, 77)
    assert res["err_over_tol"] <= 1 and res["rows_err_over_tol"] <= 1 and res["drawn_rows_err_over_tol"] <= 1
    caught = {c["control"] for c in res["controls"]}
    assert "top bit of the slot hash flipped" in caught and "repulsive term dropped on even rows" in caught
    assert ("every head's second row skipped in STEP" in caught) == fit


class _SharedCopies:
    """``tuk`` with the fault ``check_k10_offset_views`` is there to catch:
    a wrapper given a table and heads that both lie off 16 bytes reads the
    heads' copy as the table (two copies in one freed block)."""

    def __getattr__(self, name):
        return getattr(tuk, name)

    @staticmethod
    def sgd_epoch_rows(src, h, *args, **kw):
        return tuk.sgd_epoch_rows(h if src.data_ptr() % 16 and h.data_ptr() % 16 else src, h, *args, **kw)

    @staticmethod
    def sgd_epoch_step(emb, table, *args, **kw):
        return tuk.sgd_epoch_step(emb, emb if table.data_ptr() % 16 and emb.data_ptr() % 16 else table, *args,
                                  **kw)


@pytest.mark.parametrize("shared", [False, True])
def test_chip_smoke_k10_offset_views_check(shared):
    """``chip_smoke.check_k10_offset_views`` on the CPU at a transform
    shape (one row a query, a frozen table of the same shape): it passes
    on the wrappers, and a stand-in that reads one copy as the other is
    caught (a failure raises SystemExit)."""
    rng, _, tails_pad, p_pad = _rows(400, 400, 15, 3, 15)
    R = tails_pad.shape[0]
    src = torch.from_numpy((rng.random((R, 2)) * 20 - 10).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(R).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, R, size=5).astype(np.int32))
    u = torch.from_numpy(rng.random(tails_pad.shape).astype(np.float32))
    args = (torch, _SharedCopies() if shared else tuk, src, src + 0.5, torch.from_numpy(tails_pad),
            torch.from_numpy(p_pad), perm, offs, u, A, B, 91)
    if shared:
        with pytest.raises(SystemExit):
            chip_smoke.check_k10_offset_views(*args)
    else:
        assert chip_smoke.check_k10_offset_views(*args)
