"""The port's packed-byte gather (K7 and K8) held against the JAX package
on the CPU: the wrappers run their plain PyTorch versions here (CPU
tensors), the Pallas kernels run in interpret mode. Every output is an
integer byte, so the two must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu.ops.rf_pallas as rfp
import spark_rapids_ml_tpu.ops.tree_kernels as tk
from spark_rapids_ml_tpu_torch.ops import rf_kernels as rk
from spark_rapids_ml_tpu_torch.ops import tree_kernels as pt


def _packed(rng, n, words):
    bins = rng.integers(0, 256, size=(n, 4 * words)).astype(np.uint8)
    packed = np.array(tk._pack_bins(jnp.asarray(bins)))
    # the port's packing is the little-endian view of the same bytes
    np.testing.assert_array_equal(pt.pack_bins(torch.from_numpy(bins)).numpy(), packed)
    return bins, packed


def test_byte_gather_many_matches_pallas():
    """K8 at the TPU kernel's own shape: n = 4,096 rows of W = 64 words,
    G = 3 index sets of in-range byte indices, equal to the Pallas kernel
    and to the bins read directly."""
    rng = np.random.default_rng(0)
    n, W, G = 4096, 64, 3
    bins, packed = _packed(rng, n, W)
    idx = rng.integers(0, 4 * W, size=(G, n, W)).astype(np.int32)
    ref = np.asarray(rfp.packed_byte_gather_many(jnp.asarray(packed), jnp.asarray(idx), interpret=True))
    got = rk.packed_byte_gather_many(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    assert got.dtype == np.int32 and got.shape == (G, n, W)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.take_along_axis(bins[None].astype(np.int32), idx, axis=2))


def test_byte_gather_single_set_matches_pallas():
    """K7 (one index set) against its Pallas kernel."""
    rng = np.random.default_rng(1)
    n, W = 4096, 64
    _, packed = _packed(rng, n, W)
    idx = rng.integers(0, 4 * W, size=(n, W)).astype(np.int32)
    ref = np.asarray(rfp.packed_byte_gather(jnp.asarray(packed), jnp.asarray(idx), interpret=True))
    got = rk.packed_byte_gather(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,words,k,G", [(4096, 64, 64, 2), (1001, 37, 5, 3), (333, 750, 63, 2)])
def test_out_of_range_index_reads_zero(n, words, k, G):
    """The sentinel rule of the JAX package's ``_contract_gather`` (no word
    matches an index outside [0, 4·words), so it reads 0), at the TPU
    shape and at ragged n, words and k that the TPU kernel does not take."""
    rng = np.random.default_rng(n)
    bins, packed = _packed(rng, n, words)
    idx = rng.integers(-3, 4 * words + 4, size=(G, n, k)).astype(np.int32)
    idx[:, :, 0] = 4 * words   # the feature-count sentinel at n_features == d_pad
    idx[:, :, -1] = -1
    got = rk.packed_byte_gather_many(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    for g in range(G):
        ref = np.asarray(tk._contract_gather(jnp.asarray(packed), jnp.asarray(idx[g])))
        np.testing.assert_array_equal(got[g], ref)
    inside = (idx >= 0) & (idx < 4 * words)
    assert (got[~inside] == 0).all() and (~inside).sum() >= 2 * G * n
    np.testing.assert_array_equal(got[inside], np.broadcast_to(bins, (G,) + bins.shape)[
        np.nonzero(inside)[0], np.nonzero(inside)[1], idx[inside]])
    one = rk.packed_byte_gather(torch.from_numpy(packed), torch.from_numpy(idx[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_byte_gather_shape_errors():
    packed = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="must be"):
        rk.packed_byte_gather_many(packed, torch.zeros((2, 9, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="must be"):
        rk.packed_byte_gather(packed, torch.zeros((10,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# K7/K8's CUDA geometry and index mapping, walked on the CPU
# ---------------------------------------------------------------------------

# an H100's opt-in shared memory a block, SMs, resident blocks an SM
H100 = (232_448, 132, 4)
# AHEAD of csrc/rf_byte_gather.cu: index vectors a thread loads at once
KERNEL_AHEAD = 4


@pytest.mark.parametrize("misaligned", ["", "idx", "packed"])
@pytest.mark.parametrize("words", [37, 64, 750, 20_000])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("k", [1, 63])
def test_gather_geometry(k, G, words, misaligned):
    """The instance ``_gather_geometry`` picks, and sizes that the kernel
    takes: R a multiple of 4, every chunk's entries in 32 bits, no block
    without a chunk, and, staged, two stages within the block's shared
    memory. n·k is odd at k = 63."""
    n = 131_071
    geom = rk._gather_geometry(n, words, k, G, misaligned != "packed", misaligned != "idx",
                               *H100)
    staged = misaligned != "packed" and words <= 7_264 and G * k >= 32 * -(-words // 8)
    assert geom.instance == ("staged" if staged else "direct") + ("_scalar" if misaligned == "idx" else "_vec")
    assert geom.rows >= 4 and geom.rows % 4 == 0 and G * geom.rows * k < 2 ** 31
    chunks = -(-n // geom.rows)
    # one wave of resident blocks walking the chunks, or one block a chunk
    # from _GATHER_WAVES_UNROLLED waves of chunks
    per_sm = min(H100[2], rk._SM_SHARED_BYTES // (geom.smem + 1024)) if staged else H100[2]
    wave = H100[1] * per_sm
    assert geom.grid == (chunks if chunks >= rk._GATHER_WAVES_UNROLLED * wave else min(chunks, wave))
    if staged:
        assert geom.stages == 2 and geom.smem == 2 * geom.rows * 4 * words <= H100[0]
        # at least one block's stages fit an SM
        assert geom.smem + 1024 <= rk._SM_SHARED_BYTES
    else:
        assert geom.stages == 0 and geom.smem == 0
    # the main path's shapes: the bench forest's (G = 8, k = 63, 64 words)
    # stages; its one-tree form (G = 1), the GBT's (k = 1) and the
    # 3,000-feature forest's (750 words) go direct
    if misaligned == "" and (k, G, words) in ((63, 8, 64), (63, 1, 64), (1, 8, 64), (63, 8, 750)):
        assert geom.instance == ("staged_vec" if (k, G, words) == (63, 8, 64) else "direct_vec")


def test_gather_geometry_forced():
    """A forced instance: staged raises where its two stages of 4 rows do
    not fit, direct takes any width."""
    with pytest.raises(ValueError, match="do not stage"):
        rk._gather_geometry(100, 7_300, 7, 2, True, True, *H100, staged=True)
    with pytest.raises(ValueError, match="do not stage"):
        rk._gather_geometry(100, 64, 7, 2, False, True, *H100, staged=True)
    assert rk._gather_geometry(100, 64, 1, 1, True, True, *H100,
                               staged=True).instance == "staged_vec"
    assert rk._gather_geometry(100, 64, 63, 8, True, False, *H100,
                               staged=False).instance == "direct_scalar"
    with pytest.raises(ValueError, match="no geometry"):
        rk._gather_geometry(100, 64, 0, 8, True, True, *H100)


def _make_div(d):
    """``make_div`` of csrc/rf_byte_gather.cu."""
    if d == 0:
        return 0, 1, 0
    s = 0
    while (1 << s) < d:
        s += 1
    return d, (((1 << 32) * ((1 << s) - d)) // d + 1) & 0xFFFFFFFF, s


def _fdiv(f, x):
    """``fdiv``: (umulhi(x, m) + x) >> s, on uint64 arrays of x < 2^31."""
    _, m, s = f
    return (((x * np.uint64(m)) >> np.uint64(32)) + x) >> np.uint64(s)


def test_fast_division():
    rng = np.random.default_rng(3)
    ds = np.concatenate([np.arange(1, 300), rng.integers(1, 2 ** 31, size=300), [2 ** 30, 2 ** 30 + 1, 2 ** 31 - 1]])
    for d in ds.tolist():
        x = np.concatenate([rng.integers(0, 2 ** 31, size=2000), np.arange(0, 3 * d, max(1, d // 7))[:200],
                            [d - 1, d, d + 1, 2 ** 31 - 1]]).astype(np.uint64)
        np.testing.assert_array_equal(_fdiv(_make_div(d), x), x // np.uint64(d))


def _walk(packed, idx, geom, idx_misaligned=False):
    """The kernel's (block, chunk, thread, vector) -> (g, r, j) mapping of
    ``serve`` and ``gather_staged`` / ``gather_direct``, evaluated with
    numpy: returns the output it writes and how often it writes each entry
    (entries past the end would fail the bounds check). A staged chunk
    reads only the rows its stage holds."""
    G, n, k = idx.shape
    words = packed.shape[1]
    vec = geom.instance.endswith("_vec")
    staged = geom.instance.startswith("staged")
    R, T, A = geom.rows, rk._GATHER_THREADS, KERNEL_AHEAD
    flat_idx = idx.reshape(-1).astype(np.int64)
    out = np.full(G * n * k, -7, np.int64)
    writes = np.zeros(G * n * k, np.int64)
    limit = 4 * words
    chunks = -(-n // R)
    span_full, span_last = R * k, (n - (chunks - 1) * R) * k
    full = _make_div(span_full >> 2 if vec else span_full)
    last = _make_div(span_last >> 2 if vec else span_last)
    kdiv = _make_div(k)
    pb = packed.view(np.uint8).reshape(n, 4 * words)
    seen = np.zeros(chunks, np.int64)

    def emit(e, L, r0, span, nrows):
        # e: entries (int64), L: their offsets in the set's span
        assert (e >= 0).all() and (e < G * n * k).all(), "an entry past the end"
        row = _fdiv(kdiv, L.astype(np.uint64)).astype(np.int64)
        assert (row < nrows).all(), "a row outside the chunk (its stage)"
        true_row = (e % (n * k)) // k
        np.testing.assert_array_equal(r0 + row, true_row)
        j = flat_idx[e]
        inside = (j >= 0) & (j < limit)
        val = np.where(inside, pb[r0 + row, np.clip(j, 0, limit - 1)], 0)
        np.add.at(writes, e, 1)
        out[e] = val

    for b in range(geom.grid):
        for c in range(b, chunks, geom.grid):
            seen[c] += 1
            r0 = c * R
            nrows = min(R, n - r0)
            span = nrows * k
            cd = last if c == chunks - 1 else full
            nq = G * cd[0]
            base = r0 * k
            t = np.arange(T, dtype=np.uint64)
            for q0 in range(0, nq, A * T):
                for u in range(A):
                    q = np.uint64(q0 + u * T) + t
                    q = q[q < nq]
                    g = _fdiv(cd, q)
                    it = (q - g * np.uint64(cd[0])).astype(np.int64)
                    s0 = g.astype(np.int64) * (n * k) + base
                    if vec:
                        h = np.minimum((-s0) & 3, span)
                        ok = it < (span - h) >> 2
                        L = (h + 4 * it)[ok]
                        e0 = s0[ok] + L
                        assert (e0 % 4 == 0).all()
                        for i in range(4):  # the running column of the kernel
                            emit(e0 + i, L + i, r0, span, nrows)
                    else:
                        emit(s0 + it, it, r0, span, nrows)
            if vec:
                q = np.arange(G * 8, dtype=np.int64)
                slot = q & 7
                s0 = (q >> 3) * (n * k) + base
                h = np.minimum((-s0) & 3, span)
                L = np.where(slot < 4, slot, h + ((span - h) & ~3) + (slot - 4))
                ok = np.where(slot < 4, L < h, L < span)
                emit(s0[ok] + L[ok], L[ok], r0, span, nrows)
    assert (seen == 1).all(), "a chunk walked twice or never"
    return out.reshape(G, n, k), writes


@pytest.mark.parametrize("n,words,k,G,staged,vec", [
    (1001, 37, 5, 3, True, True),      # n·k % 4 = 1: ragged heads and tails
    (1001, 37, 5, 3, False, True),
    (1001, 37, 5, 3, True, False),     # idx off 16-byte alignment: scalar
    (1001, 37, 5, 3, False, False),
    (4099, 64, 1, 1, True, True),      # k = 1, G = 1
    (4099, 64, 1, 1, False, True),
    (2003, 64, 1, 8, True, True),      # the GBT's k = 1, G = 8
    (2003, 64, 1, 8, False, True),
    (333, 750, 63, 2, True, True),     # the 3,000-feature width
    (9, 7300, 7, 2, False, True),      # past the staged cap
    (3, 16, 1, 2, True, True),         # fewer entries a set than a vector
    (3, 16, 1, 2, False, True),
])
def test_kernel_mapping_writes_every_entry_once(n, words, k, G, staged, vec):
    """Every entry of every set is written exactly once, with the byte the
    plain version gives, none past the end, and a staged chunk reads only
    its own rows."""
    rng = np.random.default_rng(n + words)
    packed = rng.integers(-2 ** 31, 2 ** 31, size=(n, words), dtype=np.int64).astype(np.int32)
    idx = rng.integers(-1, 4 * words + 1, size=(G, n, k)).astype(np.int32)
    geom = rk._gather_geometry(n, words, k, G, True, vec, *H100, staged=staged)
    out, writes = _walk(packed, idx, geom)
    assert (writes == 1).all()
    ref = rk.packed_byte_gather_many_plain(torch.from_numpy(packed), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)
