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
