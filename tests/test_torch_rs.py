"""The port's RS encode and the plain versions of kernels K1 and K2,
byte for byte against the JAX package.

The same numpy-seeded inputs go through celestia_tpu (XLA on the CPU, and
the Pallas kernels' eager tile-math references) and through
celestia_tpu_torch on the CPU, where the kernel wrappers run their plain
PyTorch versions. Outputs are code words and hashes: the tolerance is exact
equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.ops import rs_pallas, rs_tpu
from celestia_tpu_torch.ops import gf256, rs, rs_cuda

ALL_K = [1, 2, 4, 8, 16, 32, 64, 128]
SMALL_K = [1, 2, 4, 8, 16]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("k", ALL_K)
def test_encode_bit_matrix_matches_jax(k):
    assert np.array_equal(gf256.encode_matrix(k), jax_gf256.encode_matrix(k))
    assert np.array_equal(rs.encode_bit_matrix(k), rs_tpu.encode_bit_matrix(k))


@pytest.mark.parametrize("k", ALL_K)
def test_encode_matrix_from_numpy_round_trips(k):
    m2 = rs_tpu.encode_bit_matrix(k)
    em = rs.encode_matrix_from_numpy(m2, "cpu")
    assert np.array_equal(em.bits.numpy(), m2)
    rows, group = rs.fft_program(k)
    assert em.fft_rows.dtype == torch.uint8 and em.fft_group.dtype == torch.int16
    assert np.array_equal(em.fft_rows.numpy(), rows)
    assert np.array_equal(em.fft_group.numpy(), group)
    assert em.fft_rows.shape == (max(k - 1, 0), 256) and em.fft_group.shape == (2 * (k - 1),)


def test_encode_matrix_from_numpy_rejects_malformed():
    with pytest.raises(ValueError):
        rs.encode_matrix_from_numpy(np.zeros((8, 16), np.uint8), "cpu")
    with pytest.raises(ValueError):
        rs.encode_matrix_from_numpy(np.full((8, 8), 2, np.uint8), "cpu")


@pytest.mark.parametrize("k", SMALL_K)
def test_extend_square_matches_jax_and_leopard(k):
    q0 = _bytes((k, k, 512), seed=k)
    m2 = rs_tpu.encode_bit_matrix(k)
    eds = rs.extend_square(torch.from_numpy(q0), torch.from_numpy(m2)).numpy()
    jax_eds = np.asarray(rs_tpu.extend_square(jnp.asarray(q0), jnp.asarray(m2)))
    assert np.array_equal(eds, jax_eds)
    for i in range(k):  # Q1 rows against the host Leopard codec
        assert np.array_equal(eds[i, k:], gf256.leopard_encode(q0[i]))
        assert np.array_equal(eds[i, k:], jax_gf256.leopard_encode(q0[i]))


@pytest.mark.parametrize("k", SMALL_K)
def test_encode2d_hash_plain_matches_pallas_reference(k):
    x2 = _bytes((k, k * 512), seed=100 + k)
    m2 = rs_tpu.encode_bit_matrix(k)
    parity, digests = rs_cuda.encode2d_hash(
        torch.from_numpy(x2), rs.encode_matrix_from_numpy(m2, "cpu"))
    ref_parity, ref_digests = rs_pallas.encode2d_hash_reference(x2, m2, tile=k * 512)
    assert parity.dtype == torch.uint8 and digests.dtype == torch.uint32
    assert np.array_equal(parity.numpy(), ref_parity)
    assert np.array_equal(digests.numpy(), ref_digests)


@pytest.mark.parametrize("k", SMALL_K)
def test_leaf_digests2d_plain_matches_pallas_reference(k):
    x2 = _bytes((k, k * 512), seed=200 + k)
    ns_pad = _bytes((k, k, rs_cuda.NS_PAD), seed=300 + k)
    digests = rs_cuda.leaf_digests2d(torch.from_numpy(x2), torch.from_numpy(ns_pad))
    ref = rs_pallas.leaf_digests2d_reference(x2, ns_pad, tile=k * 512)
    assert np.array_equal(digests.numpy(), ref)


def test_pad_namespaces_matches_jax():
    ns_cells = _bytes((4, 4, 29), seed=7)
    ours = rs_cuda.pad_namespaces(torch.from_numpy(ns_cells)).numpy()
    assert np.array_equal(ours, np.asarray(rs_pallas.pad_namespaces(jnp.asarray(ns_cells))))
    assert ours.shape == (4, 4, rs_cuda.NS_PAD)


def test_kernel_wrappers_reject_partial_cells():
    x2 = torch.zeros((2, 700), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.encode2d_hash(x2, rs.encode_matrix(2, torch.device("cpu")))
    with pytest.raises(ValueError):
        rs_cuda.leaf_digests2d(x2, torch.zeros((2, 1, rs_cuda.NS_PAD), dtype=torch.uint8))
