"""The additive-FFT operands of kernels K1 and K4, byte for byte against the
JAX package.

``_kernel_program`` is a numpy emulation of what ``csrc/rs_hash.cu`` runs on
the card: it reads only the operand tensors the wrappers send
(``EncodeMatrix.fft_rows`` and ``fft_group``), stages them as the kernel
does (a zero row after the product rows, and each group's row offset, a
zero twiddle's pointing at the zero row), holds 2 lanes per state word as
the kernel does, and multiplies with the kernel's byte permutes: one makes
each lookup address, one puts the two products together.
It is held against ``celestia_tpu.ops.gf256.leopard_encode`` and the parity
of ``rs_pallas.encode2d_hash_reference``. Outputs are code words: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.ops import rs_pallas, rs_tpu
from celestia_tpu_torch.ops import gf256, rs, rs_cuda

ALL_K = [1, 2, 4, 8, 16, 32, 64, 128]
CPU = torch.device("cpu")
ROW = 256  # bytes per product-row slot (kRow)
BRANCH_DIST = 8  # groups this wide branch over a zero twiddle (kBranchDist)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _prmt(a, b, sel: int):
    """CUDA's ``__byte_perm(a, b, sel)`` on uint32 arrays: result byte i is
    byte ``(sel >> 4i) & 7`` of b‖a (bytes 0-3 from a, 4-7 from b)."""
    src = np.stack([(a >> (8 * j)) & 0xFF for j in range(4)] +
                   [np.broadcast_to(b, np.shape(a)) >> (8 * j) & 0xFF for j in range(4)])
    out = np.zeros(np.shape(a), dtype=np.uint32)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7].astype(np.uint32) << np.uint32(8 * i)
    return out


def _kernel_program(x2: np.ndarray, em: rs.EncodeMatrix) -> np.ndarray:
    """(k, N) data shards -> (k, N) parity, as the kernel computes it."""
    k, n = x2.shape
    rows = em.fft_rows.numpy()
    group = em.fft_group.numpy()
    n_const = rows.shape[0]
    smem = np.zeros((n_const + 1) * ROW, dtype=np.uint8)  # the last slot is zero
    smem[:n_const * ROW] = rows.reshape(-1)
    zero = np.uint32(n_const * ROW)
    grp = [zero if r < 0 else np.uint32(r * ROW) for r in group.tolist()]

    def gf_mul(y, base):
        p0 = smem[_prmt(y, base, 0x7650)].astype(np.uint32)
        p1 = smem[_prmt(y, base, 0x7651)].astype(np.uint32)
        return _prmt(p0, p1, 0x1140)

    w = [x2[i].view("<u2").astype(np.uint32) for i in range(k)]  # 2 lanes a word
    g = 0
    dist = 1
    while dist < k:  # IFFT: y ^= x, then x ^= c * y
        for r in range(0, k, 2 * dist):
            gp = grp[g]
            g += 1
            for i in range(dist):
                w[r + dist + i] = w[r + dist + i] ^ w[r + i]
            if dist < BRANCH_DIST or gp != zero:
                for i in range(dist):
                    w[r + i] = w[r + i] ^ gf_mul(w[r + dist + i], gp)
        dist *= 2
    dist = k >> 1
    while dist >= 1:  # FFT: x ^= c * y, then y ^= x
        for r in range(0, k, 2 * dist):
            gp = grp[g]
            g += 1
            if dist < BRANCH_DIST or gp != zero:
                for i in range(dist):
                    w[r + i] = w[r + i] ^ gf_mul(w[r + dist + i], gp)
            for i in range(dist):
                w[r + dist + i] = w[r + dist + i] ^ w[r + i]
        dist >>= 1
    assert g == len(grp)
    assert all((wi >> 16 == 0).all() for wi in w)  # the high half-word stays clear
    return np.stack([wi.astype("<u2").view(np.uint8) for wi in w])


@pytest.mark.parametrize("k", ALL_K)
def test_kernel_program_matches_leopard_and_pallas_reference(k):
    n = 512 if k >= 32 else k * 512
    x2 = _bytes((k, n), seed=900 + k)
    got = _kernel_program(x2, rs.encode_matrix(k, CPU))
    assert got.dtype == np.uint8 and got.shape == (k, n)
    assert np.array_equal(got, jax_gf256.leopard_encode(x2))
    ref_parity, _ = rs_pallas.encode2d_hash_reference(x2, rs_tpu.encode_bit_matrix(k), tile=n)
    assert np.array_equal(got, ref_parity)


@pytest.mark.parametrize("k", ALL_K)
def test_fft_program_shape(k):
    rows, group = rs.fft_program(k)
    assert rows.dtype == np.uint8 and group.dtype == np.int16
    assert rows.shape == (max(k - 1, 0), 256)  # one row per distinct twiddle
    assert group.shape == (2 * (k - 1),)
    assert set(group.tolist()) <= set(range(-1, rows.shape[0]))
    # every row is used, and each is mul(c, .) for a nonzero c = rows[:, 1]
    assert set(group.tolist()) - {-1} == set(range(rows.shape[0]))
    mul = gf256.mul_table()
    assert (rows[:, 1] != 0).all() and len(set(rows[:, 1].tolist())) == rows.shape[0]
    assert np.array_equal(rows, mul[rows[:, 1]])
    # the zero twiddles: the first group of each FFT level (log(skew[dist - 1]) = 255)
    skips = np.flatnonzero(group < 0).tolist()
    assert skips == [k - 1 + (1 << lv) - 1 for lv in range(int(np.log2(k)))]


def test_fft_operands_built_once_per_k_and_device():
    a = rs.encode_matrix(64, CPU)
    assert rs.encode_matrix(64, torch.device("cpu")) is a
    assert rs.encode_matrix(32, CPU) is not a
    assert a.k == 64 and rs.encode_matrix(32, CPU).k == 32
    assert rs.fft_program(64)[0] is rs.fft_program(64)[0]
    for k in ALL_K[1:]:
        assert rs.encode_matrix(k, CPU).fft_rows.shape[0] == k - 1


def test_encode_matrix_from_numpy_refuses_another_code():
    m2 = rs_tpu.encode_bit_matrix(4).copy()
    m2[0, 0] ^= 1
    with pytest.raises(ValueError):
        rs.encode_matrix_from_numpy(m2, CPU)
    with pytest.raises(ValueError):  # 8k square, but k = 3 is no power of two
        rs.encode_matrix_from_numpy(np.zeros((24, 24), np.uint8), CPU)


def test_encode_wrappers_refuse_operands_of_another_k():
    x2 = torch.zeros((4, 512), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda._check_encode_inputs(x2, rs.encode_matrix(8, CPU))
    rs_cuda._check_encode_inputs(x2, rs.encode_matrix(4, CPU))


def test_prmt_emulation_selectors():
    a, b = np.uint32(0x44332211), np.uint32(0x88776655)
    assert int(_prmt(a, b, 0x3210)) == 0x44332211
    assert int(_prmt(a, b, 0x7654)) == 0x88776655
    assert int(_prmt(a, b, 0x7651)) == 0x88776622
    assert int(_prmt(np.uint32(0x11), np.uint32(0x22), 0x1140)) == 0x00002211
