"""Reed-Solomon extension as a GF(2) bit-matrix product (port of ops/rs_tpu.py).

The Leopard code (pkg/appconsts/global_consts.go:92 selects it) is linear
over GF(2^8): parity shard j = sum_i M[j, i] * data_i with
M = gf256.encode_matrix(k). Multiplication by a GF(256) constant is linear
over GF(2)^8, so the whole encode expands to one (8k, 8k) 0/1 matrix M2:

    parity_bits = M2 @ data_bits  (mod 2)

Bit order: a byte unpacks LSB-first to 8 bit lanes, contraction index
q = 8*shard + bit; M2 block (j, i) is the 8x8 companion matrix of
multiply-by-M[j, i]: M2[8j+r, 8i+c] = bit_r(M[j, i] * x^c).

This code has no weights: M2 is its only parameter, and
``encode_matrix_from_numpy`` carries the JAX package's M2 across into the
port's two forms (the 0/1 tensor the plain version multiplies, and the
bit-packed words the CUDA kernel K1 reads).

The plain functions here are the reference the kernels are held against. The
contraction runs in float32: the operands are 0/1 and a sum has at most 1024
terms, so every partial sum is an exact integer in float32 (and in TF32,
whose inputs 0 and 1 are exact too); ``& 1`` then gives the GF(2) bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from celestia_tpu_torch.ops import gf256


def expand_bit_matrix(m: np.ndarray) -> np.ndarray:
    """Expand an (r, c) GF(256) matrix to its (8r, 8c) 0/1 matrix over
    GF(2): block (j, i) is the 8×8 companion matrix of multiply-by-m[j,i],
    bit lanes LSB-first (out[8j+r, 8i+c] = bit_r(m[j,i] * x^c))."""
    mul = gf256.mul_table()
    powers = (1 << np.arange(8)).astype(np.uint8)  # x^c as bytes
    prod = mul[m[:, :, None], powers[None, None, :]]  # m[j,i] * x^c
    bits = (prod[..., None] >> np.arange(8)) & 1  # [j, i, c, r]
    out = bits.transpose(0, 3, 1, 2).reshape(8 * m.shape[0], 8 * m.shape[1])
    return out.astype(np.uint8)


@functools.lru_cache(maxsize=16)
def encode_bit_matrix(k: int) -> np.ndarray:
    """(8k, 8k) uint8 0/1 matrix M2 with parity_bits = M2 @ data_bits mod 2."""
    return expand_bit_matrix(gf256.encode_matrix(k))


@dataclasses.dataclass(frozen=True)
class EncodeMatrix:
    """M2 on a device in the two forms the port reads.

    bits:   (8k, 8k) uint8 0/1 — the plain version's operand.
    packed: (8k, W) uint32 — row p of M2 packed LSB-first into 32-bit words
            (bit j of word w is M2[p, 32w + j]), W = max(4, k/4) so that a
            row is whole 16-byte vectors. Read little-endian, k data bytes of
            one lane are the same 8k-bit vector in the same order, so parity
            bit p is popcount(AND of the words) mod 2 (csrc/rs_hash.cu)."""

    bits: torch.Tensor
    packed: torch.Tensor


def packed_words(k: int) -> int:
    """Words per packed M2 row (whole uint4 vectors, as the kernel loads)."""
    return max(4, (8 * k) // 32)


def encode_matrix_from_numpy(m2: np.ndarray, device) -> EncodeMatrix:
    """The JAX package's M2 (``rs_tpu.encode_bit_matrix(k)``, a numpy
    (8k, 8k) 0/1 array) -> the port's EncodeMatrix on ``device``."""
    m2 = np.asarray(m2)
    if m2.ndim != 2 or m2.shape[0] != m2.shape[1] or m2.shape[0] % 8:
        raise ValueError(f"M2 must be (8k, 8k), got {m2.shape}")
    if not np.isin(m2, (0, 1)).all():
        raise ValueError("M2 must be a 0/1 matrix")
    rows = m2.shape[0]
    words = packed_words(rows // 8)
    padded = np.zeros((rows, words * 32), dtype=np.uint64)
    padded[:, :rows] = m2
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    packed = (padded.reshape(rows, words, 32) * weights).sum(axis=-1)
    packed = packed.astype(np.uint32).view(np.int32)
    return EncodeMatrix(
        bits=torch.as_tensor(m2.astype(np.uint8), device=device),
        packed=torch.as_tensor(packed, device=device).view(torch.uint32),
    )


@functools.lru_cache(maxsize=16)
def _encode_matrix_cached(k: int, device: str) -> EncodeMatrix:
    return encode_matrix_from_numpy(encode_bit_matrix(k), device)


def encode_matrix(k: int, device: torch.device) -> EncodeMatrix:
    """M2 for square size k on ``device``, built once per (k, device)."""
    return _encode_matrix_cached(k, str(device))


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., S, B) -> uint8 0/1 bit lanes (..., 8S, B), LSB-first.

    S is the shard axis (contraction side), B the byte-position axis."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)[:, None]
    bits = (x[..., :, None, :] >> shifts) & 1
    return bits.reshape(*x.shape[:-2], 8 * x.shape[-2], x.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., 8S, B) -> uint8 (..., S, B), LSB-first per byte."""
    s8 = bits.shape[-2]
    b = bits.reshape(*bits.shape[:-2], s8 // 8, 8, bits.shape[-1]).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))[:, None]
    return (b * weights).sum(dim=-2).to(torch.uint8)


def rs_encode_rows(data: torch.Tensor, m2_bits: torch.Tensor) -> torch.Tensor:
    """Batched Leopard encode: (..., k, B) uint8 -> (..., k, B) parity.

    The second-to-last axis is the shard axis (the k inputs of the code);
    every leading axis and the trailing byte axis are independent lanes."""
    bits = unpack_bits(data).to(torch.float32)  # (..., 8k, B)
    acc = torch.matmul(m2_bits.to(torch.float32), bits)
    return pack_bits(acc.to(torch.int32) & 1)


def extend_quadrants(q0: torch.Tensor, encode) -> torch.Tensor:
    """(k, k, 512) uint8 original square -> (2k, 2k, 512) EDS, with
    ``encode`` mapping (k, N) data shards (shard axis leading) to (k, N)
    parity shards.

    Quadrant chain per rsmt2d: Q1 = row-extend Q0, Q2 = col-extend Q0,
    Q3 = row-extend Q2. Column extension contracts over the leading (row)
    axis, the kernels' native layout; row extension transposes in and out."""
    k, _, b = q0.shape
    n = k * b

    def col_encode(q):
        return encode(q.reshape(k, n)).reshape(k, k, b)

    def row_encode(q):
        return col_encode(q.transpose(0, 1)).transpose(0, 1)

    q1 = row_encode(q0)
    q2 = col_encode(q0)
    q3 = row_encode(q2)
    top = torch.cat([q0, q1], dim=1)
    bottom = torch.cat([q2, q3], dim=1)
    return torch.cat([top, bottom], dim=0)


def extend_square(q0: torch.Tensor, m2_bits: torch.Tensor) -> torch.Tensor:
    """(k, k, 512) uint8 original square -> (2k, 2k, 512) EDS, plain."""
    return extend_quadrants(q0, lambda x: rs_encode_rows(x, m2_bits))
