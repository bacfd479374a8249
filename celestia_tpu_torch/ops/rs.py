"""Reed-Solomon extension (port of ops/rs_tpu.py): the plain GF(2)
bit-matrix product and the operands of the CUDA kernels' additive FFT.

The Leopard code (pkg/appconsts/global_consts.go:92 selects it) is linear
over GF(2^8): parity shard j = sum_i M[j, i] * data_i with
M = gf256.encode_matrix(k). Multiplication by a GF(256) constant is linear
over GF(2)^8, so the whole encode expands to one (8k, 8k) 0/1 matrix M2:

    parity_bits = M2 @ data_bits  (mod 2)

Bit order: a byte unpacks LSB-first to 8 bit lanes, contraction index
q = 8*shard + bit; M2 block (j, i) is the 8x8 companion matrix of
multiply-by-M[j, i]: M2[8j+r, 8i+c] = bit_r(M[j, i] * x^c).

The plain functions here multiply by M2; they are the reference the kernels
are held against, and M2 feeds the XOR-schedule compiler. The CUDA kernels
K1 and K4 (csrc/rs_hash.cu) do not: they run ``gf256.leopard_encode``'s own
spelling, an inverse then a forward additive FFT over the k shards, from
the butterfly program ``fft_program(k)`` builds. ``encode_matrix_from_numpy``
carries the JAX package's M2 across and pairs it with that program.

The decode core of EDS repair (``gf256._decode_core``, one fixed linear map
per n = 2k) has the same two forms: ``decode_bit_matrix(n)``, the plain
sweep's (8n, 8n) operand (the JAX package's ``repair_tpu`` spelling), and
``decode_program(n)``, the butterfly program the decode sweep kernel
(csrc/rs_decode.cu) runs; ``decode_operands`` and ``decode_bits`` hold them
on a device.

The contraction runs in float32: the operands are 0/1 and a sum has at most
1024 terms, so every partial sum is an exact integer in float32 (and in
TF32, whose inputs 0 and 1 are exact too); ``& 1`` then gives the GF(2) bit.

The per-k builders (``encode_bit_matrix``, ``fft_program``,
``decode_program``, ``decode_twiddles``, ``decode_bit_matrix``) are
instrumented builders of the device ledger (``devledger``, entries
``rs.<name>``): one build per k, and a retrace when a new k arrives after
warm-up.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from celestia_tpu_torch import devledger
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
@devledger.instrument_builder("rs.encode_bit_matrix")
def encode_bit_matrix(k: int) -> np.ndarray:
    """(8k, 8k) uint8 0/1 matrix M2 with parity_bits = M2 @ data_bits mod 2."""
    return expand_bit_matrix(gf256.encode_matrix(k))


def _butterfly_program(logs: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """Twiddle logs, one per butterfly group in program order -> (rows,
    group): the product rows of the distinct nonzero twiddles (from
    ``gf256.mul_table()``) and each group's row, -1 for a zero twiddle."""
    distinct = sorted({lg for lg in logs if lg != gf256.K_MODULUS})
    index = {lg: i for i, lg in enumerate(distinct)}
    group = np.array([index.get(lg, -1) for lg in logs], dtype=np.int16)
    consts = gf256.exp_table()[np.array(distinct, dtype=np.int64)]
    rows = gf256.mul_table()[consts].reshape(len(distinct), 256)
    rows.flags.writeable = group.flags.writeable = False  # shared by the cache
    return rows, group


def _check_pow2(name: str, v: int) -> None:
    if v < 1 or v & (v - 1):
        raise ValueError(f"{name} must be a power of two, got {v}")


@functools.lru_cache(maxsize=16)
@devledger.instrument_builder("rs.fft_program")
def fft_program(k: int) -> tuple[np.ndarray, np.ndarray]:
    """The butterfly program of ``gf256.leopard_encode`` for k shards, as
    the kernels read it: ``(rows, group)``.

    Groups in the order the encode runs them: the IFFT levels (dist 1 ->
    k/2, r ascending, twiddle ``skew[k - 1 + r + dist]``: y ^= x, then
    x ^= c·y), then the FFT levels (dist k/2 -> 1, r ascending, twiddle
    ``skew[r + dist - 1]``: x ^= c·y, then y ^= x), where x is shards
    [r, r + dist) and y shards [r + dist, r + 2·dist).

    rows:  (n_const, 256) uint8; row i is mul(c_i, ·) for the i-th distinct
           nonzero twiddle c_i, from ``gf256.mul_table()``.
    group: (2(k - 1),) int16; group g's row index, or -1 where its twiddle's
           log is 255 (a zero twiddle: the butterfly skips its multiply).
    k = 1 has no group (the encode is a copy)."""
    _check_pow2("k", k)
    skew = gf256.fft_skew()
    logs = []
    dist = 1
    while dist < k:
        logs += [int(skew[k - 1 + r + dist]) for r in range(0, k, 2 * dist)]
        dist *= 2
    dist = k >> 1
    while dist >= 1:
        logs += [int(skew[r + dist - 1]) for r in range(0, k, 2 * dist)]
        dist >>= 1
    return _butterfly_program(logs)


@functools.lru_cache(maxsize=16)
@devledger.instrument_builder("rs.decode_program")
def decode_program(n: int) -> np.ndarray:
    """The butterfly program of ``gf256._decode_core`` over n = 2k
    positions (the erasure-pattern-independent middle of the Leopard
    decode), as the decode sweep kernel reads it: (2(n - 1),) uint8, each
    butterfly group's twiddle constant, 0 for a zero twiddle (the
    butterfly skips its multiply). The kernel looks each constant up in
    ``decode_table()`` by its own value.

    Groups in the order the core runs them: the IFFT levels (dist 1 ->
    n/2, r ascending: y ^= x, then x ^= c·y), then the FFT levels (dist
    n/2 -> 1: x ^= c·y, then y ^= x), both with twiddle
    ``skew[r + dist - 1]``, skew offset 0 over all n positions (the
    encode's IFFT starts at offset k - 1, so this is not
    ``fft_program(n)``). The formal derivative between the two transforms
    has no twiddle and is not in the program. n = 1 has no group."""
    _check_pow2("n", n)
    skew = gf256.fft_skew()
    logs = []
    dist = 1
    while dist < n:
        logs += [int(skew[r + dist - 1]) for r in range(0, n, 2 * dist)]
        dist *= 2
    dist = n >> 1
    while dist >= 1:
        logs += [int(skew[r + dist - 1]) for r in range(0, n, 2 * dist)]
        dist >>= 1
    logs = np.array(logs, dtype=np.int64)
    consts = np.where(logs == gf256.K_MODULUS, 0,
                      gf256.exp_table()[logs % gf256.K_MODULUS]).astype(np.uint8)
    consts.flags.writeable = False  # shared by the cache
    return consts


HALF_ROW = 128  # bytes of a half row of decode_table: c·y for y < 128


@functools.lru_cache(maxsize=16)
@devledger.instrument_builder("rs.decode_twiddles")
def decode_twiddles(n: int) -> np.ndarray:
    """Each butterfly group's multiply entry as the decode kernel reads it
    (its kernel parameters), (2(n - 1), 3) uint32, from the twiddle
    constant c of ``decode_program(n)``: the byte offset (c >> 1) << 8 of
    the half-row pair that holds H[c] in ``decode_table()``, bit 0 of c in
    bit 7 of every byte (which half of the pair), and c·0x80 in every
    byte (the high-bit product)."""
    c = decode_program(n).astype(np.uint32)
    hi = decode_table()[256 * HALF_ROW:].astype(np.uint32)[c]
    entries = np.stack([(c >> 1) << 8, np.where(c & 1, 0x80808080, 0).astype(np.uint32),
                        hi * 0x01010101], axis=1).astype(np.uint32)
    entries.flags.writeable = False
    return entries


@functools.lru_cache(maxsize=1)
def decode_table() -> np.ndarray:
    """The decode kernel's one multiply table, (256·128 + 256,) uint8: the
    half rows H[c][y] = c·y for y < 128, row c at c·128, then the high-bit
    products c·0x80. c·y = H[c][y & 0x7F] ^ (c·0x80 if y & 0x80 else 0),
    since the multiply distributes over XOR. A half row is 32 words, one
    in each shared-memory bank."""
    mul = gf256.mul_table()
    table = np.concatenate([mul[:, :HALF_ROW].reshape(-1), mul[:, 0x80]]).astype(np.uint8)
    table.flags.writeable = False
    return table


@functools.lru_cache(maxsize=8)
@devledger.instrument_builder("rs.decode_bit_matrix")
def decode_bit_matrix(n: int) -> np.ndarray:
    """(8n, 8n) uint8 0/1 matrix of the decode core over GF(2), the decode
    counterpart of ``encode_bit_matrix`` (the JAX package's
    ``repair_tpu.decode_bit_matrix``)."""
    return expand_bit_matrix(gf256.decode_core_matrix(n))


@functools.lru_cache(maxsize=1)
def bitmul_table() -> np.ndarray:
    """(256, 8, 8) 0/1: BITMUL[c][r, q] = bit_r(c * x^q), the 8×8 GF(2)
    matrix of multiply-by-constant-c, bit lanes LSB-first."""
    consts = np.arange(256, dtype=np.uint8)[:, None]  # (256, 1) GF matrix
    return expand_bit_matrix(consts).reshape(256, 8, 8)


@dataclasses.dataclass(frozen=True)
class EncodeMatrix:
    """The encode of square size k on a device, in the forms the port reads.

    bits:      (8k, 8k) uint8 0/1 — M2, the plain version's operand.
    fft_rows:  (n_const, 256) uint8 — the FFT's product rows, n_const = k - 1.
    fft_group: (2(k - 1),) int16 — each butterfly group's row, -1 to skip.
    The last two are ``fft_program(k)``, read by kernels K1 and K4."""

    bits: torch.Tensor
    fft_rows: torch.Tensor
    fft_group: torch.Tensor

    @property
    def k(self) -> int:
        return self.bits.shape[0] // 8


def encode_matrix_from_numpy(m2: np.ndarray, device) -> EncodeMatrix:
    """The JAX package's M2 (``rs_tpu.encode_bit_matrix(k)``, a numpy
    (8k, 8k) 0/1 array) -> the port's EncodeMatrix on ``device``.

    The kernels compute the Leopard code through its FFT program, not
    through M2, so an M2 that is not Leopard's for its k is refused: the
    kernels and the plain version would compute different codes."""
    m2 = np.asarray(m2)
    if m2.ndim != 2 or m2.shape[0] != m2.shape[1] or m2.shape[0] % 8:
        raise ValueError(f"M2 must be (8k, 8k), got {m2.shape}")
    if not np.isin(m2, (0, 1)).all():
        raise ValueError("M2 must be a 0/1 matrix")
    k = m2.shape[0] // 8
    if k & (k - 1) or not np.array_equal(m2, encode_bit_matrix(k)):
        raise ValueError(f"M2 is not the Leopard encode's bit matrix for k = {k}")
    rows, group = fft_program(k)
    return EncodeMatrix(
        bits=torch.as_tensor(m2.astype(np.uint8), device=device),
        fft_rows=torch.tensor(rows, device=device),
        fft_group=torch.tensor(group, device=device),
    )


@functools.lru_cache(maxsize=16)
def _encode_matrix_cached(k: int, device: str) -> EncodeMatrix:
    return encode_matrix_from_numpy(encode_bit_matrix(k), device)


def encode_matrix(k: int, device: torch.device) -> EncodeMatrix:
    """The encode operands for square size k on ``device``, built once per
    (k, device)."""
    return _encode_matrix_cached(k, str(device))


@dataclasses.dataclass(frozen=True)
class DecodeOperands:
    """The decode core over n positions on a device, as the decode sweep
    kernel reads it (``csrc/rs_decode.cu``).

    table:    (256·128 + 256,) uint8 on the device — ``decode_table()``,
              the one table of every multiply (the butterflies' and the
              locator scale and unscale), shared by every n.
    twiddles: (2(n - 1), 3) uint32 on the host — ``decode_twiddles(n)``,
              passed by value as the kernel's parameters."""

    table: torch.Tensor
    twiddles: np.ndarray

    @property
    def n(self) -> int:
        return self.twiddles.shape[0] // 2 + 1


@functools.lru_cache(maxsize=4)
def _decode_table_cached(device: str) -> torch.Tensor:
    return torch.tensor(decode_table(), device=device)


@functools.lru_cache(maxsize=16)
def _decode_operands_cached(n: int, device: str) -> DecodeOperands:
    return DecodeOperands(_decode_table_cached(device), decode_twiddles(n))


def decode_operands(n: int, device: torch.device) -> DecodeOperands:
    """The decode kernel's operands for n positions on ``device``: the
    table once per device, the twiddle entries once per n."""
    return _decode_operands_cached(n, str(device))


@functools.lru_cache(maxsize=8)
def _decode_bits_cached(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(decode_bit_matrix(n), dtype=torch.float32, device=device),
            torch.tensor(bitmul_table(), dtype=torch.float32, device=device))


def decode_bits(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain decode sweep's operands on ``device``, built once per
    (n, device): ``decode_bit_matrix(n)`` and ``bitmul_table()`` as
    float32 0/1 tensors (the contractions run in float32, see
    ``rs_encode_rows``)."""
    return _decode_bits_cached(n, str(device))


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
