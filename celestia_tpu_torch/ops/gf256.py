"""GF(2^8) arithmetic and the Leopard-compatible Reed-Solomon encode (host numpy).

A copy of the encode side of the JAX package's ops/gf256.py, kept so the
port imports nothing of celestia_tpu. The reference chain
(pkg/appconsts/global_consts.go:92 selects ``rsmt2d.NewLeoRSCodec``)
erasure-codes shares with an FFT-based Reed-Solomon code over GF(2^8) in the
Lin-Chung-Han novel polynomial basis with a Cantor basis — the "Leopard"
code. The code (the linear map data -> parity) is fully determined by the
field tables, the Cantor basis and the FFT skew schedule. This module is the
host reference and the source of the dense encode matrix that ops/rs.py
expands to a GF(2) bit matrix for the CUDA kernel. Decode is not here yet.

Field: GF(2^8), polynomial 0x11D, Cantor basis {1,214,152,146,86,200,88,230}.
"""

from __future__ import annotations

import functools

import numpy as np

K_BITS = 8
K_ORDER = 256
K_MODULUS = 255
K_POLYNOMIAL = 0x11D
K_CANTOR_BASIS = (1, 214, 152, 146, 86, 200, 88, 230)


def _add_mod(a: int, b: int) -> int:
    """(a + b) mod 255 with end-around carry, matching ffe_t semantics."""
    s = a + b
    return (s + (s >> K_BITS)) & 0xFF


@functools.lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """Build (LOG, EXP): discrete log/exp of the field *after* the change of
    basis to the Cantor basis, so that FFT twiddle arithmetic works in the
    log domain. LOG[0] = 255 (sentinel)."""
    exp = np.zeros(K_ORDER, dtype=np.int64)
    log = np.zeros(K_ORDER, dtype=np.int64)

    # LFSR pass: exp temporarily holds the discrete log w.r.t. generator x.
    state = 1
    for i in range(K_MODULUS):
        exp[state] = i
        state <<= 1
        if state >= K_ORDER:
            state ^= K_POLYNOMIAL
    exp[0] = K_MODULUS

    # Cantor-basis conversion: log[i] = field element whose coordinates in
    # the Cantor basis are the bits of i; then compose with the LFSR log.
    log[0] = 0
    for i in range(K_BITS):
        basis = K_CANTOR_BASIS[i]
        width = 1 << i
        for j in range(width):
            log[j + width] = log[j] ^ basis
    for i in range(K_ORDER):
        log[i] = exp[log[i]]
    for i in range(K_ORDER):
        exp[log[i]] = i
    exp[K_MODULUS] = exp[0]
    return log, exp


def log_table() -> np.ndarray:
    return _tables()[0]


def exp_table() -> np.ndarray:
    return _tables()[1]


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table MUL[a, b] in the Cantor-basis field."""
    log, exp = _tables()
    la, lb = np.meshgrid(log, log, indexing="ij")
    s = la + lb
    s = (s + (s >> K_BITS)) & 0xFF
    m = exp[s]
    m[0, :] = 0
    m[:, 0] = 0
    return m.astype(np.uint8)


def mul(a: int, b: int) -> int:
    return int(mul_table()[a, b])


def mul_log(a: int, log_b: int) -> int:
    """a * exp(log_b); 0 if a == 0."""
    if a == 0:
        return 0
    log, exp = _tables()
    return int(exp[_add_mod(int(log[a]), log_b)])


@functools.lru_cache(maxsize=1)
def fft_skew() -> np.ndarray:
    """The Leopard FFT skew schedule, in the log domain.

    skew[j] is the twiddle (as a discrete log; 255 means "multiply by 0",
    i.e. the butterfly degenerates to a plain XOR) used by the additive-FFT
    butterflies. Built exactly per the LCH subspace-polynomial recursion.
    """
    log, _ = _tables()
    skew = np.zeros(K_ORDER, dtype=np.int64)  # field elements during build
    temp = [0] * (K_BITS - 1)
    for i in range(1, K_BITS):
        temp[i - 1] = 1 << i

    for m in range(K_BITS - 1):
        step = 1 << (m + 1)
        skew[(1 << m) - 1] = 0
        for i in range(m, K_BITS - 1):
            s = 1 << (i + 1)
            j = (1 << m) - 1
            while j < s:
                skew[j + s] = skew[j] ^ temp[i]
                j += step
        # temp[m] becomes log(1 / (temp[m] * (temp[m]+1)))
        temp_m = K_MODULUS - log[mul_log(temp[m], int(log[temp[m] ^ 1]))]
        for i in range(m + 1, K_BITS - 1):
            s = _add_mod(int(log[temp[i] ^ 1]), temp_m)
            temp[i] = mul_log(temp[i], s)
        temp[m] = temp_m

    return log[skew]


@functools.lru_cache(maxsize=1)
def log_walsh() -> np.ndarray:
    """FWHT of the log table — the decoder's error-locator helper."""
    lw = log_table().copy()
    lw[0] = 0
    _fwht(lw, K_ORDER)
    return lw


def _fwht(data: np.ndarray, m: int) -> None:
    """In-place fast Walsh-Hadamard transform over Z/255 (mod-255 add/sub),
    through the batched form (slice-views keep the mutation in place)."""
    _fwht_batch(data[:m][None])


def _mul_bytes(y: np.ndarray, log_m: int) -> np.ndarray:
    """Multiply every byte of y by exp(log_m) (vectorized table lookup)."""
    log, exp = _tables()
    ly = log[y]
    s = ly + log_m
    s = (s + (s >> K_BITS)) & 0xFF
    out = exp[s].astype(np.uint8)
    out[y == 0] = 0
    return out


def leopard_encode(data: np.ndarray) -> np.ndarray:
    """Leopard RS encode: k data shards -> k parity shards.

    data: uint8 array of shape (k, shard_size); k must be a power of two
    (always true for Celestia squares). Returns parity of the same shape.

    Matches ``reedsolomon.New(k, k, WithLeopardGF(true)).Encode`` as invoked
    by rsmt2d's LeoRSCodec (the reference codec at
    pkg/appconsts/global_consts.go:92): work = IFFT_skew(data) at offset m,
    parity = FFT_skew(work) at offset 0. Since dataShards == parityShards ==
    k and k is a power of two, m == k and the multi-chunk accumulation path
    never triggers.
    """
    k = data.shape[0]
    if k & (k - 1):
        raise ValueError("k must be a power of two")
    if k == 1:
        # m=1: both transforms are identity; parity equals the data shard.
        return data.copy()

    skew = fft_skew()
    m = k
    work = data.astype(np.uint8).copy()

    # IFFT (decimation in time, dist 1 -> m/2), skew offset m-1.
    dist = 1
    while dist < m:
        for r in range(0, m, dist * 2):
            log_m = int(skew[m - 1 + r + dist])
            x = work[r : r + dist]
            y = work[r + dist : r + 2 * dist]
            y ^= x
            if log_m != K_MODULUS:
                x ^= _mul_bytes(y, log_m)
        dist *= 2

    # FFT (dist m/2 -> 1), skew offset 0 (index r + dist - 1).
    dist = m >> 1
    while dist >= 1:
        for r in range(0, m, dist * 2):
            log_m = int(skew[r + dist - 1])
            x = work[r : r + dist]
            y = work[r + dist : r + 2 * dist]
            if log_m != K_MODULUS:
                x ^= _mul_bytes(y, log_m)
            y ^= x
        dist >>= 1

    return work


def _fwht_batch(data: np.ndarray) -> None:
    """In-place FWHT over the LAST axis of (A, m), vectorized per level.

    The mod-255 reduction happens once at the end: the transform is linear,
    so deferring the mod is exact, and inputs are canonical (< 255), so
    after log2(m) <= 8 add/sub levels |value| <= 255·2^8, far inside int64.
    Output is canonical [0, 255)."""
    m = data.shape[-1]
    dist = 1
    while dist < m:
        v = data.reshape(data.shape[0], -1, 2, dist)
        a = v[:, :, 0].copy()
        b = v[:, :, 1]
        v[:, :, 0] = a + b
        v[:, :, 1] = a - b
        dist *= 2
    data %= K_MODULUS


@functools.lru_cache(maxsize=16)
def encode_matrix(k: int) -> np.ndarray:
    """The dense k×k GF(2^8) encode matrix M with parity_j = Σ_i M[j,i]·data_i.

    Derived by encoding unit vectors through ``leopard_encode``: with
    data[i, p] = δ(i==p)·1, byte position p sees the unit vector e_p, so
    parity[j, p] = M[j, p]. This matrix *is* the code; the CUDA path
    consumes its GF(2) expansion.
    """
    eye = np.eye(k, dtype=np.uint8)
    return leopard_encode(eye)
