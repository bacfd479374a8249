"""GF(2^8) arithmetic and the Leopard-compatible Reed-Solomon encode (host numpy).

A copy of the JAX package's ops/gf256.py (encode and decode), kept so the
port imports nothing of celestia_tpu. The reference chain
(pkg/appconsts/global_consts.go:92 selects ``rsmt2d.NewLeoRSCodec``)
erasure-codes shares with an FFT-based Reed-Solomon code over GF(2^8) in the
Lin-Chung-Han novel polynomial basis with a Cantor basis — the "Leopard"
code. The code (the linear map data -> parity) is fully determined by the
field tables, the Cantor basis and the FFT skew schedule. This module is the
host reference and the source of the dense encode matrix that ops/rs.py
expands to a GF(2) bit matrix for the CUDA kernel. The decode half
(``leopard_decode_batch``: the error locator, the pattern-independent core
``_decode_core`` and its matrix ``decode_core_matrix``) serves the host
repair (da/repair.py) and the operands of the decode sweep (ops/rs.py
``decode_program``, ``decode_bit_matrix``).

Field: GF(2^8), polynomial 0x11D, Cantor basis {1,214,152,146,86,200,88,230}.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def _level_logs(n: int, dist: int, offset: int) -> np.ndarray:
    skew = fft_skew()
    r = np.arange(0, n, dist * 2)
    return skew[offset + r + dist - 1]


@functools.lru_cache(maxsize=1)
def _locator_matrix() -> np.ndarray:
    """The whole FWHT → diag(log_walsh) → FWHT chain as ONE matrix.

    The chain is linear over Z/255 (the unnormalized Walsh matrix H is
    symmetric and H·H = 256·I ≡ I mod 255 — the reason Leopard's trick
    needs no inverse-transform scaling), so
        locator(err) = err · H · diag(lw) · H  =  err · M
    with M = H·diag(lw)·H mod 255 precomputed once. Returned as float64
    so the hot path is a single BLAS dgemm: err is 0/1 with ≤ 256 ones
    and M entries < 255, so every dot product is < 2¹⁶ — exact in
    float64 (and ~10× faster than the two in-place FWHT passes)."""
    m = K_ORDER
    # H built level-wise (Walsh–Hadamard, symmetric, entries ±1)
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < m:
        h = np.block([[h, h], [h, -h]])
    lw = log_walsh().astype(np.int64) % K_MODULUS
    mat = (h * lw[None, :]) % K_MODULUS  # H · diag(lw)
    mat = (mat @ h) % K_MODULUS
    return mat.astype(np.float64)


@functools.lru_cache(maxsize=1)
def _locator_matrix_tensor() -> torch.Tensor:
    return torch.from_numpy(_locator_matrix())


def _error_locator_logs_batch(erased: np.ndarray) -> np.ndarray:
    """log of each axis's erasure-locator polynomial evaluated at every
    field point (Leopard's ErrorBitfield path), as one exact dgemm
    against the precomputed fused FWHT·diag·FWHT matrix.
    erased (A, n) 0/1 -> (A, K_ORDER) logs.

    The product runs through torch's CPU matmul, not numpy's: numpy's BLAS
    threads keep spinning after a call and slowed the pinned staging copy
    that follows a repair plan (``repair.stage_resident_repair``) from
    about 2 ms to about 100 ms at k = 128 (chip_smoke.py's
    ``repair_levers``). The sums are integers below 2^16, exact in
    float64 in any order, so the logs are the JAX package's."""
    a = erased.shape[0]
    err = torch.zeros((a, K_ORDER), dtype=torch.float64)
    err[:, : erased.shape[1]] = torch.from_numpy(np.asarray(erased, dtype=np.float64))
    out = (err @ _locator_matrix_tensor()).numpy()
    return out.astype(np.int64) % K_MODULUS


def _mul_bytes_batch(rows: np.ndarray, log_ms: np.ndarray) -> np.ndarray:
    """rows (A, R, ...) uint8, log_ms (A, R) or (R,): per-(batch, row)
    constant multiply via 256-entry LUT rows (log 255 -> zero row)."""
    _log, exp = _tables()
    log_ms = np.broadcast_to(log_ms, rows.shape[:2])
    consts = np.where(log_ms == K_MODULUS, 0, exp[log_ms]).astype(np.uint8)
    luts = mul_table()[consts]  # (A, R, 256)
    a_idx = np.arange(rows.shape[0]).reshape(-1, *((1,) * (rows.ndim - 1)))
    r_idx = np.arange(rows.shape[1]).reshape(1, -1, *((1,) * (rows.ndim - 2)))
    return luts[a_idx, r_idx, rows]


def _mul_shared(v_half: np.ndarray, log_ms: np.ndarray) -> np.ndarray:
    """Per-level twiddle multiply: twiddles are SHARED across the batch
    (they depend on (n, level) only), so the LUT is one (blocks, 256)
    table broadcast over the batch axis — not materialized per axis."""
    _l, exp = _tables()
    consts = np.where(log_ms == K_MODULUS, 0, exp[log_ms]).astype(np.uint8)
    luts = mul_table()[consts]  # (blocks, 256)
    b_idx = np.arange(len(log_ms)).reshape(1, -1, *((1,) * (v_half.ndim - 2)))
    return luts[b_idx, v_half]


def _decode_core(work: np.ndarray, n: int) -> None:
    """The erasure-pattern-INDEPENDENT middle of the Leopard decode,
    in place on work (A, >=n, ...): full-length IFFT, formal derivative,
    FFT. Everything pattern-dependent (locator scale/unscale) happens
    outside; this core is one fixed GF(256)-linear map per n, which is
    what lets ops/repair_cuda.py's plain version run it as one GF(2) bit
    matrix (``decode_core_matrix``), and its kernel as one butterfly
    program (``rs.decode_program``)."""
    a_count = work.shape[0]
    dist = 1
    while dist < n:
        log_ms = _level_logs(n, dist, 0)
        v = work[:, :n].reshape(a_count, -1, 2, dist, *work.shape[2:])
        v[:, :, 1] ^= v[:, :, 0]
        v[:, :, 0] ^= _mul_shared(v[:, :, 1], log_ms)
        dist *= 2
    for i in range(1, n):
        width = ((i ^ (i - 1)) + 1) >> 1
        work[:, i - width : i] ^= work[:, i : i + width]
    dist = n >> 1
    while dist >= 1:
        log_ms = _level_logs(n, dist, 0)
        v = work[:, :n].reshape(a_count, -1, 2, dist, *work.shape[2:])
        v[:, :, 0] ^= _mul_shared(v[:, :, 1], log_ms)
        v[:, :, 1] ^= v[:, :, 0]
        dist >>= 1


@functools.lru_cache(maxsize=8)
def decode_core_matrix(n: int) -> np.ndarray:
    """The (n, n) GF(256) matrix of _decode_core: out = T @ in per byte
    lane. Derived by pushing the identity through the core (same
    derivation style as encode_matrix)."""
    eye = np.eye(n, dtype=np.uint8)[None]  # (1, n, n): byte lane j = e_j
    work = eye.copy()
    _decode_core(work, n)
    return work[0].copy()


def leopard_decode_batch(
    cells: np.ndarray, present: np.ndarray, k: int
) -> np.ndarray:
    """Batched O(n log n) Leopard erasure decode.

    cells: (A, 2k, B) uint8 — A independent axes, each with positions
    [0, k) original data shards and [k, 2k) recovery (parity) shards from
    leopard_encode. present: (A, 2k) bool, each row with >= k present.
    Returns the repaired (A, 2k, B) array.

    Follows the published LCH/Leopard erasure-decode recipe: scale the
    received symbols by the error locator (evaluated via FWHT), full-
    length IFFT, formal derivative, FFT, then unscale at the erased
    positions. The transforms' twiddles depend only on (n, level), not on
    the erasure pattern, so ALL axes ride one vectorized butterfly
    sequence; only the locator scaling differs per axis. Codeword layout:
    recovery at FFT positions [0, m), original data at [m, 2m).
    """
    a_count = cells.shape[0]
    m = k
    n = 2 * k
    if (present.sum(axis=1) < k).any():
        raise ValueError("not enough shards to decode")
    if k == 1:
        out = np.array(cells, copy=True)
        need0 = ~present[:, 0]
        out[need0, 0] = cells[need0, 1]
        need1 = ~present[:, 1]
        out[need1, 1] = out[need1, 0]
        return out

    # erasure indicators in codeword order: [recovery(=parity) | original]
    erased = np.zeros((a_count, n), dtype=np.int64)
    erased[:, :m] = ~present[:, k:]
    erased[:, m:] = ~present[:, :k]
    loc = _error_locator_logs_batch(erased)

    codeword = np.concatenate([cells[:, k:], cells[:, :k]], axis=1)
    scale_logs = np.where(erased == 0, loc[:, :n], K_MODULUS)
    # the transforms and derivative never touch past row n (max formal-
    # derivative reach is i + width == n), so n rows suffice
    work = _mul_bytes_batch(codeword, scale_logs)

    _decode_core(work, n)

    unscale_logs = np.where(
        erased == 1, (K_MODULUS - loc[:, :n]) % K_MODULUS, K_MODULUS
    )
    recovered = _mul_bytes_batch(work[:, :n], unscale_logs)
    recovered = np.concatenate([recovered[:, m:], recovered[:, :m]], axis=1)
    out = np.array(cells, copy=True)
    out[~present] = recovered[~present]
    return out


def leopard_decode(
    cells: np.ndarray, present: np.ndarray, k: int
) -> np.ndarray:
    """Single-axis erasure decode (batch-of-1 leopard_decode_batch)."""
    return leopard_decode_batch(cells[None], present[None], k)[0]


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) matrix product: (n,m) @ (m,p) -> (n,p) uint8."""
    mul = mul_table()
    prod = mul[a[:, :, None], b[None, :, :]]  # (n, m, p)
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_inverse(a: np.ndarray) -> np.ndarray:
    """Invert a GF(256) matrix via Gauss-Jordan (vectorized row ops)."""
    n = a.shape[0]
    log, exp = _tables()
    mul = mul_table()
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = col + int(np.argmax(aug[col:, col] != 0))
        if aug[pivot, col] == 0:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        # scale pivot row to 1
        inv_log = (K_MODULUS - log[aug[col, col]]) % K_MODULUS
        scaled = exp[(log[aug[col]] + inv_log) % K_MODULUS]
        scaled[aug[col] == 0] = 0
        aug[col] = scaled
        # eliminate other rows
        factors = aug[:, col].copy()
        factors[col] = 0
        nonzero = factors != 0
        if nonzero.any():
            aug[nonzero] ^= mul[factors[nonzero][:, None], aug[col][None, :]]
    return aug[:, n:]


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
