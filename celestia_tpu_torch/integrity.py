"""Silent-data-corruption defense for the port's extend path (port of the
JAX package's integrity.py).

Erasure-coded data checks itself: every row and column of a valid EDS
satisfies ``parity == encode(data)`` over GF(256). The audit re-encodes the
data halves of q seeded-random rows and q columns and counts the parity
bytes that differ; only that count crosses to the host.

Audit levels:

    off       the shared NOOP engine: the hot path pays one boolean check
    sampled   the device syndrome over q random rows and q random columns
    full      the syndrome over all 2k rows and columns, plus a host
              recompute of the whole square from its data quadrant

The device syndrome (the JAX package's ``_jitted_syndrome``, an XLA graph
there) re-encodes through K4, the port's encoder: the gathered rows' data
halves go to ``rs_cuda.encode_into`` as a strided view (a row extend's
shards are the row's cells, so the shard stride is one cell), the gathered
columns' as they lie, and aten ops compare the result with the stored parity
and count. On a CPU tensor K4's plain version does the same.

``record_sdc`` is the one place the ``sdc_detected_total`` counter is
bumped. Also here: the dependency-free CRC-32C (Castagnoli) the chunked
transfers verify at their sink, numpy-vectorised stripewise with a GF(2)
combine, checked against a bytewise reference and RFC 3720's vectors.
"""

from __future__ import annotations

import functools
import random
import threading
import time

import numpy as np
import torch

from celestia_tpu_torch import tracing
from celestia_tpu_torch.ops import gf256, rs, rs_cuda
from celestia_tpu_torch.telemetry import metrics


class IntegrityError(Exception):
    """Detected silent data corruption that survived the retry budget."""


# ---------------------------------------------------------------------- #
# CRC-32C (Castagnoli), software

_CRC32C_POLY = 0x82F63B78  # reflected


@functools.lru_cache(maxsize=1)
def _crc_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
        table[i] = c
    return table


def _crc32c_bytewise(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """Plain table-driven CRC (slow; the correctness oracle)."""
    table = _crc_table()
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = int(table[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# The register update is GF(2)-linear, so "advance past m zero bytes" is a
# 32x32 bit matrix, kept as 32 uint32 columns (the image of each basis bit).


def _op_apply(op: np.ndarray, regs: np.ndarray) -> np.ndarray:
    out = np.zeros_like(regs)
    for b in range(32):
        out ^= np.where((regs >> np.uint32(b)) & np.uint32(1), op[b], np.uint32(0))
    return out


@functools.lru_cache(maxsize=1)
def _op_one_byte() -> np.ndarray:
    """The advance-one-zero-byte operator."""
    table = _crc_table()
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return table[basis & np.uint32(0xFF)] ^ (basis >> np.uint32(8))


@functools.lru_cache(maxsize=128)
def _op_pow(nbytes: int) -> np.ndarray:
    """The advance-``nbytes``-zero-bytes operator, by square and multiply."""
    result = np.uint32(1) << np.arange(32, dtype=np.uint32)  # identity
    sq = _op_one_byte()
    e = nbytes
    while e:
        if e & 1:
            result = _op_apply(sq, result)
        e >>= 1
        if e:
            sq = _op_apply(sq, sq)
    return result


try:  # an optional native accelerator, byte-identical to the numpy path
    import google_crc32c as _native_crc32c
except ImportError:  # pragma: no cover - depends on the environment
    _native_crc32c = None


def crc32c_implementation() -> str:
    """Which CRC-32C ``crc32c`` runs: ``"google_crc32c"`` or ``"numpy"``."""
    return "numpy" if _native_crc32c is None else "google_crc32c"


def crc32c(data) -> int:
    """CRC-32C of bytes or of any numpy array's bytes.

    A native Castagnoli implementation (``google_crc32c``) when the
    environment already has it, else the numpy-vectorized path; both are
    held against the bytewise oracle. Nothing is installed for this."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    if _native_crc32c is not None:
        return int(_native_crc32c.value(buf.tobytes()))
    return _crc32c_vectorized(buf)


def _crc32c_vectorized(buf: np.ndarray) -> int:
    """Software CRC-32C over a flat uint8 array: W equal stripes (zero-padded
    at the front, a no-op for the init-0 register) run the bytewise
    recurrence at once, are folded pairwise with the advance-by-stripe
    operator, and the init term is added last."""
    n = buf.size
    if n < 4096:
        return _crc32c_bytewise(buf.tobytes())
    table = _crc_table()
    # stripes of at least 64 bytes; W a power of two for the pairwise fold
    width = min(1024, 1 << ((n // 64).bit_length() - 1))
    length = -(-n // width)
    padded = np.zeros(width * length, dtype=np.uint8)
    padded[-n:] = buf
    stripes = padded.reshape(width, length)
    regs = np.zeros(width, dtype=np.uint32)
    for i in range(length):
        regs = table[(regs ^ stripes[:, i]) & np.uint32(0xFF)] ^ (regs >> np.uint32(8))
    op = _op_pow(length)
    while regs.size > 1:
        regs = _op_apply(op, regs[0::2]) ^ regs[1::2]
        op = _op_apply(op, op)
    init_term = _op_apply(_op_pow(n), np.array([0xFFFFFFFF], dtype=np.uint32))
    return int(regs[0] ^ init_term[0]) ^ 0xFFFFFFFF


# ---------------------------------------------------------------------- #
# the GF(256) syndrome


def syndrome(eds: torch.Tensor, row_idx, col_idx,
             encode_into=rs_cuda.encode_into) -> torch.Tensor:
    """(2k, 2k, 512) square, q row and q column indices -> an int32 scalar
    tensor on the square's device: the parity bytes of those rows and
    columns that differ from a re-encode of their data halves.

    ``encode_into`` is K4's strided wrapper (``rs_cuda.encode_into``), or
    its plain version to hold the kernel against it on the card."""
    k = eds.shape[0] // 2
    m2 = rs.encode_matrix(k, eds.device)
    ri = torch.as_tensor(np.asarray(row_idx, dtype=np.int64), device=eds.device)
    ci = torch.as_tensor(np.asarray(col_idx, dtype=np.int64), device=eds.device)
    rows = eds.index_select(0, ri)  # (q, 2k, 512)
    cols = eds.index_select(1, ci)  # (2k, q, 512)
    # a row's shards are its cells: the rows' data halves as K4's (k, q, 512)
    # view, shard stride one cell, cell stride one row; columns lie as K4 reads
    pairs = ((rows[:, :k].transpose(0, 1), rows[:, k:].transpose(0, 1)),
             (cols[:k], cols[k:]))
    count = torch.zeros((), dtype=torch.int32, device=eds.device)
    for data, stored in pairs:
        pred = torch.empty(data.shape, dtype=torch.uint8, device=eds.device)
        encode_into(data, pred, m2)
        count += (pred != stored).sum(dtype=torch.int32)
    return count


def host_recompute_mismatch(eds_np: np.ndarray, k: int) -> int:
    """Recompute the whole square from its data quadrant on the host (the
    CPU oracle, ``da.extend_host``) and count the bytes that differ: the
    ``full``-level check."""
    from celestia_tpu_torch import da

    arr = np.asarray(eds_np, dtype=np.uint8)
    return int(np.count_nonzero(da.extend_host(arr[:k, :k]) != arr))


def host_eds_mismatch(eds_np: np.ndarray, k: int) -> int:
    """Host syndrome over every row and column (GF(256), numpy): for a
    square whose data quadrant is itself untrusted, so a corrupted data
    cell shows as an inconsistent axis."""
    arr = np.asarray(eds_np, dtype=np.uint8)
    w, s = 2 * k, arr.shape[-1]
    # every axis at once: leopard_encode treats each byte lane alone
    row_data = arr[:, :k].transpose(1, 0, 2).reshape(k, w * s)
    row_par = arr[:, k:].transpose(1, 0, 2).reshape(k, w * s)
    col_data = arr[:k].reshape(k, w * s)
    col_par = arr[k:].reshape(k, w * s)
    return (int(np.count_nonzero(gf256.leopard_encode(row_data) != row_par))
            + int(np.count_nonzero(gf256.leopard_encode(col_data) != col_par)))


# ---------------------------------------------------------------------- #
# the engine


def record_sdc(site: str) -> None:
    """Count one detected corruption, unlabeled and by site, and mark it in
    the flight recorder."""
    metrics.incr_counter("sdc_detected_total")
    metrics.incr_counter("sdc_detected_total", site=site)
    now = time.perf_counter()
    tracing.emit("integrity.sdc", now, now, site=site)


class IntegrityEngine:
    """A live audit policy (level ``sampled`` or ``full``). Thread-safe;
    the sampling rng is seeded, so a drill replays the same audits, with the
    same draws as the JAX package's engine. Audits report mismatch counts;
    callers decide."""

    enabled = True

    def __init__(self, level: str, q: int = 4, seed: int = 0):
        if level not in ("sampled", "full"):
            raise ValueError(f"audit level {level!r}: one of off/sampled/full")
        self.level = level
        self.q = max(1, int(q))
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self.audits = 0
        self.detections = 0

    def audit_device_eds(self, eds_dev: torch.Tensor, k: int, *, where: str) -> int:
        """The syndrome of a (2k, 2k, 512) square on its device; at ``full``
        also the host recompute. Returns the mismatch count (0 = clean)."""
        q = 2 * k if self.level == "full" else min(self.q, 2 * k)
        with self._lock:
            self.audits += 1
            row_idx = np.asarray(self.rng.sample(range(2 * k), q), dtype=np.int32)
            col_idx = np.asarray(self.rng.sample(range(2 * k), q), dtype=np.int32)
        start = time.perf_counter()
        with tracing.span("integrity.audit", where=where, level=self.level, k=k, q=q):
            mism = int(syndrome(eds_dev, row_idx, col_idx))
            if self.level == "full":
                mism += host_recompute_mismatch(eds_dev.cpu().numpy(), k)
        metrics.measure_since("integrity_audit", start, where=where, level=self.level)
        if mism:
            with self._lock:
                self.detections += 1
        return mism

    def audit_host_eds(self, eds_np: np.ndarray, k: int, *, where: str = "host") -> int:
        """Host audit of a square in host memory: q rows and q columns at
        ``sampled``, every axis at ``full``."""
        arr = np.asarray(eds_np, dtype=np.uint8)
        start = time.perf_counter()
        with tracing.span("integrity.audit", where=where, level=self.level, k=k):
            if self.level == "full":
                mism = host_eds_mismatch(arr, k)
            else:
                q = min(self.q, 2 * k)
                with self._lock:
                    self.audits += 1
                    rows = self.rng.sample(range(2 * k), q)
                    cols = self.rng.sample(range(2 * k), q)
                mism = 0
                for i in rows:
                    mism += int(np.count_nonzero(gf256.leopard_encode(arr[i, :k]) != arr[i, k:]))
                for j in cols:
                    mism += int(np.count_nonzero(gf256.leopard_encode(arr[:k, j]) != arr[k:, j]))
        metrics.measure_since("integrity_audit", start, where=where, level=self.level)
        if mism:
            with self._lock:
                self.detections += 1
        return mism

    def sample_chunks(self, n: int) -> frozenset[int]:
        """Which of n transfer chunks to verify at the sink: all at
        ``full``, q seeded-random ones at ``sampled``."""
        if n <= 0:
            return frozenset()
        if self.level == "full" or n <= self.q:
            return frozenset(range(n))
        with self._lock:
            return frozenset(self.rng.sample(range(n), self.q))


def audit_or_raise(eng, eds_dev: torch.Tensor, k: int, *, site: str, where: str) -> None:
    """Audit a square just produced on the device and raise IntegrityError
    on any mismatch, with the corrupted square (host bytes) as evidence
    (``.eds``, ``.k``, ``.site``, ``.where``, ``.mismatches``)."""
    mism = eng.audit_device_eds(eds_dev, k, where=where)
    if not mism:
        return
    record_sdc(site)
    err = IntegrityError(f"integrity audit failed at {where}: {mism} mismatching "
                         f"parity cells (k={k})")
    err.site = site
    err.where = where
    err.mismatches = mism
    err.k = k
    err.eds = eds_dev.cpu().numpy()
    raise err


class _NoopEngine:
    """Audits off: one shared stateless object that answers 'clean'."""

    enabled = False
    level = "off"
    q = 0
    audits = 0
    detections = 0

    def audit_device_eds(self, eds_dev, k, *, where):
        return 0

    def audit_host_eds(self, eds_np, k, *, where="host"):
        return 0

    def sample_chunks(self, n):
        return frozenset()


NOOP = _NoopEngine()
_engine = NOOP

LEVELS = ("off", "sampled", "full")


def configure(level: str | None = "off", q: int = 4, seed: int = 0):
    """Install the process-global audit policy and return it; ``off`` or
    None puts the shared NOOP back."""
    global _engine
    if level in (None, "off"):
        _engine = NOOP
    else:
        _engine = IntegrityEngine(level, q=q, seed=seed)
    return _engine


def get():
    """The process-global engine (the NOOP object when audits are off)."""
    return _engine
