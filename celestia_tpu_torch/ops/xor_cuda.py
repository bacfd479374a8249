"""Kernels K5 (XOR-schedule encode + NMT leaf hash) and K6 (XOR-schedule
encode), and the unfused XOR extend.

Counterpart of the Pallas half of the JAX package's ops/xor_schedule.py.
Source: ``csrc/xor_schedule.cu``, sharing ``csrc/sha256.cuh`` with K1.

K5 ``encode2d_xor_hash(x2, ops)`` replaces ``xor_schedule.encode2d_xor_hash``
(xor_schedule.py:537, ``pallas_call`` at :512): K1's output contract, the
(k, N) parity and the (k, N/512, 8) uint32 leaf digests under the parity
namespace, with the parity from the compiled XOR schedule. It is the quadrant
encode of the fused XOR route.

K6 ``encode2d_xor(x2, ops)`` replaces ``xor_schedule.encode2d_xor``
(xor_schedule.py:476, ``pallas_call`` at :465): K5 without the hash, the
quadrant encode of the unfused XOR route (``extend_square_xor``).

``ops`` is an ``XorOperands``: the schedule of ``xor_schedule.compile_schedule``
in the kernels' operand layout, made once per (k, device) by
``schedule_operands``. The int64 index tensors the plain versions gather
with are built on the operands' device at the first plain call, not beside
the kernel operands on every route.

What bounds them on the H100, at k = 128 (N = 65,536): the schedule has
242,496 two-input XORs per lane; with each output row assembled from
three-input XORs (LOP3) that is 123,520 operations, and bit-sliced 32 lanes
to a word 123,520 × N/32 = 2.5e8 int32 operations, 15 µs at ~16.7 T int32
op/s (64 INT32 lanes × 132 SMs × 1.98 GHz, an estimate from the SM layout).
K5 adds K1's 147,456 leaf SHA blocks (~19 µs); the bytes (16 MB for K6,
18 MB for K5) are ~5 µs at 3.35 TB/s. So both are bound by operations, and
the bounds are K4's and K1's (the same functions; ``ops/rs_cuda.py``). This
kernel uses two-input XORs. See ``csrc/xor_schedule.cu`` for the design.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import _cuda, rs, rs_cuda
from celestia_tpu_torch.ops import xor_schedule as xs

MAX_K = 128  # the plane store and the hash tile fit one block's shared memory
ROW_GROUP = 8  # plane indices per 16-byte row_blk vector


@dataclasses.dataclass(frozen=True)
class XorOperands:
    """One schedule on one device.

    node_ab:   (n_nodes,) int32, node i's operands a | b << 16.
    level_off: (n_levels + 1,) int32, level l is nodes [off[l], off[l+1]).
    row_blk:   (width8, 8k, 8) int16, row r's plane indices in groups of
               8, ZERO-padded: one 16-byte vector per group and row."""

    sched: xs.XorSchedule
    node_ab: torch.Tensor
    level_off: torch.Tensor
    row_blk: torch.Tensor

    @functools.cached_property
    def index(self) -> xs.ScheduleIndex:
        """The int64 index tensors the plain versions gather with, built
        at their first call."""
        return xs.schedule_index(self.sched, self.node_ab.device)


def operands_from_schedule(sched: xs.XorSchedule, device) -> XorOperands:
    """The kernel-operand layout of ``sched`` on ``device``. Plane indices
    are below 2^16 (at most 8k + 1 + 4,096), so they ride as 16-bit."""
    if sched.n_planes > 1 << 15:
        raise ValueError(f"{sched.n_planes} planes do not fit 16-bit indices")
    node_ab = sched.flat_a.astype(np.int64) | (sched.flat_b.astype(np.int64) << 16)
    level_off = np.concatenate([[0], np.cumsum(sched.level_widths, dtype=np.int64)])
    n_out, width = sched.row_idx.shape
    width8 = -(-width // ROW_GROUP)
    rows = np.full((n_out, width8 * ROW_GROUP), sched.zero, dtype=np.int16)
    rows[:, :width] = sched.row_idx
    row_blk = rows.reshape(n_out, width8, ROW_GROUP).transpose(1, 0, 2)
    return XorOperands(
        sched=sched,
        node_ab=torch.as_tensor(node_ab.astype(np.int32), device=device),
        level_off=torch.as_tensor(level_off.astype(np.int32), device=device),
        row_blk=torch.as_tensor(np.ascontiguousarray(row_blk), device=device),
    )


@functools.lru_cache(maxsize=16)
def _operands_cached(k: int, device: str) -> XorOperands:
    return operands_from_schedule(xs.compile_schedule(k), device)


def schedule_operands(k: int, device: torch.device) -> XorOperands:
    """The compiled schedule for square size k on ``device``, made once per
    (k, device): the index tensors are not copied to the card on each
    call."""
    return _operands_cached(k, str(device))


def encode2d_xor_reference(x2: torch.Tensor, ops: XorOperands) -> torch.Tensor:
    """Plain PyTorch version of K6: (k, N) parity through the schedule."""
    rs_cuda.check_lanes(x2)
    return xs.rs_encode_rows_xor(x2, ops.index)


def encode2d_xor_hash_reference(x2: torch.Tensor, ops: XorOperands):
    """Plain PyTorch version of K5: ((k, N) parity, (k, N/512, 8) digests)."""
    parity = encode2d_xor_reference(x2, ops)
    return parity, rs_cuda.parity_leaf_digests_plain(parity)


def _launch(name: str, x2: torch.Tensor, ops: XorOperands, *outs: torch.Tensor) -> None:
    rs_cuda.check_lanes(x2)
    k, n = x2.shape
    if k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    sched = ops.sched
    if sched.n_in != 8 * k:
        raise ValueError(f"the schedule is for k = {sched.n_in // 8}, x2 has k = {k}")
    dev = x2.device
    _cuda.require(x2, "x2", torch.uint8, (k, n), dev)
    _cuda.require(ops.node_ab, "node_ab", torch.int32, (sched.n_nodes,), dev)
    _cuda.require(ops.level_off, "level_off", torch.int32,
                  (len(sched.level_widths) + 1,), dev)
    width8 = ops.row_blk.shape[0]
    _cuda.require(ops.row_blk, "row_blk", torch.int16, (width8, 8 * k, ROW_GROUP), dev)
    rc = getattr(_cuda.library(), f"celestia_{name}")(
        x2.data_ptr(), ops.node_ab.data_ptr(), ops.level_off.data_ptr(),
        len(sched.level_widths), sched.n_nodes, ops.row_blk.data_ptr(), width8,
        *(o.data_ptr() for o in outs), k, n, dev.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1


def encode2d_xor(x2: torch.Tensor, ops: XorOperands) -> torch.Tensor:
    """XOR-schedule encode: (k, N) uint8 data shards -> (k, N) parity.

    A CPU tensor runs the plain version; a CUDA tensor launches K6."""
    if x2.device.type == "cpu":
        return encode2d_xor_reference(x2, ops)
    parity = torch.empty(tuple(x2.shape), dtype=torch.uint8, device=x2.device)
    _launch("encode2d_xor", x2, ops, parity)
    return parity


def encode2d_xor_hash(x2: torch.Tensor, ops: XorOperands):
    """XOR-schedule encode + NMT leaf hash: (k, N) uint8 data shards ->
    ((k, N) parity, (k, N/512, 8) uint32 leaf digest words), the output
    contract of ``rs_cuda.encode2d_hash``.

    A CPU tensor runs the plain version; a CUDA tensor launches K5."""
    if x2.device.type == "cpu":
        return encode2d_xor_hash_reference(x2, ops)
    k, n = x2.shape
    parity = torch.empty((k, n), dtype=torch.uint8, device=x2.device)
    digests = torch.empty((k, n // SHARE_SIZE, 8), dtype=torch.uint32, device=x2.device)
    _launch("encode2d_xor_hash", x2, ops, parity, digests)
    return parity, digests


def extend_square_xor(q0: torch.Tensor, ops: XorOperands,
                      encode=encode2d_xor) -> torch.Tensor:
    """(k, k, 512) -> EDS with every quadrant encode on K6 (the unfused XOR
    route); ``encode=encode2d_xor_reference`` runs the plain version on any
    device."""
    return rs.extend_quadrants(q0, lambda x: encode(x, ops))
