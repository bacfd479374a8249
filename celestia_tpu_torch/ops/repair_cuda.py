"""The decode sweep of EDS repair: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``repair_tpu._sweep_device``
(celestia_tpu/ops/repair_tpu.py:124), an XLA graph, not a Pallas kernel.
Source: ``csrc/rs_decode.cu``.

One sweep decodes every axis of one orientation of a (2k, 2k, 512) EDS at
once, as planned by ``ops/repair.plan_sweeps`` from the presence mask: per
axis and byte lane, scale each codeword position by the axis's locator
constant (0 at an erased position), run the decode core (IFFT, formal
derivative, FFT over n = 2k positions: ``gf256._decode_core``, one fixed
GF(256)-linear map per n), unscale, and write the cells the plan marks.
Positions are in the code's order [parity | data]: position p is cell
(p + k) mod 2k.

``sweep`` writes in place in the EDS: a row sweep reads and writes the
rows, a column sweep the columns, through an axis stride and a cell
stride, with no transposed copy. Only the marked cells change.

The kernel runs the core as a butterfly program (``rs.decode_program``,
each group's twiddle constant), every multiply (the butterflies' and the
locator scale and unscale) a byte lookup in one table of half rows
(``rs.decode_table``: c·y = H[c][y & 0x7F] ^ (bit 7 of y)·c·0x80), which
a persistent grid stages in shared memory once per resident block; the
twiddles' multiply entries (``rs.decode_twiddles``) go by value in the
kernel's parameters. The plain version ``sweep_reference`` is the JAX package's own spelling: the
bits of every cell, an 8×8 GF(2) block per position for the scale and
unscale (gathered from ``rs.bitmul_table``), and one (8n × 8n) GF(2)
contraction with ``rs.decode_bit_matrix(n)`` in float32 (0/1 operands and
at most 2,048 terms: exact), then ``& 1``. The two are different
algorithms for one linear map, so their agreement on the card means
something.

What bounds the kernel at k = 128 (256 axes × 512 lanes): operations, the
core's 1,538 multiply butterflies and 510 plain ones per lane beside the
scale and unscale multiplies (``chip_smoke.py`` counts them from
``decode_program(256)``); the 32 MiB EDS it reads once is 0.010 ms at
3.35 TB/s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import _cuda, rs


@dataclasses.dataclass(frozen=True)
class StagedSweep:
    """One planned sweep on the device, as the kernel reads it.

    transpose: False for a row sweep (rows are the axes), True for a
               column sweep.
    consts:    (3, w, n) uint8 — the scale bytes and the unscale bytes per
               (axis, position) in codeword order, then the write mask per
               (axis, cell) in cell order (``SweepPlan``'s three arrays)."""

    transpose: bool
    consts: torch.Tensor


def _axes_view(eds: torch.Tensor, plan: StagedSweep) -> torch.Tensor:
    return eds.transpose(0, 1) if plan.transpose else eds


def _check(eds: torch.Tensor, plan: StagedSweep) -> int:
    """The square and the plan agree; returns k."""
    w = eds.shape[0]
    if (eds.dim() != 3 or tuple(eds.shape) != (w, w, SHARE_SIZE) or w < 2 or w & (w - 1)
            or eds.dtype != torch.uint8):
        raise ValueError(f"eds must be uint8 (2k, 2k, {SHARE_SIZE}), got "
                         f"{eds.dtype} {tuple(eds.shape)}")
    if (plan.consts.dtype != torch.uint8 or tuple(plan.consts.shape) != (3, w, w)
            or plan.consts.device != eds.device):
        raise ValueError(f"the plan's consts must be uint8 (3, {w}, {w}) on {eds.device}, "
                         f"got {plan.consts.dtype} {tuple(plan.consts.shape)} on "
                         f"{plan.consts.device}")
    return w // 2


def sweep_reference(eds: torch.Tensor, plan: StagedSweep, chunks: int | None = None) -> None:
    """Plain PyTorch version of the decode sweep, in place in ``eds``: the
    JAX package's bit-matrix spelling (``repair_tpu._sweep_device``), the
    axes in ``chunks`` groups; by default the JAX package's rule, 4 at
    w >= 256 (it bounds the contraction's working set), else 1."""
    k = _check(eds, plan)
    w = n = 2 * k
    b = eds.shape[2]
    view = _axes_view(eds, plan)
    t2, bitmul = rs.decode_bits(n, eds.device)
    scale = bitmul[plan.consts[0].long()]  # (w, n, 8, 8)
    unscale = bitmul[plan.consts[1].long()]
    write = plan.consts[2].bool()
    codeword = torch.cat([view[:, k:], view[:, :k]], dim=1)  # [parity | data]
    recovered = torch.empty_like(codeword)
    step = w // (chunks or (4 if w >= 256 else 1))
    for lo in range(0, w, step):
        hi = lo + step
        bits = rs.unpack_bits(codeword[lo:hi]).to(torch.float32).view(-1, n, 8, b)
        # per-position 8×8 locator scale: out_r = Σ_c S[r, c]·bit_c
        scaled = (torch.matmul(scale[lo:hi], bits).to(torch.int32) & 1).to(torch.float32)
        # the shared decode core: one (8n, 8n) GF(2) contraction per axis
        y = (torch.matmul(t2, scaled.view(-1, 8 * n, b)).to(torch.int32) & 1).to(torch.float32)
        out = torch.matmul(unscale[lo:hi], y.view(-1, n, 8, b)).to(torch.int32) & 1
        recovered[lo:hi] = rs.pack_bits(out.view(-1, 8 * n, b))
    recovered = torch.cat([recovered[:, k:], recovered[:, :k]], dim=1)  # cell order
    view[write] = recovered[write]


def sweep(eds: torch.Tensor, plan: StagedSweep) -> None:
    """One planned decode sweep in place in the (2k, 2k, 512) ``eds``:
    every cell the plan's write mask marks gets its decoded bytes; no other
    byte changes.

    A CPU tensor runs the plain version; a CUDA tensor launches the decode
    sweep kernel."""
    if eds.device.type == "cpu":
        sweep_reference(eds, plan)
        return
    k = _check(eds, plan)
    n = 2 * k
    if not eds.is_contiguous() or eds.data_ptr() % 16:
        raise ValueError("eds must be contiguous and 16-byte aligned")
    _cuda.require(plan.consts, "plan.consts", torch.uint8, (3, n, n), eds.device)
    ops = rs.decode_operands(n, eds.device)
    _cuda.require(ops.table, "table", torch.uint8, (rs.decode_table().size,), eds.device)
    if ops.twiddles.shape != (2 * (n - 1), 3) or ops.twiddles.dtype != np.uint32:
        raise ValueError(f"twiddles must be uint32 ({2 * (n - 1)}, 3), got "
                         f"{ops.twiddles.dtype} {ops.twiddles.shape}")
    view = _axes_view(eds, plan)
    rc = _cuda.library().celestia_decode_sweep(
        eds.data_ptr(), view.stride(0), view.stride(1), plan.consts.data_ptr(), n,
        ops.table.data_ptr(), ops.twiddles.ctypes.data, n, eds.device.index or 0,
        _cuda.stream_of(eds))
    _cuda.check(rc, "decode_sweep")
    _cuda.LAUNCHES["decode_sweep"] += 1
