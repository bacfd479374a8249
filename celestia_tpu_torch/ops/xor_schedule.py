"""XOR-schedule compile pass and plain evaluators (port of ops/xor_schedule.py).

The Leopard encode is the GF(2) product parity_bits = M2 @ data_bits
(ops/rs.py). M2 is about half zeros and its parity rows share many common
pairs, so the product can instead be spelled as a straight-line program of
bit-plane XORs in which pairs shared across rows are computed once (greedy
pair counting, the Paar construction; ADR-024 of the JAX package).

This module holds the host half of that spelling:

- ``compile_schedule(k)`` lowers ``rs.encode_bit_matrix(k)`` into an
  ``XorSchedule``, once per k. It is a numpy copy of the JAX package's
  compiler: ``np.argmax`` tie-breaking decides the node order, so the
  schedule arrays equal the JAX package's exactly, not only in the parity
  they give.
- ``apply_planes_np`` evaluates a schedule in numpy (tests).
- ``apply_planes`` and ``rs_encode_rows_xor`` are the plain PyTorch
  evaluators: the reference the CUDA kernels K5 and K6 (``ops/xor_cuda.py``)
  are held against, and (``apply_planes``) each mesh shard's column-block
  partial (``compile_col_block``, ``sharded_schedule_arrays``).

Schedule format: planes are indexed inputs [0, n_in), a constant zero plane
at n_in (the pad target), then the CSE nodes in topological level order.
``flat_a``/``flat_b`` hold each node's two operand indices and
``level_widths`` the split into levels whose members are independent. Output
row r is the XOR of planes[row_idx[r, :]], ZERO-padded to a common width.
Input plane q = 8·shard + bit (LSB first), output row r = 8·shard + bit, the
layout of ``rs.unpack_bits``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from celestia_tpu_torch import devledger
from celestia_tpu_torch.ops import rs

# CSE node budget per compile: diminishing returns set in well before
# 4·(8k) nodes, and the budget bounds both compile time (O(cols) per node)
# and the pair-count workspace ((cols+budget)^2 int32).
_MAX_NODES_FACTOR = 4
_MAX_NODES_CAP = 4096
# a pair must appear in at least this many rows to be worth a node (count c
# saves c-1 XORs; 2 is the break-even the Paar greedy uses)
_MIN_PAIR_COUNT = 2


@dataclasses.dataclass(frozen=True, eq=False)
class XorSchedule:
    """A compiled straight-line XOR program over bit-planes.

    Plane index space: [0, n_in) inputs, n_in the constant zero plane, then
    n_nodes CSE nodes appended level by level. Node t computes
    planes[flat_a[t]] ^ planes[flat_b[t]]; ``level_widths`` splits the flat
    node list into topological levels whose members are mutually
    independent (operands always come from earlier levels). Output row r is
    the XOR of planes[row_idx[r, :]] (ZERO-padded to the common width)."""

    n_in: int
    n_out: int
    level_widths: tuple[int, ...]
    flat_a: np.ndarray  # (n_nodes,) int32 operand indices
    flat_b: np.ndarray  # (n_nodes,) int32
    row_idx: np.ndarray  # (n_out, width) int32, ZERO-padded
    n_nodes: int
    xor_ops: int  # scheduled XORs: n_nodes + sum(row nnz - 1)
    cse_hits: int  # row substitutions the hoisted nodes serve
    dense_ops: int  # popcount(m2) - n_out: the naive per-row XOR count

    @property
    def zero(self) -> int:
        return self.n_in

    @property
    def n_planes(self) -> int:
        """Inputs, the zero plane and the nodes."""
        return self.n_in + 1 + self.n_nodes


def _greedy_pair_cse(m2: np.ndarray, max_nodes: int):
    """Greedy pair-counting CSE (Paar): repeatedly hoist the operand pair
    co-occurring in the most rows into a fresh node.

    The pair-count matrix is maintained incrementally — hoisting (i, j) into
    node n only changes counts involving i, j, n, an O(cols) update — and
    the argmax rides lazily refreshed per-column upper bounds, so each node
    costs O(cols) instead of O(cols^2).

    Returns (nodes, rows, cse_hits): nodes as (a, b) pairs in creation order
    (node t lives at column n_in + t), rows as per-output index lists over
    the extended column space."""
    n_out, n_in = m2.shape
    cap = n_in + max_nodes
    m = np.zeros((n_out, cap), dtype=bool)
    m[:, :n_in] = m2 != 0
    cnt = np.zeros((cap, cap), dtype=np.int32)
    act = m[:, :n_in].astype(np.int32)
    cnt[:n_in, :n_in] = act.T @ act
    np.fill_diagonal(cnt, 0)
    colmax = cnt.max(axis=1)
    nodes: list[tuple[int, int]] = []
    cse_hits = 0
    while len(nodes) < max_nodes:
        # lazy argmax: colmax rows only ever go stale HIGH (decrements to
        # cnt[x, i/j] are not propagated), so refreshing the current winner
        # until its bound is exact finds the true maximum
        while True:
            i = int(np.argmax(colmax))
            j = int(np.argmax(cnt[i]))
            v = int(cnt[i, j])
            if v >= colmax[i]:
                break
            colmax[i] = v
        if v < _MIN_PAIR_COUNT:
            break
        n = n_in + len(nodes)
        rows = np.nonzero(m[:, i] & m[:, j])[0]
        s0 = m[rows].sum(axis=0).astype(np.int32)  # per-col count over rows
        m[rows, i] = False
        m[rows, j] = False
        m[rows, n] = True
        # count deltas: removing i (and j) from `rows` drops s0[x]
        # co-occurrences for every column x; adding n gains them (with i, j
        # gone). The {i, j, n} cross entries are exactly zero after the
        # substitution (no row keeps i or j alongside n).
        s1 = s0.copy()
        s1[i] = 0
        s1[j] = 0
        for c, delta in ((i, -s0), (j, -s0), (n, s1)):
            cnt[c, :] += delta
            cnt[:, c] += delta
        for a in (i, j, n):
            for b in (i, j, n):
                cnt[a, b] = 0
        colmax = np.maximum(colmax, cnt[:, n])
        for c in (i, j, n):
            colmax[c] = cnt[c].max()
        nodes.append((int(i), int(j)))
        cse_hits += len(rows)
    ncols = n_in + len(nodes)
    out_rows = [np.nonzero(m[r, :ncols])[0] for r in range(n_out)]
    return nodes, out_rows, cse_hits


def _compile_from_matrix(m2: np.ndarray) -> XorSchedule:
    """Lower a 0/1 matrix (parity = m2 @ bits mod 2) into an XorSchedule."""
    m2 = np.asarray(m2, dtype=np.uint8)
    n_out, n_in = m2.shape
    max_nodes = min(_MAX_NODES_FACTOR * n_in, _MAX_NODES_CAP)
    nodes, rows, cse_hits = _greedy_pair_cse(m2, max_nodes)

    # topological levels: node depth = 1 + max(operand depths); inputs (and
    # the zero plane) are depth 0. Creation order already respects
    # dependencies, so one forward pass assigns depths.
    depth = np.zeros(n_in + len(nodes), dtype=np.int32)
    for t, (a, b) in enumerate(nodes):
        depth[n_in + t] = 1 + max(depth[a], depth[b])
    n_levels = int(depth.max()) if len(nodes) else 0
    by_level: list[list[int]] = [[] for _ in range(n_levels)]
    for t in range(len(nodes)):
        by_level[depth[n_in + t] - 1].append(t)

    # reindex into the evaluation layout: inputs, ZERO at n_in, then nodes
    # level by level (creation order within a level)
    zero = n_in
    remap = np.zeros(n_in + len(nodes), dtype=np.int32)
    remap[:n_in] = np.arange(n_in)
    pos = n_in + 1
    for lvl in by_level:
        for t in lvl:
            remap[n_in + t] = pos
            pos += 1
    flat_a = np.array([remap[nodes[t][0]] for lvl in by_level for t in lvl],
                      dtype=np.int32)
    flat_b = np.array([remap[nodes[t][1]] for lvl in by_level for t in lvl],
                      dtype=np.int32)
    level_widths = tuple(len(lvl) for lvl in by_level)

    width = max((len(r) for r in rows), default=1) or 1
    row_idx = np.full((n_out, width), zero, dtype=np.int32)
    for r, cols in enumerate(rows):
        row_idx[r, : len(cols)] = remap[cols]

    return XorSchedule(
        n_in=n_in,
        n_out=n_out,
        level_widths=level_widths,
        flat_a=flat_a,
        flat_b=flat_b,
        row_idx=row_idx,
        n_nodes=len(nodes),
        xor_ops=len(nodes) + int(sum(max(len(r) - 1, 0) for r in rows)),
        cse_hits=cse_hits,
        dense_ops=int(m2.sum()) - n_out,
    )


def supported(k: int) -> bool:
    """The compiler covers every power-of-two k the Leopard matrix exists
    for."""
    return 1 <= k <= 256 and (k & (k - 1)) == 0


@functools.lru_cache(maxsize=16)
@devledger.instrument_builder("xor.compile_schedule")
def compile_schedule(k: int) -> XorSchedule:
    """The schedule of the full (8k, 8k) encode matrix, compiled once per
    process and k. It is host time at first use, seconds at k = 128
    (``chip_smoke.py`` prints it), timed by the device ledger as the
    ``xor.compile_schedule`` build."""
    return _compile_from_matrix(rs.encode_bit_matrix(k))


@functools.lru_cache(maxsize=64)
def compile_col_block(k: int, sp: int, idx: int) -> XorSchedule:
    """The schedule of shard ``idx`` of a row-sharded mesh (``parallel``):
    the (8k, 8k/sp) column block of the encode matrix that contracts
    against the 8k/sp bit-planes of the rows this shard holds. The shards'
    partial parities combine by XOR (GF(2) addition)."""
    m2 = rs.encode_bit_matrix(k)
    cols = (8 * k) // sp
    return _compile_from_matrix(m2[:, idx * cols: (idx + 1) * cols])


@functools.lru_cache(maxsize=16)
def sharded_schedule_arrays(k: int, sp: int):
    """The sp column-block schedules stacked into arrays of one shape, equal
    to the JAX package's: each level's width and the row width are padded
    to the widest shard's (a pad node computes ZERO ^ ZERO, a pad row slot
    reads ZERO; neither changes a byte). Returns (template, flat_a, flat_b,
    row_idx): flat_a and flat_b (sp, sum(level_widths)) and row_idx
    (sp, 8k, width) int32, and a template ``XorSchedule`` holding the padded
    level structure, which ``apply_planes`` reads with one shard's arrays."""
    scheds = [compile_col_block(k, sp, i) for i in range(sp)]
    n_in = scheds[0].n_in
    zero = n_in
    n_levels = max(len(s.level_widths) for s in scheds)
    widths = tuple(
        max((s.level_widths[lv] if lv < len(s.level_widths) else 0) for s in scheds)
        for lv in range(n_levels))
    total = sum(widths)
    flat_a = np.full((sp, total), zero, dtype=np.int32)
    flat_b = np.full((sp, total), zero, dtype=np.int32)
    row_w = max(s.row_idx.shape[1] for s in scheds)
    row_idx = np.full((sp, scheds[0].n_out, row_w), zero, dtype=np.int32)
    for i, s in enumerate(scheds):
        # node indices shift where levels are padded: map this shard's layout
        # (n_in + 1, then its own level offsets) into the padded one
        remap = np.arange(n_in + 1 + s.n_nodes, dtype=np.int32)
        src = dst = n_in + 1
        for lv, w_pad in enumerate(widths):
            w = s.level_widths[lv] if lv < len(s.level_widths) else 0
            remap[src: src + w] = np.arange(dst, dst + w, dtype=np.int32)
            src += w
            dst += w_pad
        off = src = 0
        for lv, w_pad in enumerate(widths):
            w = s.level_widths[lv] if lv < len(s.level_widths) else 0
            flat_a[i, off: off + w] = remap[s.flat_a[src: src + w]]
            flat_b[i, off: off + w] = remap[s.flat_b[src: src + w]]
            off += w_pad
            src += w
        row_idx[i, :, : s.row_idx.shape[1]] = remap[s.row_idx]
    template = dataclasses.replace(scheds[0], level_widths=widths, flat_a=flat_a[0],
                                   flat_b=flat_b[0], row_idx=row_idx[0])
    return template, flat_a, flat_b, row_idx


def schedule_stats(k: int) -> dict:
    """Host-readable schedule metrics."""
    s = compile_schedule(k)
    return {
        "schedule_xor_ops": s.xor_ops,
        "schedule_cse_hits": s.cse_hits,
        "schedule_dense_ops": s.dense_ops,
        "schedule_nodes": s.n_nodes,
        "schedule_levels": len(s.level_widths),
        "schedule_row_width": int(s.row_idx.shape[1]),
    }


# ------------------------------------------------------------------ #
# Evaluators: numpy (tests) and plain PyTorch (the kernels' reference).


def apply_planes_np(planes: np.ndarray, sched: XorSchedule) -> np.ndarray:
    """(n_in, T) 0/1 planes -> (n_out, T) parity planes, numpy."""
    acc = np.concatenate(
        [planes, np.zeros((1, planes.shape[-1]), planes.dtype)], axis=0)
    off = 0
    for w in sched.level_widths:
        a = sched.flat_a[off: off + w]
        b = sched.flat_b[off: off + w]
        acc = np.concatenate([acc, acc[a] ^ acc[b]], axis=0)
        off += w
    out = acc[sched.row_idx[:, 0]].copy()
    for t in range(1, sched.row_idx.shape[1]):
        out ^= acc[sched.row_idx[:, t]]
    return out


@dataclasses.dataclass(frozen=True)
class ScheduleIndex:
    """A schedule's index arrays as int64 tensors on one device, for the
    plain evaluator's gathers."""

    sched: XorSchedule
    flat_a: torch.Tensor
    flat_b: torch.Tensor
    row_idx: torch.Tensor


def schedule_index(sched: XorSchedule, device, flat_a=None, flat_b=None,
                   row_idx=None) -> ScheduleIndex:
    """The schedule's index arrays on ``device``; a mesh shard passes its own
    rows of ``sharded_schedule_arrays`` with the padded template."""
    def as_index(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.int64), device=device)

    return ScheduleIndex(sched, as_index(sched.flat_a if flat_a is None else flat_a),
                         as_index(sched.flat_b if flat_b is None else flat_b),
                         as_index(sched.row_idx if row_idx is None else row_idx))


def apply_planes(planes: torch.Tensor, index: ScheduleIndex) -> torch.Tensor:
    """(n_in, T) 0/1 planes -> (n_out, T) parity planes, plain PyTorch, any
    integer dtype; the same gathers and XORs as ``apply_planes_np``."""
    zero = torch.zeros((1, planes.shape[-1]), dtype=planes.dtype,
                       device=planes.device)
    acc = torch.cat([planes, zero], dim=0)
    off = 0
    for w in index.sched.level_widths:
        a = index.flat_a[off: off + w]
        b = index.flat_b[off: off + w]
        acc = torch.cat([acc, acc[a] ^ acc[b]], dim=0)
        off += w
    out = acc[index.row_idx[:, 0]]
    for t in range(1, index.row_idx.shape[1]):
        out ^= acc[index.row_idx[:, t]]
    return out


def rs_encode_rows_xor(data: torch.Tensor, index: ScheduleIndex) -> torch.Tensor:
    """Schedule spelling of ``rs.rs_encode_rows``: (..., k, B) uint8 ->
    (..., k, B) parity; the second-to-last axis is the shard axis."""
    bits = rs.unpack_bits(data)  # (..., 8k, B)
    planes = torch.movedim(bits, -2, 0)
    lanes_shape = planes.shape[1:]
    out = apply_planes(planes.reshape(planes.shape[0], -1), index)
    out = torch.movedim(out.reshape(out.shape[0], *lanes_shape), 0, -2)
    return rs.pack_bits(out)

