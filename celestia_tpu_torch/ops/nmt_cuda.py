"""The NMT tree kernel: leaf-digest grid -> row and column roots, and the
row-tree levels, in one launch.

Source: ``csrc/nmt_tree.cu`` (sharing ``csrc/sha256.cuh``). It replaces the
tree form of the Pallas kernel ``sha256_pallas.sha256_words``
(celestia_tpu/ops/sha256_pallas.py:129), which the JAX package runs once per
tree level from ``extend_tpu._nmt_reduce_once`` / ``_digest_grid_roots``
(extend_tpu.py:136-153, :223): there the 181-byte node messages are built,
padded and transposed in device memory before every level. Here one block
owns whole trees, builds every message from the child nodes in shared
memory, applies the leaf namespace rule and the inner max-namespace rule
itself, and chains the levels with a barrier each: no message tensor, no
constant from the host, one launch per extend.

Contract of ``nmt_tree(quadrants, q0_ns, keep_levels)``:

- ``quadrants``: the (2k, 2k) grid of leaf digests as four (k, k, 8) uint32
  tiles Q0, Q1, Q2, Q3 in [row, col] orientation (EDS rows 0..k-1 /
  k..2k-1, columns likewise), the big-endian word values K1 and K2 emit.
  Each may be a strided view (the fused route passes K1's [col, row]
  outputs transposed, the unfused route four slices of K2's grid); the
  kernel reads each in place with its strides.
- ``q0_ns``: the (k, k, W >= 29) uint8 Q0 namespaces, the first 29 bytes of
  each run used: a view of the shares (``shares[..., :29]``), read in
  place, or ``rs_cuda.pad_namespaces``' (k, k, 32) form (the kernel reads
  32 bytes from each 16-byte-aligned run). Cell (r, c) has namespace ``q0_ns[r, c]`` in Q0 and the parity
  namespace everywhere else; its leaf node is ns ‖ ns ‖ digest.
- ``keep_levels``: False reduces both families (an extend's roots); True
  reduces the rows alone and also returns every row-tree level (what
  ``eds_row_levels_device`` needs).
- Returns ``(roots, levels)``: roots (F, 2k, 90) uint8, the rows and then
  the columns (F = 2), or the rows alone with ``keep_levels`` (F = 1);
  levels a flat uint8 buffer holding level L as (2k, 2k >> L, 90) for
  L = 0 .. log2(2k), one after another (``split_levels`` cuts it), or
  None.

The row-block mode ``nmt_tree_rows(quadrants, q0_ns, keep_levels)`` (the
same kernel, its own C entry and launch count) reduces the row trees alone
of a block of grid rows, as one shard of a row-sharded mesh holds them
(``parallel``): Q0 and Q1 are the (t, k, 8) tiles of its t top rows (grid
rows below k), Q2 and Q3 the (b, k, 8) tiles of its b bottom rows, and
``q0_ns`` the (t, k, W >= 29) namespaces of the top rows' first k cells
(None when t = 0). The top rows keep Q0's namespaces in their first k cells;
every other cell takes the parity namespace. It returns the (1, t + b, 90)
row roots, top rows first, and with ``keep_levels`` the (t + b, 2k >> L, 90)
levels in the same flat layout (``split_levels(buf, k, t + b)``). A row
range [lo, lo + n) of the (2k, 2k) grid is the block of its rows below k and
its rows from k on. The column trees of a grid are the row trees of its
transpose: the tiles (Q0ᵀ, Q2ᵀ, Q1ᵀ, Q3ᵀ) with ``q0_ns.transpose(0, 1)``.

A CPU tensor runs ``nmt_tree_reference`` (``nmt_tree_rows_reference``), the
plain PyTorch level loop through the plain SHA-256
(``sha256_cuda.sha_core_reference``); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE
from celestia_tpu_torch.ops import _cuda
from celestia_tpu_torch.ops.rs_cuda import PARITY_NS
from celestia_tpu_torch.ops.sha256 import sha256_fixed, words_to_bytes
from celestia_tpu_torch.ops.sha256_cuda import sha_core_reference

NMT_NODE_SIZE = 2 * NAMESPACE_SIZE + 32  # 90
MAX_K = 128  # a group of 128 threads owns one tree of 2k = 256 leaves
_NODE_PREFIX = np.array([1], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _device_const(name: str, device: torch.device) -> torch.Tensor:
    """A constant byte array on ``device``, sent once per process."""
    return torch.as_tensor({"parity": PARITY_NS, "node": _NODE_PREFIX}[name], device=device)


def leaf_namespaces(q0_ns: torch.Tensor, k: int) -> torch.Tensor:
    """(k, k, 29) Q0 namespaces -> (2k, 2k, 29) per-cell leaf namespaces."""
    parity = _device_const("parity", q0_ns.device).expand(k, k, NAMESPACE_SIZE)
    top = torch.cat([q0_ns, parity], dim=1)
    bottom = torch.cat([parity, parity], dim=1)
    return torch.cat([top, bottom], dim=0)


def reduce_once(nodes: torch.Tensor) -> torch.Tensor:
    """One pairwise NMT level through the plain SHA-256:
    (..., n, 90) -> (..., n/2, 90)."""
    left = nodes[..., 0::2, :]
    right = nodes[..., 1::2, :]
    batch = tuple(left.shape[:-1])
    prefix = _device_const("node", nodes.device).expand(*batch, 1)
    digest = sha256_fixed(torch.cat([prefix, left, right], dim=-1), sha_core_reference)
    parity = _device_const("parity", nodes.device)
    right_is_parity = (right[..., :NAMESPACE_SIZE] == parity).all(dim=-1, keepdim=True)
    max_ns = torch.where(
        right_is_parity,
        left[..., NAMESPACE_SIZE:2 * NAMESPACE_SIZE],
        right[..., NAMESPACE_SIZE:2 * NAMESPACE_SIZE],
    )
    return torch.cat([left[..., :NAMESPACE_SIZE], max_ns, digest], dim=-1)


def level_shapes(k: int, rows: int | None = None) -> list[tuple[int, int, int]]:
    """The row-tree levels' shapes: (rows, 2k >> L, 90) for L = 0 .. log2(2k),
    rows = 2k unless given (a row block's)."""
    w = 2 * k
    rows = w if rows is None else rows
    return [(rows, w >> lv, NMT_NODE_SIZE) for lv in range(w.bit_length())]


def split_levels(buf, k: int, rows: int | None = None) -> list:
    """A flat levels buffer (tensor or numpy) -> its list of level views."""
    out, off = [], 0
    for shape in level_shapes(k, rows):
        size = shape[0] * shape[1] * shape[2]
        out.append(buf[off:off + size].reshape(shape))
        off += size
    return out


def _check(quadrants, q0_ns: torch.Tensor) -> int:
    if len(quadrants) != 4:
        raise ValueError(f"expected 4 quadrant tiles, got {len(quadrants)}")
    k = int(quadrants[0].shape[0])
    if k < 1 or k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    dev = quadrants[0].device
    for i, q in enumerate(quadrants):
        if tuple(q.shape) != (k, k, 8) or q.dtype != torch.uint32 or q.device != dev:
            raise ValueError(f"quadrant {i} must be ({k}, {k}, 8) uint32 on {dev}, got "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if (q0_ns.dim() != 3 or tuple(q0_ns.shape[:2]) != (k, k)
            or q0_ns.shape[2] < NAMESPACE_SIZE or q0_ns.dtype != torch.uint8
            or q0_ns.device != dev):
        raise ValueError(f"q0_ns must be ({k}, {k}, >= {NAMESPACE_SIZE}) uint8 on {dev}, "
                         f"got {tuple(q0_ns.shape)} {q0_ns.dtype} on {q0_ns.device}")
    return k


def _reduce_plain(families: list[torch.Tensor], keep_levels: bool):
    """The plain level loop over (trees, w, 90) leaf families stacked into
    one level-synchronous pass: (roots (F, trees, 90), the first family's
    levels as one flat buffer or None)."""
    nodes = torch.stack(families, dim=0)
    levels = [nodes[0]]
    while nodes.shape[-2] > 1:
        nodes = reduce_once(nodes)
        levels.append(nodes[0])
    buf = torch.cat([lv.reshape(-1) for lv in levels]) if keep_levels else None
    return nodes[:, :, 0, :].contiguous(), buf


def nmt_tree_reference(quadrants, q0_ns: torch.Tensor, keep_levels: bool = False):
    """Plain PyTorch version of the tree kernel: the level loop of
    ``extend_tpu._digest_grid_roots`` / ``nmt_reduce_levels`` over the plain
    SHA-256, both families stacked into one level-synchronous pass (the
    rows alone with ``keep_levels``)."""
    k = _check(quadrants, q0_ns)
    q0, q1, q2, q3 = quadrants
    grid = torch.cat([torch.cat([q0, q1], dim=1), torch.cat([q2, q3], dim=1)], dim=0)
    leaf_ns = leaf_namespaces(q0_ns[..., :NAMESPACE_SIZE], k)
    leaves = torch.cat([leaf_ns, leaf_ns, words_to_bytes(grid)], dim=-1)  # (2k, 2k, 90)
    families = [leaves] if keep_levels else [leaves, leaves.transpose(0, 1)]
    return _reduce_plain(families, keep_levels)


def _check_rows(quadrants, q0_ns) -> tuple[int, int, int]:
    """The row-block mode's inputs: (k, top rows, bottom rows)."""
    if len(quadrants) != 4:
        raise ValueError(f"expected 4 quadrant tiles, got {len(quadrants)}")
    top, k = int(quadrants[0].shape[0]), int(quadrants[0].shape[1])
    bottom = int(quadrants[2].shape[0])
    if k < 1 or k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    if top + bottom < 1:
        raise ValueError("a row block needs at least one row")
    dev = quadrants[0].device
    for i, q in enumerate(quadrants):
        rows = top if i < 2 else bottom
        if tuple(q.shape) != (rows, k, 8) or q.dtype != torch.uint32 or q.device != dev:
            raise ValueError(f"quadrant {i} must be ({rows}, {k}, 8) uint32 on {dev}, got "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if top and (q0_ns is None or q0_ns.dim() != 3 or tuple(q0_ns.shape[:2]) != (top, k)
                or q0_ns.shape[2] < NAMESPACE_SIZE or q0_ns.dtype != torch.uint8
                or q0_ns.device != dev):
        got = None if q0_ns is None else (tuple(q0_ns.shape), q0_ns.dtype, q0_ns.device)
        raise ValueError(f"q0_ns must be ({top}, {k}, >= {NAMESPACE_SIZE}) uint8 on {dev}, "
                         f"got {got}")
    return k, top, bottom


def nmt_tree_rows_reference(quadrants, q0_ns, keep_levels: bool = False):
    """Plain PyTorch version of the row-block mode: the top rows' leaves
    (Q0's namespaces in their first k cells) over the bottom rows' (all
    parity), reduced as rows by the same level loop."""
    k, top, bottom = _check_rows(quadrants, q0_ns)
    q0, q1, q2, q3 = quadrants
    parity = _device_const("parity", q0.device)
    grid = torch.cat([torch.cat([q0, q1], dim=1), torch.cat([q2, q3], dim=1)], dim=0)
    ns_parts = [parity.expand(bottom, 2 * k, NAMESPACE_SIZE)]
    if top:
        ns_parts.insert(0, torch.cat([q0_ns[..., :NAMESPACE_SIZE],
                                      parity.expand(top, k, NAMESPACE_SIZE)], dim=1))
    leaf_ns = torch.cat(ns_parts, dim=0)
    leaves = torch.cat([leaf_ns, leaf_ns, words_to_bytes(grid)], dim=-1)  # (t + b, 2k, 90)
    return _reduce_plain([leaves], keep_levels)


def _word_strides(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(row, column) strides, in elements, of a (k, k, n) tile whose cells
    the kernel reads in 16-byte loads."""
    rs, cs, es = t.stride()
    ok = es == 1 and t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0 for s, n in zip((rs, cs), t.shape[:2]) if n > 1)
    if not ok:
        raise ValueError(f"{name} strides {t.stride()} / pointer are not 16-byte aligned")
    return (rs if t.shape[0] > 1 else 0), (cs if t.shape[1] > 1 else 0)


def _ns_operand(q0_ns, rows: int, k: int) -> tuple[int, int, int]:
    """(pointer, row stride, cell stride) of the namespaces the kernel reads
    32 bytes at, for each of rows x k cells."""
    if rows == 0:
        return 0, 0, 0
    ns_rs, ns_cs = _word_strides(q0_ns, "q0_ns")
    if (q0_ns.storage_offset() + (rows - 1) * ns_rs + (k - 1) * ns_cs + 32
            > q0_ns.untyped_storage().nbytes()):
        raise ValueError("q0_ns must hold 32 readable bytes at each cell: a view of "
                         "the shares, or rs_cuda.pad_namespaces' form")
    return q0_ns.data_ptr(), ns_rs, ns_cs


def _outputs(trees: int, families: int, k: int, keep_levels: bool, dev: torch.device):
    roots = torch.empty((families, trees, NMT_NODE_SIZE), dtype=torch.uint8, device=dev)
    levels = None
    if keep_levels:
        levels = torch.empty(sum(a * b * c for a, b, c in level_shapes(k, trees)),
                             dtype=torch.uint8, device=dev)
    return roots, levels


def nmt_tree(quadrants, q0_ns: torch.Tensor, keep_levels: bool = False):
    """NMT roots (and the row levels) of a leaf-digest grid; see the module
    docstring. A CPU tensor runs the plain version; a CUDA tensor launches
    the tree kernel."""
    if quadrants[0].device.type == "cpu":
        return nmt_tree_reference(quadrants, q0_ns, keep_levels)
    k = _check(quadrants, q0_ns)
    dev = quadrants[0].device
    strides = [s for i, q in enumerate(quadrants) for s in _word_strides(q, f"quadrant {i}")]
    ns = _ns_operand(q0_ns, k, k)
    roots, levels = _outputs(2 * k, 1 if keep_levels else 2, k, keep_levels, dev)
    rc = _cuda.library().celestia_nmt_tree(
        *(q.data_ptr() for q in quadrants), *strides, *ns,
        roots.data_ptr(), levels.data_ptr() if levels is not None else None, k,
        dev.index or 0, _cuda.stream_of(quadrants[0]))
    _cuda.check(rc, "nmt_tree")
    _cuda.LAUNCHES["nmt_tree"] += 1
    return roots, levels


def nmt_tree_rows(quadrants, q0_ns, keep_levels: bool = False):
    """The row-block mode: the row roots (and levels) of a block of grid
    rows; see the module docstring. A CPU tensor runs the plain version; a
    CUDA tensor launches the tree kernel."""
    if quadrants[0].device.type == "cpu":
        return nmt_tree_rows_reference(quadrants, q0_ns, keep_levels)
    k, top, bottom = _check_rows(quadrants, q0_ns)
    dev = quadrants[0].device
    strides = [s for i, q in enumerate(quadrants) for s in _word_strides(q, f"quadrant {i}")]
    ns = _ns_operand(q0_ns, top, k)
    roots, levels = _outputs(top + bottom, 1, k, keep_levels, dev)
    rc = _cuda.library().celestia_nmt_tree_rows(
        *(q.data_ptr() for q in quadrants), *strides, *ns,
        roots.data_ptr(), levels.data_ptr() if levels is not None else None, k, top, bottom,
        dev.index or 0, _cuda.stream_of(quadrants[0]))
    _cuda.check(rc, "nmt_tree_rows")
    _cuda.LAUNCHES["nmt_tree_rows"] += 1
    return roots, levels
