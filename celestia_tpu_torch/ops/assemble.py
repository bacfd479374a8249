"""Device-side square assembly from the resident blob arena: the plain
PyTorch version (port of the JAX package's extend_tpu._derive_cells and
_assemble_square, celestia_tpu/ops/extend_tpu.py:726, :766).

``assemble_square_reference`` writes the JAX graph in torch: the per-blob
metadata expanded into per-cell vectors (``torch.searchsorted`` with
``right=True``), a (k², 512) index grid gathered from the arena, and
``where`` between prefix, data, zeros and the host table. It is what the
CPU tests hold against the JAX package and what ``chip_smoke.py`` holds
the kernel (``ops/assemble_cuda``) against on the card.

Inputs (the layout ``assemble_cuda.assemble_square`` takes):

- ``arena``: (N,) uint8, N >= 1, the blob arena;
- ``host_table``: (H, 512) uint8, the deduplicated host shares;
- ``blob_meta``: (4, B) int32, per blob [start cell | shares | arena
  offset | byte length], starts strictly ascending;
- ``ns_table``: (B, 29) uint8, each blob's namespace;
- ``host_sparse``: (2, Hc) int32, [cell position | host row] pairs,
  positions strictly ascending in [0, k²); H >= 1 when Hc >= 1.

A host row outside [0, H) and an arena index outside [0, N) are clamped
into range, as the JAX graph clips them. With B = 0 the JAX package pads
one all-zero blob row (start k², no shares), so every cell that is not a
host cell is all zeros; the plain version pads the same row.
"""

from __future__ import annotations

import torch

from celestia_tpu_torch.appconsts import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE as CONT_SPARSE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE as FIRST_SPARSE,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)


def check_inputs(arena: torch.Tensor, host_table: torch.Tensor, blob_meta: torch.Tensor,
                 ns_table: torch.Tensor, host_sparse: torch.Tensor, k: int) -> None:
    """Shapes, dtypes and devices both versions take (values are the
    caller's: ``extend.assembled_roots`` checks them on the host)."""
    dev = arena.device
    b = int(blob_meta.shape[1]) if blob_meta.dim() == 2 else -1
    hc = int(host_sparse.shape[1]) if host_sparse.dim() == 2 else -1
    want = {
        "arena": (arena, torch.uint8, 1),
        "host_table": (host_table, torch.uint8, 2),
        "blob_meta": (blob_meta, torch.int32, 2),
        "ns_table": (ns_table, torch.uint8, 2),
        "host_sparse": (host_sparse, torch.int32, 2),
    }
    for name, (t, dtype, dims) in want.items():
        if t.device != dev or t.dtype != dtype or t.dim() != dims:
            raise ValueError(f"{name} must be a {dims}-d {dtype} tensor on {dev}, got "
                             f"{t.dim()}-d {t.dtype} on {t.device}")
    if arena.numel() < 1 or arena.numel() >= 1 << 31:
        raise ValueError(f"the arena holds {arena.numel()} bytes: 1 to 2**31 - 1 expected")
    if host_table.shape[1] != SHARE_SIZE:
        raise ValueError(f"host_table must be (H, {SHARE_SIZE}), got {tuple(host_table.shape)}")
    if blob_meta.shape[0] != 4 or tuple(ns_table.shape) != (b, NAMESPACE_SIZE):
        raise ValueError(f"blob_meta must be (4, B) and ns_table (B, {NAMESPACE_SIZE}), got "
                         f"{tuple(blob_meta.shape)} and {tuple(ns_table.shape)}")
    if host_sparse.shape[0] != 2 or (hc and host_table.shape[0] == 0):
        raise ValueError(f"host_sparse must be (2, Hc) with a host row for it, got "
                         f"{tuple(host_sparse.shape)} over {host_table.shape[0]} rows")
    if not 1 <= k <= 128:
        raise ValueError(f"k must be 1..128, got {k}")


def _big_endian(v: torch.Tensor) -> torch.Tensor:
    """(S,) int64 holding uint32 values -> (S, 4) uint8, most significant
    byte first (the JAX package's ``astype(">u4")`` view)."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=v.device)
    return ((v[:, None] >> shifts) & 0xFF).to(torch.uint8)


def assemble_square_reference(arena: torch.Tensor, host_table: torch.Tensor,
                              blob_meta: torch.Tensor, ns_table: torch.Tensor,
                              host_sparse: torch.Tensor, k: int) -> torch.Tensor:
    """The (k, k, 512) square, as ``_assemble_square`` builds it."""
    check_inputs(arena, host_table, blob_meta, ns_table, host_sparse, k)
    dev = arena.device
    s = k * k
    meta = blob_meta.to(torch.int64)
    if meta.shape[1] == 0:  # the JAX package's padding row: never matches a cell
        meta = torch.tensor([[s], [0], [0], [0]], dtype=torch.int64, device=dev)
        ns_table = torch.zeros((1, NAMESPACE_SIZE), dtype=torch.uint8, device=dev)
    s_idx = torch.arange(s, dtype=torch.int64, device=dev)
    starts = meta[0].contiguous()
    b = (torch.searchsorted(starts, s_idx, right=True) - 1).clamp(0, meta.shape[1] - 1)
    j_in = s_idx - starts[b]
    in_blob = (j_in >= 0) & (j_in < meta[1][b])
    cell_first = in_blob & (j_in == 0)
    doff = torch.where(cell_first, 0, FIRST_SPARSE + (j_in - 1) * CONT_SPARSE)
    data_start = torch.where(in_blob, meta[2][b] + doff, 0)
    cap = torch.where(cell_first, FIRST_SPARSE, CONT_SPARSE)
    data_len = torch.where(in_blob, torch.minimum(cap, meta[3][b] - doff), 0)
    cell_blob = torch.where(in_blob, b, 0)
    cell_host_row = torch.full((s,), -1, dtype=torch.int64, device=dev)
    cell_host_row[host_sparse[0].to(torch.int64)] = host_sparse[1].to(torch.int64)

    info = cell_first.to(torch.uint8)  # share version 0
    prefix = torch.cat([ns_table[cell_blob], info[:, None],
                        _big_endian(meta[3][cell_blob] & 0xFFFFFFFF)], dim=1)  # (S, 34)
    prefix_len = torch.where(cell_first, NAMESPACE_SIZE + 5, NAMESPACE_SIZE + 1)
    j = torch.arange(SHARE_SIZE, dtype=torch.int64, device=dev)
    pref_padded = torch.nn.functional.pad(prefix, (0, SHARE_SIZE - prefix.shape[1]))
    data_pos = j[None, :] - prefix_len[:, None]  # (S, 512)
    arena_idx = (data_start[:, None] + data_pos).clamp(0, arena.numel() - 1)
    arena_vals = arena[arena_idx]
    in_prefix = j[None, :] < prefix_len[:, None]
    in_data = ~in_prefix & (data_pos < data_len[:, None])
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    cells = torch.where(in_prefix, pref_padded, torch.where(in_data, arena_vals, zero))
    if host_table.shape[0]:
        hrow = cell_host_row.clamp(0, host_table.shape[0] - 1)
        cells = torch.where((cell_host_row >= 0)[:, None], host_table[hrow], cells)
    return cells.reshape(k, k, SHARE_SIZE)
