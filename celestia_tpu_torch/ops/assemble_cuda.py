"""The square assembly kernel and its wrapper.

Counterpart of the JAX package's ``extend_tpu._assemble_square`` with
``_derive_cells`` (celestia_tpu/ops/extend_tpu.py:766, :726), an XLA graph,
not a Pallas kernel. Source: ``csrc/assemble_square.cu``; the plain version
is ``ops/assemble.assemble_square_reference``, whose docstring gives the
inputs.

``assemble_square`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, with no fallback either way. The kernel reads the
per-blob block and the host-cell pairs from the staged device buffers:
nothing per cell crosses from the host.

What bounds it: bytes, every cell written once and every blob byte and
used host row read once, (k²·512 + blob bytes + host rows·512) / 3.35 TB/s.
No single PyTorch call computes it.
"""

from __future__ import annotations

import torch

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import _cuda
from celestia_tpu_torch.ops.assemble import assemble_square_reference, check_inputs


def assemble_square(arena: torch.Tensor, host_table: torch.Tensor, blob_meta: torch.Tensor,
                    ns_table: torch.Tensor, host_sparse: torch.Tensor, k: int) -> torch.Tensor:
    """The (k, k, 512) share square assembled from the arena; see
    ``ops/assemble``. A CUDA tensor launches the kernel once."""
    check_inputs(arena, host_table, blob_meta, ns_table, host_sparse, k)
    dev = arena.device
    if dev.type == "cpu":
        return assemble_square_reference(arena, host_table, blob_meta, ns_table,
                                         host_sparse, k)
    if dev.type != "cuda":
        raise ValueError(f"the square assembly runs on cuda or cpu tensors, not {dev}")
    n_b, n_h, n_hc = int(blob_meta.shape[1]), int(host_table.shape[0]), int(host_sparse.shape[1])
    _cuda.require(arena, "arena", torch.uint8, (arena.numel(),), dev)
    _cuda.require(host_table, "host_table", torch.uint8, (n_h, SHARE_SIZE), dev)
    _cuda.require(blob_meta, "blob_meta", torch.int32, (4, n_b), dev)
    _cuda.require(ns_table, "ns_table", torch.uint8, (n_b, NAMESPACE_SIZE), dev)
    _cuda.require(host_sparse, "host_sparse", torch.int32, (2, n_hc), dev)
    out = torch.empty((k, k, SHARE_SIZE), dtype=torch.uint8, device=dev)
    rc = _cuda.library().celestia_assemble_square(
        arena.data_ptr(), arena.numel(), host_table.data_ptr(), n_h, blob_meta.data_ptr(),
        ns_table.data_ptr(), n_b, host_sparse.data_ptr(), n_hc, out.data_ptr(), k,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _cuda.stream_of(out))
    _cuda.check(rc, "assemble_square")
    _cuda.LAUNCHES["assemble_square"] += 1
    return out
