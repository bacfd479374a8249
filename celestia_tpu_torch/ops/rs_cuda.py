"""Kernels K1 (fused RS encode + NMT leaf hash) and K2 (NMT leaf hash).

Counterpart of the JAX package's ops/rs_pallas.py. Sources:
``csrc/rs_hash.cu`` with the SHA-256 compression of ``csrc/sha256.cuh``.

K1 ``encode2d_hash(x2, m2)`` replaces ``rs_pallas.encode2d_hash``
(rs_pallas.py:276, ``pallas_call`` at :217): the GF(2) bit-matrix Leopard
encode of k data shards and, in the same pass, the SHA-256 NMT leaf digest
of every produced cell (0x00 ‖ parity namespace ‖ 512-byte cell, 542 bytes,
9 blocks). The parity tile of a 512-lane cell column is written to shared
memory next to global memory, so the hash stage reads it without another
trip through device memory.

K2 ``leaf_digests2d(x2, ns_pad)`` replaces ``rs_pallas.leaf_digests2d``
(rs_pallas.py:295, ``pallas_call`` at :243): the leaf digests of cells that
already exist, each with its own namespace.

Layouts (the Pallas ones): x2 is (k, N) uint8 with the shard axis leading
and N a multiple of 512 (lanes are any flattening of whole 512-byte cells);
parity is (k, N) uint8; digests are (k, N/512, 8) uint32, the big-endian
word values of SHA-256; ns_pad is (k, N/512, 32) uint8, the 29-byte
namespace zero-padded to 32.

What bounds them on the H100, at k = 128 (N = 65,536):
- K1: the contraction, 2·(8k)²·N = 137 G bit operations, is 69 µs at the
  1,979 TOP/s int8 tensor-core rate; the 147,456 SHA blocks (~2.2k int32
  operations each) are ~19 µs at ~16.7 T int32 op/s; the ~18 MB moved are
  5.5 µs at 3.35 TB/s. So K1 is bound by operations. This first kernel does
  the contraction on the integer ALUs instead (32 AND/XOR lanes per word
  operation, one popcount per parity bit); moving it onto int8 tensor cores
  is later work.
- K2: the same 147,456 SHA blocks, ~19 µs, operation-bound; 9 MB moved.
K1 and K2 share one hash stage: one thread hashes one cell from a shared
memory tile whose row stride (516 bytes) spreads a warp's reads over all
banks.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import _cuda, rs
from celestia_tpu_torch.ops.sha256_cuda import message_words, sha_core_reference

# namespaces ride to the leaf-hash kernel padded to a 4-byte-aligned width
NS_PAD = 32
MAX_K = 128  # K1 keeps the packed (8k, k/4) M2 in shared memory
PARITY_NS = np.frombuffer(ns.PARITY_SHARES_NAMESPACE.bytes, dtype=np.uint8).copy()


def pad_namespaces(ns_cells: torch.Tensor) -> torch.Tensor:
    """(k, nc, 29) uint8 per-cell namespaces -> (k, nc, NS_PAD) kernel
    input (zero-padded; the kernel reads only the first 29 bytes)."""
    return torch.nn.functional.pad(ns_cells, (0, NS_PAD - ns_cells.shape[-1]))


def _leaf_digests_plain(cells: torch.Tensor, ns_cells: torch.Tensor) -> torch.Tensor:
    """(R, N) cells + (R, N/512, 29) namespaces -> (R, N/512, 8) uint32,
    digest = SHA-256(0x00 ‖ ns ‖ cell), through the plain SHA."""
    r, n = cells.shape
    nc = n // SHARE_SIZE
    zero = torch.zeros((r, nc, 1), dtype=torch.uint8, device=cells.device)
    msg = torch.cat([zero, ns_cells, cells.reshape(r, nc, SHARE_SIZE)], dim=-1)
    digests = sha_core_reference(message_words(msg.reshape(r * nc, -1)))
    return digests.view(torch.int32).T.reshape(r, nc, 8).view(torch.uint32)


def _check_lanes(x2: torch.Tensor) -> None:
    if x2.dim() != 2 or x2.shape[1] == 0 or x2.shape[1] % SHARE_SIZE:
        raise ValueError(f"x2 must be (rows, N) with N a positive multiple "
                         f"of {SHARE_SIZE}, got {tuple(x2.shape)}")


def encode2d_hash_reference(x2: torch.Tensor, m2: rs.EncodeMatrix):
    """Plain PyTorch version of K1: ((k, N) parity, (k, N/512, 8) digests)."""
    _check_lanes(x2)
    k, n = x2.shape
    parity = rs.rs_encode_rows(x2, m2.bits)
    parity_ns = torch.as_tensor(PARITY_NS, device=x2.device).expand(
        k, n // SHARE_SIZE, NAMESPACE_SIZE)
    return parity, _leaf_digests_plain(parity, parity_ns)


def leaf_digests2d_reference(x2: torch.Tensor, ns_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (R, N/512, 8) uint32 leaf digests."""
    _check_lanes(x2)
    return _leaf_digests_plain(x2, ns_pad[..., :NAMESPACE_SIZE])


def encode2d_hash(x2: torch.Tensor, m2: rs.EncodeMatrix):
    """Fused encode + NMT leaf hash: (k, N) uint8 data shards ->
    ((k, N) parity shards, (k, N/512, 8) uint32 leaf digest words).

    digests[i, c] = SHA-256(0x00 ‖ parity-ns ‖ parity[i, 512c:512(c+1)]).
    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    if x2.device.type == "cpu":
        return encode2d_hash_reference(x2, m2)
    _check_lanes(x2)
    k, n = x2.shape
    if k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    _cuda.require(x2, "x2", torch.uint8, (k, n), x2.device)
    _cuda.require(m2.packed, "m2.packed", torch.uint32,
                  (8 * k, rs.packed_words(k)), x2.device)
    parity = torch.empty((k, n), dtype=torch.uint8, device=x2.device)
    digests = torch.empty((k, n // SHARE_SIZE, 8), dtype=torch.uint32,
                          device=x2.device)
    lib = _cuda.library()
    rc = lib.celestia_encode2d_hash(
        x2.data_ptr(), m2.packed.data_ptr(), parity.data_ptr(),
        digests.data_ptr(), k, n, x2.device.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, "encode2d_hash")
    _cuda.LAUNCHES["encode2d_hash"] += 1
    return parity, digests


def leaf_digests2d(x2: torch.Tensor, ns_pad: torch.Tensor) -> torch.Tensor:
    """NMT leaf digests of existing cells: (R, N) uint8 cell bytes +
    (R, N/512, NS_PAD) padded namespaces -> (R, N/512, 8) uint32.

    A CPU tensor runs the plain version; a CUDA tensor launches K2."""
    if x2.device.type == "cpu":
        return leaf_digests2d_reference(x2, ns_pad)
    _check_lanes(x2)
    r, n = x2.shape
    nc = n // SHARE_SIZE
    _cuda.require(x2, "x2", torch.uint8, (r, n), x2.device)
    _cuda.require(ns_pad, "ns_pad", torch.uint8, (r, nc, NS_PAD), x2.device)
    digests = torch.empty((r, nc, 8), dtype=torch.uint32, device=x2.device)
    lib = _cuda.library()
    rc = lib.celestia_leaf_digests2d(
        x2.data_ptr(), ns_pad.data_ptr(), digests.data_ptr(), r, n,
        x2.device.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, "leaf_digests2d")
    _cuda.LAUNCHES["leaf_digests2d"] += 1
    return digests
