"""The main path on the card: share square -> EDS -> NMT roots -> DAH hash.

Port of the main path of the JAX package's ops/extend_tpu.py (the
counterpart of the reference's ExtendBlock chain, app/extend_block.go:14 ->
pkg/da/data_availability_header.go:44,65 -> rsmt2d + pkg/wrapper NMTs).

Structure:

- Both tree families hash the same leaves: the wrapper's namespace rule
  (pkg/wrapper/nmt_wrapper.go:93-114 — Q0 cells keep their own namespace,
  parity cells use the parity namespace) depends only on the cell. So leaf
  digests are computed once over the (2k, 2k) grid and reduced along axis 1
  (row trees) and axis 0 (column trees), stacked into one level-synchronous
  pass.
- Axis length 2k is a power of two, so the RFC-6962 split is a balanced
  binary tree: pairwise reduction with static shapes at every level.
- Namespace min/max follow nmt v0.20 with IgnoreMaxNamespace, in the
  two-branch form (min = left.min; max = left.max if right.min == parity
  else right.max), equal to the general three-branch hasher
  (ops/nmt_host.hash_node) on every tree whose leaf namespaces are
  non-decreasing, which nmt itself enforces and the square builder
  guarantees.

The route is the fused one of the JAX package (``_roots_of_fused``): the
three quadrant encodes run kernel K1 (``rs_cuda.encode2d_hash``), which
returns every parity cell's leaf digest with its bytes; Q0's leaves run K2
(``rs_cuda.leaf_digests2d``); every tree level and the DAH merkle run K3
(``sha256_cuda.sha256_words``) through ``sha256.sha256_fixed``. The leaves
of an existing EDS (``eds_roots_device``, ``eds_row_levels_device``) run K2.

``kernels`` selects the functions the path calls. The default, ``KERNELS``,
holds the wrappers, which launch the CUDA kernels on CUDA tensors and run
their plain versions on CPU tensors; ``PLAIN`` holds the plain versions
themselves, which is how the kernel route is held against the plain route
on the card. Outputs are byte-identical to celestia_tpu's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.ops import rs, rs_cuda, sha256_cuda
from celestia_tpu_torch.ops.sha256 import sha256_fixed, words_to_bytes

_LEAF_PREFIX = np.array([0], dtype=np.uint8)
_NODE_PREFIX = np.array([1], dtype=np.uint8)
NMT_NODE_SIZE = 2 * NAMESPACE_SIZE + 32  # 90


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The three kernel functions the main path calls."""

    encode2d_hash: Callable
    leaf_digests2d: Callable
    sha256_words: Callable


KERNELS = Kernels(rs_cuda.encode2d_hash, rs_cuda.leaf_digests2d,
                  sha256_cuda.sha256_words)
PLAIN = Kernels(rs_cuda.encode2d_hash_reference,
                rs_cuda.leaf_digests2d_reference,
                sha256_cuda.sha_core_reference)


def _bcast_const(const: np.ndarray, like: torch.Tensor,
                 batch: tuple[int, ...]) -> torch.Tensor:
    return torch.as_tensor(const, device=like.device).expand(*batch, const.shape[0])


def nmt_leaf_nodes(leaf_ns: torch.Tensor, data: torch.Tensor,
                   kernels: Kernels = KERNELS) -> torch.Tensor:
    """(..., 29) ns + (..., D) data -> (..., 90) NMT leaf nodes."""
    batch = tuple(data.shape[:-1])
    msg = torch.cat([_bcast_const(_LEAF_PREFIX, data, batch), leaf_ns, data], dim=-1)
    digest = sha256_fixed(msg, kernels.sha256_words)
    return torch.cat([leaf_ns, leaf_ns, digest], dim=-1)


def _nmt_reduce_once(nodes: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
    """One pairwise NMT level: (..., n, 90) -> (..., n/2, 90)."""
    left = nodes[..., 0::2, :]
    right = nodes[..., 1::2, :]
    batch = tuple(left.shape[:-1])
    msg = torch.cat([_bcast_const(_NODE_PREFIX, nodes, batch), left, right], dim=-1)
    digest = sha256_fixed(msg, kernels.sha256_words)
    parity = torch.as_tensor(rs_cuda.PARITY_NS, device=nodes.device)
    right_is_parity = (right[..., :NAMESPACE_SIZE] == parity).all(dim=-1, keepdim=True)
    max_ns = torch.where(
        right_is_parity,
        left[..., NAMESPACE_SIZE:2 * NAMESPACE_SIZE],
        right[..., NAMESPACE_SIZE:2 * NAMESPACE_SIZE],
    )
    return torch.cat([left[..., :NAMESPACE_SIZE], max_ns, digest], dim=-1)


def nmt_reduce_axis(nodes: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
    """Pairwise-reduce (..., n, 90) NMT nodes along axis -2 to roots (..., 90).
    n must be a power of two (always true for EDS axes)."""
    while nodes.shape[-2] > 1:
        nodes = _nmt_reduce_once(nodes, kernels)
    return nodes[..., 0, :]


def nmt_reduce_levels(nodes: torch.Tensor,
                      kernels: Kernels = KERNELS) -> list[torch.Tensor]:
    """Like nmt_reduce_axis, but keep every tree level:
    [leaves (..., n, 90), (..., n/2, 90), ..., roots (..., 1, 90)].
    On a power-of-two tree every range the RFC-6962 split visits is one of
    these aligned nodes, so the stack is the whole proof memo of a row."""
    levels = [nodes]
    while nodes.shape[-2] > 1:
        nodes = _nmt_reduce_once(nodes, kernels)
        levels.append(nodes)
    return levels


def merkle_root_pow2(items: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
    """RFC-6962 merkle root of (..., n, D) items, n a power of two
    (tendermint merkle.HashFromByteSlices; the DAH hashes its 4k axis roots,
    pkg/da/data_availability_header.go:92-108)."""
    batch = tuple(items.shape[:-1])
    leaves = sha256_fixed(
        torch.cat([_bcast_const(_LEAF_PREFIX, items, batch), items], dim=-1),
        kernels.sha256_words)
    while leaves.shape[-2] > 1:
        left = leaves[..., 0::2, :]
        right = leaves[..., 1::2, :]
        msg = torch.cat([_bcast_const(_NODE_PREFIX, items, tuple(left.shape[:-1])),
                         left, right], dim=-1)
        leaves = sha256_fixed(msg, kernels.sha256_words)
    return leaves[..., 0, :]


def _leaf_namespaces(q0_ns: torch.Tensor, k: int) -> torch.Tensor:
    """(k, k, 29) Q0 namespaces -> (2k, 2k, 29) per-cell leaf namespaces."""
    parity = torch.as_tensor(rs_cuda.PARITY_NS, device=q0_ns.device).expand(k, k, NAMESPACE_SIZE)
    top = torch.cat([q0_ns, parity], dim=1)
    bottom = torch.cat([parity, parity], dim=1)
    return torch.cat([top, bottom], dim=0)


def _digest_grid_roots(digest_bytes: torch.Tensor, leaf_ns: torch.Tensor,
                       kernels: Kernels = KERNELS):
    """(2k,2k,32) per-cell leaf digests + (2k,2k,29) namespaces ->
    (row_roots, col_roots). Cell (r, c) has the same leaf in its row tree
    and its column tree, so one grid feeds both reductions, stacked into
    one level-synchronous pass."""
    leaf_nodes = torch.cat([leaf_ns, leaf_ns, digest_bytes], dim=-1)
    stacked = torch.stack([leaf_nodes, leaf_nodes.transpose(0, 1)], dim=0)
    roots = nmt_reduce_axis(stacked, kernels)
    return roots[0], roots[1]


def _eds_leaf_digests(eds: torch.Tensor, kernels: Kernels) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf digests (2k, 2k, 32) and namespaces (2k, 2k, 29) of an
    existing EDS, through K2 over its (2k, 2k·512) byte rows."""
    w = eds.shape[0]
    k = w // 2
    leaf_ns = _leaf_namespaces(eds[:k, :k, :NAMESPACE_SIZE], k)
    words = kernels.leaf_digests2d(eds.reshape(w, w * SHARE_SIZE),
                                   rs_cuda.pad_namespaces(leaf_ns))
    return words_to_bytes(words), leaf_ns


def nmt_roots_of_eds(eds: torch.Tensor, kernels: Kernels = KERNELS):
    """(2k, 2k, 512) EDS -> (row_roots, col_roots), leaf namespaces read
    from Q0 (the JAX spelling takes them as an argument)."""
    digest_bytes, leaf_ns = _eds_leaf_digests(eds, kernels)
    return _digest_grid_roots(digest_bytes, leaf_ns, kernels)


def _roots_of_fused(shares: torch.Tensor, m2: rs.EncodeMatrix,
                    kernels: Kernels = KERNELS):
    """(k, k, 512) -> (eds, row_roots, col_roots) on the fused route.

    Column extension contracts over the leading (row) axis, the kernels'
    native layout; row extension transposes in and out, and the digest
    grids transpose with it. Q2 = col-extend Q0, Q1 = row-extend Q0,
    Q3 = row-extend Q2."""
    k = shares.shape[0]
    n = k * SHARE_SIZE
    x0 = shares.reshape(k, n)
    q0_ns = shares[..., :NAMESPACE_SIZE]
    d0 = kernels.leaf_digests2d(x0, rs_cuda.pad_namespaces(q0_ns))  # [row, col]
    q2f, d2 = kernels.encode2d_hash(x0, m2)  # native: [row, col]
    q2 = q2f.reshape(k, k, SHARE_SIZE)
    x0t = shares.transpose(0, 1).reshape(k, n)
    q1t, d1t = kernels.encode2d_hash(x0t, m2)  # [col, row]
    q1 = q1t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
    q2t = q2.transpose(0, 1).reshape(k, n)
    q3t, d3t = kernels.encode2d_hash(q2t, m2)  # [col, row]
    q3 = q3t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
    eds = torch.cat([
        torch.cat([shares, q1], dim=1),
        torch.cat([q2, q3], dim=1),
    ], dim=0)
    d0, d1t, d2, d3t = (d.view(torch.int32) for d in (d0, d1t, d2, d3t))
    dig = torch.cat([
        torch.cat([d0, d1t.transpose(0, 1)], dim=1),
        torch.cat([d2, d3t.transpose(0, 1)], dim=1),
    ], dim=0)  # (2k, 2k, 8) digest words
    digest_bytes = words_to_bytes(dig.view(torch.uint32))
    leaf_ns = _leaf_namespaces(q0_ns, k)
    row_roots, col_roots = _digest_grid_roots(digest_bytes, leaf_ns, kernels)
    return eds, row_roots, col_roots


def extend_and_root(shares: torch.Tensor, m2: rs.EncodeMatrix,
                    kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> (eds (2k,2k,512), row_roots (2k,90),
    col_roots (2k,90), dah_hash (32,))."""
    eds, row_roots, col_roots = _roots_of_fused(shares, m2, kernels)
    dah = merkle_root_pow2(torch.cat([row_roots, col_roots], dim=0), kernels)
    return eds, row_roots, col_roots, dah


def extend_and_roots_only(shares: torch.Tensor, m2: rs.EncodeMatrix,
                          kernels: Kernels = KERNELS):
    """(k, k, 512) -> (eds, row_roots, col_roots). The DAH over the 4k
    axis roots is a ~1k-node tree; the host finishes it (da module)."""
    return _roots_of_fused(shares, m2, kernels)


# ------------------------------------------------------------------ #
# Host entries: numpy (or torch) in, numpy out, on the resolved device.


def _square_size(shares) -> int:
    shape = tuple(shares.shape)
    k = shape[0]
    if (len(shape) != 3 or shape[1] != k or shape[2] != SHARE_SIZE
            or k < 1 or k & (k - 1) or k > DEFAULT_SQUARE_SIZE_UPPER_BOUND):
        raise ValueError(f"shares must be (k, k, {SHARE_SIZE}) with k a power "
                         f"of two <= {DEFAULT_SQUARE_SIZE_UPPER_BOUND}, got {shape}")
    return k


def _stage(arr, dev: torch.device) -> torch.Tensor:
    """Host array or tensor -> contiguous uint8 tensor on dev."""
    t = (arr if isinstance(arr, torch.Tensor)
         else torch.from_numpy(np.require(arr, requirements=("C", "W"))))
    if t.dtype != torch.uint8:
        raise ValueError(f"expected uint8 bytes, got {t.dtype}")
    return t.to(dev).contiguous()


def _eds_size(eds) -> int:
    w = int(eds.shape[0])
    if tuple(eds.shape) != (w, w, SHARE_SIZE) or w < 2 or w & (w - 1):
        raise ValueError(f"eds must be (2k, 2k, {SHARE_SIZE}), got {tuple(eds.shape)}")
    return w // 2


def roots_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (row_roots, col_roots); the EDS is not
    returned."""
    _eds, rows, cols = extend_roots_device_resident(shares, device, kernels)
    return rows, cols


def extend_roots_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (eds, row_roots, col_roots); the caller
    computes the DAH hash on the host (da module)."""
    eds, rows, cols = extend_roots_device_resident(shares, device, kernels)
    return eds.cpu().numpy(), rows, cols


def extend_roots_device_resident(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> (eds tensor on the device, rows numpy, cols numpy).

    The EDS stays a device buffer; only the axis roots (2·2k·90 bytes)
    cross to the host. ref: app/extend_block.go:14."""
    dev = device_mod.resolve(device)
    k = _square_size(shares)
    eds, rows, cols = extend_and_roots_only(
        _stage(shares, dev), rs.encode_matrix(k, dev), kernels)
    return eds, rows.cpu().numpy(), cols.cpu().numpy()


def extend_and_root_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (eds, row_roots, col_roots, dah), the DAH
    hash computed on the device."""
    dev = device_mod.resolve(device)
    k = _square_size(shares)
    eds, rows, cols, dah = extend_and_root(
        _stage(shares, dev), rs.encode_matrix(k, dev), kernels)
    return eds.cpu().numpy(), rows.cpu().numpy(), cols.cpu().numpy(), dah.cpu().numpy()


def eds_roots_device(eds, device=None, kernels: Kernels = KERNELS):
    """NMT axis roots of an existing (2k, 2k, 512) EDS (host array or
    device tensor) -> numpy (row_roots, col_roots). Leaf namespaces are
    read from Q0 on the device."""
    dev = device_mod.resolve(device)
    _eds_size(eds)
    rows, cols = nmt_roots_of_eds(_stage(eds, dev), kernels)
    return rows.cpu().numpy(), cols.cpu().numpy()


def eds_row_levels_device(eds, device=None, kernels: Kernels = KERNELS) -> list[np.ndarray]:
    """Every row-tree level of an existing (2k, 2k, 512) EDS:
    [leaf nodes (2k, 2k, 90), (2k, k, 90), ..., roots (2k, 1, 90)] as
    numpy. levels[L][r, j] is row r's subtree node over leaves
    [j·2^L, (j+1)·2^L)."""
    dev = device_mod.resolve(device)
    _eds_size(eds)
    digest_bytes, leaf_ns = _eds_leaf_digests(_stage(eds, dev), kernels)
    leaf_nodes = torch.cat([leaf_ns, leaf_ns, digest_bytes], dim=-1)
    return [lv.cpu().numpy() for lv in nmt_reduce_levels(leaf_nodes, kernels)]
