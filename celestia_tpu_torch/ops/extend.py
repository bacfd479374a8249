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

Routes (``_roots_of``, as in the JAX package's extend_tpu._roots_of):

- fused dense (the default): the three quadrant encodes run K1
  (``rs_cuda.encode2d_hash``), which returns every parity cell's leaf digest
  with its bytes; Q0's leaves run K2 (``rs_cuda.leaf_digests2d``);
- fused XOR: the same with K5 (``xor_cuda.encode2d_xor_hash``), the parity
  from the compiled XOR schedule;
- unfused dense: ``rs_cuda.extend_square`` builds the EDS with K4
  (``rs_cuda.encode2d``), then K2 hashes every leaf of the EDS;
- unfused XOR: the same with K6 (``xor_cuda.encode2d_xor``).

Every route ends in one launch of the tree kernel (``nmt_cuda.nmt_tree``):
it reads the four quadrant tiles of leaf digests in place (on the fused
route K1's [col, row] outputs as transposed views, on the unfused routes
four slices of K2's grid) and the Q0 namespaces as a view of the shares,
and returns the row and column roots, with the row levels for
``eds_row_levels_device``. The device DAH merkle (``merkle_root_pow2``)
runs K3 (``sha256_cuda.sha256_words``) through ``sha256.sha256_fixed``. The
leaves of an existing EDS (``eds_roots_device``, ``eds_row_levels_device``)
run K2.

The route is chosen per k as the JAX package chooses it: the env pins
``CELESTIA_FUSED_KERNELS`` and ``CELESTIA_XOR_SCHEDULE`` ("0"/"off"/"false"
pins unfused or dense, "1"/"on"/"true" fused or XOR); unpinned, the route is
fused, and XOR only where the port's own measured table
(``app/calibration.py``) says so. All four give the same bytes.

``kernels`` selects the functions the path calls. The default, ``KERNELS``,
holds the wrappers, which launch the CUDA kernels on CUDA tensors and run
their plain versions on CPU tensors; ``PLAIN`` holds the plain versions
themselves, which is how the kernel route is held against the plain route
on the card. Outputs are byte-identical to celestia_tpu's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.app import calibration
from celestia_tpu_torch.ops import nmt_cuda, rs, rs_cuda, sha256_cuda, xor_cuda, xor_schedule
from celestia_tpu_torch.ops.nmt_cuda import NMT_NODE_SIZE, leaf_namespaces as _leaf_namespaces
from celestia_tpu_torch.ops.sha256 import sha256_fixed

_LEAF_PREFIX = np.array([0], dtype=np.uint8)
_NODE_PREFIX = np.array([1], dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The kernel functions the routes call."""

    encode2d_hash: Callable
    leaf_digests2d: Callable
    sha256_words: Callable
    encode2d: Callable
    encode2d_xor_hash: Callable
    encode2d_xor: Callable
    nmt_tree: Callable


KERNELS = Kernels(rs_cuda.encode2d_hash, rs_cuda.leaf_digests2d,
                  sha256_cuda.sha256_words, rs_cuda.encode2d,
                  xor_cuda.encode2d_xor_hash, xor_cuda.encode2d_xor,
                  nmt_cuda.nmt_tree)
PLAIN = Kernels(rs_cuda.encode2d_hash_reference,
                rs_cuda.leaf_digests2d_reference,
                sha256_cuda.sha_core_reference, rs_cuda.encode2d_reference,
                xor_cuda.encode2d_xor_hash_reference,
                xor_cuda.encode2d_xor_reference,
                nmt_cuda.nmt_tree_reference)

_FUSED_ENV = "CELESTIA_FUSED_KERNELS"
_XOR_ENV = "CELESTIA_XOR_SCHEDULE"
_PIN_OFF = ("0", "off", "false")
_PIN_ON = ("1", "on", "true")


def _pin(env: str) -> str:
    return os.environ.get(env, "").strip().lower()


def _fused_active(k: int) -> bool:
    """Fused unless ``CELESTIA_FUSED_KERNELS`` pins it off: the port has
    K1 for every k its entries take, so "on" and unset agree."""
    return _pin(_FUSED_ENV) not in _PIN_OFF


def _xor_active(k: int) -> bool:
    """``CELESTIA_XOR_SCHEDULE`` "off" pins dense and "on" pins the
    schedule; unset, the port's measured table decides (dense without
    one). A k the schedule does not support is never XOR."""
    v = _pin(_XOR_ENV)
    if v in _PIN_OFF or not xor_schedule.supported(k):
        return False
    if v in _PIN_ON:
        return True
    return calibration.xor_winner(k) == "xor"


def _bcast_const(const: np.ndarray, like: torch.Tensor,
                 batch: tuple[int, ...]) -> torch.Tensor:
    return torch.as_tensor(const, device=like.device).expand(*batch, const.shape[0])


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


def _eds_tree(eds: torch.Tensor, kernels: Kernels, keep_levels: bool = False):
    """The tree kernel over an existing EDS: K2's (2k, 2k, 8) leaf-digest
    grid, passed as four quadrant slices, and Q0's namespaces read from
    the shares. ``keep_levels`` goes to ``nmt_tree``."""
    w = eds.shape[0]
    k = w // 2
    q0_ns = eds[:k, :k, :NAMESPACE_SIZE]
    grid = kernels.leaf_digests2d(eds.reshape(w, w * SHARE_SIZE),
                                  rs_cuda.pad_namespaces(_leaf_namespaces(q0_ns, k)))
    quads = (grid[:k, :k], grid[:k, k:], grid[k:, :k], grid[k:, k:])
    return kernels.nmt_tree(quads, q0_ns, keep_levels)


def nmt_roots_of_eds(eds: torch.Tensor, kernels: Kernels = KERNELS):
    """(2k, 2k, 512) EDS -> (row_roots, col_roots), leaf namespaces read
    from Q0 (the JAX spelling takes them as an argument)."""
    roots, _levels = _eds_tree(eds, kernels)
    return roots[0], roots[1]


def _roots_of_fused(shares: torch.Tensor, m2: rs.EncodeMatrix,
                    kernels: Kernels = KERNELS, xor: bool = False):
    """(k, k, 512) -> (eds, row_roots, col_roots) on a fused route: K1, or
    with ``xor`` K5, for the quadrant encodes.

    Column extension contracts over the leading (row) axis, the kernels'
    native layout; row extension transposes in and out, and the digest
    grids transpose with it. Q2 = col-extend Q0, Q1 = row-extend Q0,
    Q3 = row-extend Q2."""
    k = shares.shape[0]
    if xor:
        ops = xor_cuda.schedule_operands(k, shares.device)

        def encode(x):
            return kernels.encode2d_xor_hash(x, ops)
    else:
        def encode(x):
            return kernels.encode2d_hash(x, m2)
    n = k * SHARE_SIZE
    x0 = shares.reshape(k, n)
    q0_ns = shares[..., :NAMESPACE_SIZE]
    d0 = kernels.leaf_digests2d(x0, rs_cuda.pad_namespaces(q0_ns))  # [row, col]
    q2f, d2 = encode(x0)  # native: [row, col]
    q2 = q2f.reshape(k, k, SHARE_SIZE)
    x0t = shares.transpose(0, 1).reshape(k, n)
    q1t, d1t = encode(x0t)  # [col, row]
    q1 = q1t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
    q2t = q2.transpose(0, 1).reshape(k, n)
    q3t, d3t = encode(q2t)  # [col, row]
    q3 = q3t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
    eds = torch.cat([
        torch.cat([shares, q1], dim=1),
        torch.cat([q2, q3], dim=1),
    ], dim=0)
    # the digest tiles in [row, col] orientation, read in place
    roots, _levels = kernels.nmt_tree(
        (d0, d1t.transpose(0, 1), d2, d3t.transpose(0, 1)), q0_ns)
    return eds, roots[0], roots[1]


def _roots_of(shares: torch.Tensor, m2: rs.EncodeMatrix, fused: bool | None = None,
              xor: bool | None = None, kernels: Kernels = KERNELS):
    """(k, k, 512) -> (eds, row_roots, col_roots) on the route that
    ``fused`` and ``xor`` name; None resolves each through
    ``_fused_active`` / ``_xor_active``. Byte-identical any way."""
    k = shares.shape[0]
    if fused is None:
        fused = _fused_active(k)
    if xor is None:
        xor = _xor_active(k)
    if fused:
        return _roots_of_fused(shares, m2, kernels, xor)
    if xor:
        eds = xor_cuda.extend_square_xor(
            shares, xor_cuda.schedule_operands(k, shares.device), kernels.encode2d_xor)
    else:
        eds = rs_cuda.extend_square(shares, m2, kernels.encode2d)
    row_roots, col_roots = nmt_roots_of_eds(eds, kernels)
    return eds, row_roots, col_roots


def extend_and_root(shares: torch.Tensor, m2: rs.EncodeMatrix,
                    kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> (eds (2k,2k,512), row_roots (2k,90),
    col_roots (2k,90), dah_hash (32,))."""
    eds, row_roots, col_roots = _roots_of(shares, m2, kernels=kernels)
    dah = merkle_root_pow2(torch.cat([row_roots, col_roots], dim=0), kernels)
    return eds, row_roots, col_roots, dah


def extend_and_roots_only(shares: torch.Tensor, m2: rs.EncodeMatrix,
                          kernels: Kernels = KERNELS):
    """(k, k, 512) -> (eds, row_roots, col_roots). The DAH over the 4k
    axis roots is a ~1k-node tree; the host finishes it (da module)."""
    return _roots_of(shares, m2, kernels=kernels)


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
    k = _eds_size(eds)
    _roots, levels = _eds_tree(_stage(eds, dev), kernels, keep_levels=True)
    return nmt_cuda.split_levels(levels.cpu().numpy(), k)  # one D2H copy
