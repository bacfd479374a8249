"""K3's merkle form: the DAH's merkle root over its axis roots, one launch.

Source: ``csrc/dah_merkle.cu`` (sharing ``csrc/sha256.cuh``). It replaces the
merkle form of the Pallas kernel ``sha256_pallas.sha256_words``
(celestia_tpu/ops/sha256_pallas.py:129), which the JAX package runs once per
level from ``extend_tpu.merkle_root_pow2`` (celestia_tpu/ops/extend_tpu.py:181):
there the 91- and 65-byte messages are concatenated, padded and transposed
in device memory before every level. Here one thread-block cluster owns
one DAH's tree: it builds every leaf and node message in registers from the
roots and digests in shared memory and chains the levels with one barrier
each.

Contract of ``dah_merkle(roots)``:

- ``roots``: (B, n, 90) uint8, contiguous, n = 4k a power of two from 4 to
  512: each DAH's 2k row roots, then its 2k column roots.
- Returns (B, 32) uint8: each DAH's hash, tendermint's
  ``merkle.HashFromByteSlices`` of its n roots (RFC 6962: leaf
  SHA-256(0x00 ‖ root), node SHA-256(0x01 ‖ left ‖ right);
  pkg/da/data_availability_header.go:92-108).

A CPU tensor runs ``dah_merkle_reference``, the JAX package's level loop
through the plain SHA-256 (``sha256_cuda.sha_core_reference``); a CUDA
tensor launches the kernel or raises. PyTorch has no SHA-256, so the kernel
has no library counterpart.

A DAH is one thread-block cluster of ``cluster_size(n)`` blocks: each
hashes its n / C leaves up to a subtree root, and block 0 gathers the C
roots from the others' shared memory and hashes the last levels.

What bounds it at k = 128 (512 leaves and 511 nodes, two SHA-256 blocks
each): one tree's chain of 10 levels of two blocks' rounds; all its blocks
at the card's ALU rate take less (``chip_smoke.py`` counts both).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from celestia_tpu_torch.ops import _cuda
from celestia_tpu_torch.ops.sha256 import sha256_fixed
from celestia_tpu_torch.ops.sha256_cuda import sha_core_reference

ROOT_SIZE = 90  # an NMT root: min namespace, max namespace, digest
MIN_LEAVES = 4  # 4k at k = 1
MAX_LEAVES = 512  # 4k at k = 128
MAX_CLUSTER = 8  # blocks a DAH spreads over, at most
CLUSTER_LEAVES = 64  # leaves a block of a cluster, at least
_PREFIX = {"leaf": np.array([0], dtype=np.uint8), "node": np.array([1], dtype=np.uint8)}


@functools.lru_cache(maxsize=None)
def _prefix(name: str, device: torch.device) -> torch.Tensor:
    """The RFC-6962 prefix byte on ``device``, sent once per process."""
    return torch.as_tensor(_PREFIX[name], device=device)


def _check(roots: torch.Tensor) -> tuple[int, int]:
    """(B, n) of a valid roots tensor."""
    if roots.dtype != torch.uint8 or roots.dim() != 3 or roots.shape[2] != ROOT_SIZE:
        raise ValueError(f"roots must be uint8 (B, n, {ROOT_SIZE}), got {roots.dtype} "
                         f"{tuple(roots.shape)}")
    b, n = int(roots.shape[0]), int(roots.shape[1])
    if b < 1 or n < MIN_LEAVES or n > MAX_LEAVES or n & (n - 1):
        raise ValueError(f"roots must hold B >= 1 DAHs of n = 4k roots, a power of two from "
                         f"{MIN_LEAVES} to {MAX_LEAVES}, got {tuple(roots.shape)}")
    return b, n


def dah_merkle_reference(roots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the merkle kernel: the JAX package's
    ``merkle_root_pow2`` level loop through the plain SHA-256."""
    b, n = _check(roots)
    leaf = _prefix("leaf", roots.device).expand(b, n, 1)
    nodes = sha256_fixed(torch.cat([leaf, roots], dim=-1), sha_core_reference)
    while nodes.shape[1] > 1:
        left, right = nodes[:, 0::2], nodes[:, 1::2]
        prefix = _prefix("node", roots.device).expand(b, left.shape[1], 1)
        nodes = sha256_fixed(torch.cat([prefix, left, right], dim=-1), sha_core_reference)
    return nodes[:, 0]


def cluster_size(n: int) -> int:
    """Blocks a DAH of n leaves spreads over: one up to 64 leaves, then one
    a 64 leaves, at most 8 (the portable cluster size). The C entry picks
    the same (``cluster_size`` in ``csrc/dah_merkle.cu``); this copy serves
    the tests' emulation and ``chip_smoke.py``'s report."""
    return min(MAX_CLUSTER, max(1, n // CLUSTER_LEAVES))


def dah_merkle(roots: torch.Tensor) -> torch.Tensor:
    """(B, n, 90) uint8 axis roots -> (B, 32) uint8 DAH hashes; see the
    module docstring. A CPU tensor runs the plain version; a CUDA tensor
    launches the merkle kernel, one cluster a DAH."""
    if roots.device.type == "cpu":
        return dah_merkle_reference(roots)
    b, n = _check(roots)
    _cuda.require(roots, "roots", torch.uint8, (b, n, ROOT_SIZE), roots.device)
    out = torch.empty((b, 32), dtype=torch.uint8, device=roots.device)
    rc = _cuda.library().celestia_dah_merkle(roots.data_ptr(), out.data_ptr(), b, n,
                                             roots.device.index or 0, _cuda.stream_of(roots))
    _cuda.check(rc, "dah_merkle")
    _cuda.LAUNCHES["dah_merkle"] += 1
    return out
