"""Kernels K1 (fused RS encode + NMT leaf hash), K2 (NMT leaf hash) and K4
(RS encode alone), and the unfused dense extend.

Counterpart of the JAX package's ops/rs_pallas.py. Sources:
``csrc/rs_hash.cu`` with the SHA-256 compression of ``csrc/sha256.cuh``.

K1 ``encode2d_hash(x2, m2)`` replaces ``rs_pallas.encode2d_hash``
(rs_pallas.py:276, body ``_fused_kernel`` :167, ``pallas_call`` at :217):
the Leopard encode of k data shards and, in the same pass, the SHA-256 NMT
leaf digest of every produced cell (0x00 ‖ parity namespace ‖ 512-byte cell,
542 bytes, 9 blocks). The parity tile of a 512-lane cell column is written
to shared memory next to global memory, so the hash stage reads it without
another trip through device memory.

K4 ``encode2d(x2, m2)`` replaces ``rs_pallas.encode2d`` (rs_pallas.py:270,
body ``_encode_kernel`` :163, ``pallas_call`` at :197): K1's encode with
the hash stage compiled out (one template flag on the same kernel, so the
encode has one copy). It is the quadrant encode of ``extend_square``, the
unfused dense route.

The encode is not the TPU kernels' GF(2) bit-matrix product on the MXU: it
is ``gf256.leopard_encode``'s own additive FFT (an inverse then a forward
transform over the k shards, 896 butterflies at k = 128), run from the
butterfly program in ``m2.fft_rows`` / ``m2.fft_group`` (``rs.fft_program``),
with each multiply by a constant a byte lookup in that constant's product
row in shared memory. The plain versions still multiply by M2 (``m2.bits``),
so the kernels are held against an independent spelling of the same code.

K2 ``leaf_digests2d(x2, ns_pad)`` replaces ``rs_pallas.leaf_digests2d``
(rs_pallas.py:295, ``pallas_call`` at :243): the leaf digests of cells that
already exist, each with its own namespace.

Layouts (the Pallas ones): x2 is (k, N) uint8 with the shard axis leading
and N a multiple of 512 (lanes are any flattening of whole 512-byte cells);
parity is (k, N) uint8; digests are (k, N/512, 8) uint32, the big-endian
word values of SHA-256; ns_pad is (k, N/512, 32) uint8, the 29-byte
namespace zero-padded to 32.

What bounds them on the H100, at k = 128 (N = 65,536). The encode has three
known spellings, and its bound is the cheapest one's:
- as a dense product, 2·(8k)²·N = 137 G bit operations, 69 µs at the
  1,979 TOP/s int8 tensor-core rate;
- as the compiled XOR schedule (``ops/xor_schedule.py``) bit-sliced 32 lanes
  to a word, rows assembled from three-input XORs: 2.5e8 int32 operations,
  15 µs at 16.7 T int32 op/s on the ALU pipe (64 INT32 lanes per SM, the
  Hopper white paper, × 132 SMs × 1.98 GHz);
- as the Leopard FFT, 769 multiply butterflies and 127 plain ones per lane:
  with 4 lanes to a word, 9 int32 operations per multiply butterfly (4
  byte permutes that make the lookup addresses, 3 that assemble the
  products, 2 XORs) and 1 per plain one, 1.2e8 operations, 6.9 µs; beside
  them 769 byte lookups per lane, 5.0e7 in all, 6.0 µs on the shared-memory
  pipe (32 lookups per clock per SM, without bank conflicts).
So K4 is bound at 6.9 µs by operations. K1 adds the 147,456 leaf SHA blocks
on the same ALU pipe: a block compiles to 1,265 ALU-pipe operations (SHF,
LOP3, IADD3) and 118 IMAD on the FMA pipe (counted from the SASS of K3's
block loop by ``chip_smoke.py``), 11.2 µs for the leaves, so K1 is bound at
18.1 µs by operations; the ~18 MB it moves are 5.5 µs at 3.35 TB/s. The
kernel holds 2 lanes per word (5 operations and 2 lookups per multiply
butterfly): at 4 lanes a thread, k = 128 leaves one warp per SM
sub-partition to wait on its own lookups. K1's hash stage reads the parity
from a shared-memory tile whose row stride (516 bytes) spreads a warp's
reads over all banks.
- K2: the same 147,456 SHA blocks, 11.2 µs, operation-bound; 9 MB moved.
One thread hashes one cell, read from device memory into registers in
16-byte loads, no shared memory (``csrc/rs_hash.cu``).
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
MAX_K = 128  # the FFT encode holds k state registers per thread; one instance per k
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


def check_lanes(x2: torch.Tensor) -> None:
    if x2.dim() != 2 or x2.shape[1] == 0 or x2.shape[1] % SHARE_SIZE:
        raise ValueError(f"x2 must be (rows, N) with N a positive multiple "
                         f"of {SHARE_SIZE}, got {tuple(x2.shape)}")


def parity_leaf_digests_plain(parity: torch.Tensor) -> torch.Tensor:
    """(k, N) parity cells -> (k, N/512, 8) uint32 leaf digests under the
    parity namespace: the hash stage K1 and K5 share, in plain PyTorch."""
    k, n = parity.shape
    parity_ns = torch.as_tensor(PARITY_NS, device=parity.device).expand(
        k, n // SHARE_SIZE, NAMESPACE_SIZE)
    return _leaf_digests_plain(parity, parity_ns)


def encode2d_reference(x2: torch.Tensor, m2: rs.EncodeMatrix) -> torch.Tensor:
    """Plain PyTorch version of K4: (k, N) parity."""
    check_lanes(x2)
    return rs.rs_encode_rows(x2, m2.bits)


def encode2d_hash_reference(x2: torch.Tensor, m2: rs.EncodeMatrix):
    """Plain PyTorch version of K1: ((k, N) parity, (k, N/512, 8) digests)."""
    parity = encode2d_reference(x2, m2)
    return parity, parity_leaf_digests_plain(parity)


def leaf_digests2d_reference(x2: torch.Tensor, ns_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (R, N/512, 8) uint32 leaf digests."""
    check_lanes(x2)
    expect = (x2.shape[0], x2.shape[1] // SHARE_SIZE, NS_PAD)
    if tuple(ns_pad.shape) != expect:
        raise ValueError(f"ns_pad has shape {tuple(ns_pad.shape)}, expected {expect}")
    return _leaf_digests_plain(x2, ns_pad[..., :NAMESPACE_SIZE])


def _check_encode_inputs(x2: torch.Tensor, m2: rs.EncodeMatrix) -> None:
    check_lanes(x2)
    k, n = x2.shape
    if k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    _cuda.require(x2, "x2", torch.uint8, (k, n), x2.device)
    if m2.k != k:
        raise ValueError(f"the encode operands are for k = {m2.k}, x2 has {k} shards")
    _cuda.require(m2.fft_rows, "m2.fft_rows", torch.uint8, (max(k - 1, 0), 256), x2.device)
    _cuda.require(m2.fft_group, "m2.fft_group", torch.int16, (2 * (k - 1),), x2.device)


def encode2d(x2: torch.Tensor, m2: rs.EncodeMatrix) -> torch.Tensor:
    """RS encode: (k, N) uint8 data shards -> (k, N) parity shards.

    A CPU tensor runs the plain version; a CUDA tensor launches K4."""
    if x2.device.type == "cpu":
        return encode2d_reference(x2, m2)
    _check_encode_inputs(x2, m2)
    k, n = x2.shape
    parity = torch.empty((k, n), dtype=torch.uint8, device=x2.device)
    rc = _cuda.library().celestia_encode2d(
        x2.data_ptr(), m2.fft_rows.data_ptr(), m2.fft_group.data_ptr(),
        m2.fft_rows.shape[0], parity.data_ptr(), k, n, x2.device.index or 0,
        _cuda.stream_of(x2))
    _cuda.check(rc, "encode2d")
    _cuda.LAUNCHES["encode2d"] += 1
    return parity


def encode2d_hash(x2: torch.Tensor, m2: rs.EncodeMatrix):
    """Fused encode + NMT leaf hash: (k, N) uint8 data shards ->
    ((k, N) parity shards, (k, N/512, 8) uint32 leaf digest words).

    digests[i, c] = SHA-256(0x00 ‖ parity-ns ‖ parity[i, 512c:512(c+1)]).
    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    if x2.device.type == "cpu":
        return encode2d_hash_reference(x2, m2)
    _check_encode_inputs(x2, m2)
    k, n = x2.shape
    parity = torch.empty((k, n), dtype=torch.uint8, device=x2.device)
    digests = torch.empty((k, n // SHARE_SIZE, 8), dtype=torch.uint32,
                          device=x2.device)
    lib = _cuda.library()
    rc = lib.celestia_encode2d_hash(
        x2.data_ptr(), m2.fft_rows.data_ptr(), m2.fft_group.data_ptr(),
        m2.fft_rows.shape[0], parity.data_ptr(), digests.data_ptr(), k, n,
        x2.device.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, "encode2d_hash")
    _cuda.LAUNCHES["encode2d_hash"] += 1
    return parity, digests


def leaf_digests2d(x2: torch.Tensor, ns_pad: torch.Tensor) -> torch.Tensor:
    """NMT leaf digests of existing cells: (R, N) uint8 cell bytes +
    (R, N/512, NS_PAD) padded namespaces -> (R, N/512, 8) uint32.

    A CPU tensor runs the plain version; a CUDA tensor launches K2."""
    if x2.device.type == "cpu":
        return leaf_digests2d_reference(x2, ns_pad)
    check_lanes(x2)
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


def extend_square(q0: torch.Tensor, m2: rs.EncodeMatrix,
                  encode=encode2d) -> torch.Tensor:
    """(k, k, 512) -> EDS with every quadrant encode on K4 (port of
    ``rs_pallas.extend_square``); ``encode=encode2d_reference`` runs the
    plain version on any device."""
    return rs.extend_quadrants(q0, lambda x: encode(x, m2))
