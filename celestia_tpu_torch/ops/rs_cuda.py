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
namespace zero-padded to 32, or (``own_namespaces``) a view of the cells
themselves, whose first 29 bytes are their namespace.

The strided forms ``encode_hash_into(src, dst, m2)`` (K1) and
``encode_into(src, dst, m2)`` (K4) read k data shards from a (k, cells, 512)
view and write the parity into another, each at any shard and cell stride
that is a multiple of 512 bytes (``check_cells``). So the three quadrant
encodes of an extend read Q0 and write Q1, Q2 and Q3 in place in one
(2k, 2k, 512) EDS (``eds_quadrants``): a row extend's shards are the EDS
columns, a view with shard stride 512 and cell stride the row stride, and
no transposed copy is made. ``encode2d_hash`` and ``encode2d`` are the
contiguous case.

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
    _check_matrix(k, m2, x2.device)


def _check_matrix(k: int, m2: rs.EncodeMatrix, device: torch.device) -> None:
    if m2.k != k:
        raise ValueError(f"the encode operands are for k = {m2.k}, x2 has {k} shards")
    _cuda.require(m2.fft_rows, "m2.fft_rows", torch.uint8, (max(k - 1, 0), 256), device)
    _cuda.require(m2.fft_group, "m2.fft_group", torch.int16, (2 * (k - 1),), device)


def check_cells(t: torch.Tensor, name: str, shape: tuple[int, int, int],
                device: torch.device) -> tuple[int, int]:
    """A strided encode operand: a (k, cells, 512) uint8 view whose shard
    and cell strides are positive multiples of 512 bytes and whose cells
    are contiguous. Returns (shard stride, cell stride) in bytes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.uint8:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.uint8")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    shard, cell, byte = t.stride()
    if byte != 1 or min(shard, cell) <= 0 or shard % SHARE_SIZE or cell % SHARE_SIZE:
        raise ValueError(f"{name} has strides {t.stride()}: the shard and cell "
                         f"strides must be positive multiples of {SHARE_SIZE}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return shard, cell


def _check_into(src: torch.Tensor, dst: torch.Tensor, m2: rs.EncodeMatrix):
    if src.dim() != 3 or src.shape[2] != SHARE_SIZE or src.shape[1] == 0:
        raise ValueError(f"src must be (k, cells, {SHARE_SIZE}), got {tuple(src.shape)}")
    k, cells, _ = src.shape
    if k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    xs = check_cells(src, "src", (k, cells, SHARE_SIZE), src.device)
    ps = check_cells(dst, "dst", (k, cells, SHARE_SIZE), src.device)
    _check_matrix(k, m2, src.device)
    return k, cells, xs, ps


def _flat(src: torch.Tensor) -> torch.Tensor:
    return src.reshape(src.shape[0], src.shape[1] * SHARE_SIZE)


def encode_into_reference(src: torch.Tensor, dst: torch.Tensor, m2: rs.EncodeMatrix) -> None:
    """Plain PyTorch version of K4's strided form: the parity of the
    (k, cells, 512) data shards ``src`` written into the view ``dst``."""
    dst.copy_(encode2d_reference(_flat(src), m2).view(dst.shape))


def encode_hash_into_reference(src: torch.Tensor, dst: torch.Tensor,
                               m2: rs.EncodeMatrix) -> torch.Tensor:
    """Plain PyTorch version of K1's strided form: writes the parity into
    ``dst`` and returns its (k, cells, 8) uint32 leaf digests."""
    parity = encode2d_reference(_flat(src), m2)
    dst.copy_(parity.view(dst.shape))
    return parity_leaf_digests_plain(parity)


def encode_into(src: torch.Tensor, dst: torch.Tensor, m2: rs.EncodeMatrix) -> None:
    """RS encode in place: the parity of the k data shards ``src``, a
    (k, cells, 512) uint8 view (shard i, cell c), written into the view
    ``dst`` of the same shape. Each may be a strided view, such as a
    quadrant of an EDS or its transpose; the kernel reads and writes them
    in place. The two views must not share a byte.

    A CPU tensor runs the plain version; a CUDA tensor launches K4."""
    if src.device.type == "cpu":
        encode_into_reference(src, dst, m2)
        return
    k, cells, xs, ps = _check_into(src, dst, m2)
    rc = _cuda.library().celestia_encode2d(
        src.data_ptr(), *xs, m2.fft_rows.data_ptr(), m2.fft_group.data_ptr(),
        m2.fft_rows.shape[0], dst.data_ptr(), *ps, k, cells, src.device.index or 0,
        _cuda.stream_of(src))
    _cuda.check(rc, "encode2d")
    _cuda.LAUNCHES["encode2d"] += 1


def encode_hash_into(src: torch.Tensor, dst: torch.Tensor,
                     m2: rs.EncodeMatrix) -> torch.Tensor:
    """Fused encode + NMT leaf hash in place: as ``encode_into``, and
    returns the (k, cells, 8) uint32 leaf digest words of the parity,
    [shard, cell]: digests[i, c] = SHA-256(0x00 ‖ parity-ns ‖ dst[i, c]).

    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    if src.device.type == "cpu":
        return encode_hash_into_reference(src, dst, m2)
    k, cells, xs, ps = _check_into(src, dst, m2)
    digests = torch.empty((k, cells, 8), dtype=torch.uint32, device=src.device)
    rc = _cuda.library().celestia_encode2d_hash(
        src.data_ptr(), *xs, m2.fft_rows.data_ptr(), m2.fft_group.data_ptr(),
        m2.fft_rows.shape[0], dst.data_ptr(), *ps, digests.data_ptr(), k, cells,
        src.device.index or 0, _cuda.stream_of(src))
    _cuda.check(rc, "encode2d_hash")
    _cuda.LAUNCHES["encode2d_hash"] += 1
    return digests


def _cells(x2: torch.Tensor) -> torch.Tensor:
    return x2.view(x2.shape[0], x2.shape[1] // SHARE_SIZE, SHARE_SIZE)


def encode2d(x2: torch.Tensor, m2: rs.EncodeMatrix) -> torch.Tensor:
    """RS encode: (k, N) uint8 data shards -> (k, N) parity shards.

    A CPU tensor runs the plain version; a CUDA tensor launches K4."""
    if x2.device.type == "cpu":
        return encode2d_reference(x2, m2)
    _check_encode_inputs(x2, m2)
    parity = torch.empty_like(x2)
    encode_into(_cells(x2), _cells(parity), m2)
    return parity


def encode2d_hash(x2: torch.Tensor, m2: rs.EncodeMatrix):
    """Fused encode + NMT leaf hash: (k, N) uint8 data shards ->
    ((k, N) parity shards, (k, N/512, 8) uint32 leaf digest words).

    digests[i, c] = SHA-256(0x00 ‖ parity-ns ‖ parity[i, 512c:512(c+1)]).
    A CPU tensor runs the plain version; a CUDA tensor launches K1."""
    if x2.device.type == "cpu":
        return encode2d_hash_reference(x2, m2)
    _check_encode_inputs(x2, m2)
    parity = torch.empty_like(x2)
    return parity, encode_hash_into(_cells(x2), _cells(parity), m2)


def own_namespaces(x2: torch.Tensor) -> torch.Tensor:
    """The ns_pad argument of K2 for cells that carry their own namespace
    (Q0): a (R, N/512, NS_PAD) view of the cells' first bytes, read in
    place (the kernel uses the first 29)."""
    r, n = x2.shape
    return x2.view(r, n // SHARE_SIZE, SHARE_SIZE)[..., :NS_PAD]


def _ns_stride(ns_pad: torch.Tensor, shape: tuple[int, int, int], device) -> int:
    """The byte stride between cells of K2's namespace operand: a
    contiguous padded array (NS_PAD) or a view of the cells (512)."""
    if ns_pad.device != device or ns_pad.dtype != torch.uint8 or tuple(ns_pad.shape) != shape:
        raise ValueError(f"ns_pad must be uint8 {shape} on {device}, got "
                         f"{ns_pad.dtype} {tuple(ns_pad.shape)} on {ns_pad.device}")
    s_row, s_cell, s_byte = ns_pad.stride()
    if (s_byte != 1 or s_cell < NS_PAD or s_cell % 16 or s_row != shape[1] * s_cell
            or ns_pad.data_ptr() % 16):
        raise ValueError(f"ns_pad strides {ns_pad.stride()}: cells must be evenly "
                         f"spaced, 16-byte aligned and at least {NS_PAD} bytes apart")
    return s_cell


def leaf_digests2d(x2: torch.Tensor, ns_pad: torch.Tensor) -> torch.Tensor:
    """NMT leaf digests of existing cells: (R, N) uint8 cell bytes +
    (R, N/512, NS_PAD) padded namespaces -> (R, N/512, 8) uint32. ns_pad is
    ``pad_namespaces``' array or ``own_namespaces``' view of the cells.

    A CPU tensor runs the plain version; a CUDA tensor launches K2."""
    if x2.device.type == "cpu":
        return leaf_digests2d_reference(x2, ns_pad)
    check_lanes(x2)
    r, n = x2.shape
    nc = n // SHARE_SIZE
    _cuda.require(x2, "x2", torch.uint8, (r, n), x2.device)
    ns_stride = _ns_stride(ns_pad, (r, nc, NS_PAD), x2.device)
    digests = torch.empty((r, nc, 8), dtype=torch.uint32, device=x2.device)
    lib = _cuda.library()
    rc = lib.celestia_leaf_digests2d(
        x2.data_ptr(), ns_pad.data_ptr(), ns_stride, digests.data_ptr(), r, n,
        x2.device.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, "leaf_digests2d")
    _cuda.LAUNCHES["leaf_digests2d"] += 1
    return digests


def extend_square(q0: torch.Tensor, m2: rs.EncodeMatrix,
                  encode_into_fn=encode_into) -> torch.Tensor:
    """(k, k, 512) -> EDS with every quadrant encode on K4 (port of
    ``rs_pallas.extend_square``), each written in place in one (2k, 2k, 512)
    buffer (``eds_quadrants``); ``encode_into_fn=encode_into_reference``
    runs the plain version on any device."""
    k = q0.shape[0]
    eds = torch.empty((2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=q0.device)
    eds[:k, :k].copy_(q0)
    for src, dst in eds_quadrants(eds, q0):
        encode_into_fn(src, dst, m2)
    return eds


def eds_quadrants(eds: torch.Tensor, q0: torch.Tensor):
    """The three quadrant encodes of rsmt2d's chain as (src, dst) views of
    ``q0`` (k, k, 512) and the (2k, 2k, 512) ``eds``, in the order they
    must run: Q2 = column-extend Q0, Q1 = row-extend Q0, Q3 = row-extend
    Q2, read in place where it was written. A row extend's shards are
    columns, so its views are the quadrants transposed: shard stride 512,
    cell stride the row stride."""
    k = q0.shape[0]
    q1, q2, q3 = eds[:k, k:], eds[k:, :k], eds[k:, k:]
    return ((q0, q2), (q0.transpose(0, 1), q1.transpose(0, 1)),
            (q2.transpose(0, 1), q3.transpose(0, 1)))
