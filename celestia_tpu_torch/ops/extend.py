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

Routes (``_roots``, as in the JAX package's extend_tpu._roots_of):

- fused dense (the default): the three quadrant encodes run K1
  (``rs_cuda.encode_hash_into``), which returns every parity cell's leaf
  digest with its bytes; Q0's leaves run K2 (``rs_cuda.leaf_digests2d``).
  Each encode reads its operand and writes its parity in place through
  shard and cell strides: into the quadrants of one (2k, 2k, 512) EDS, or,
  on the roots-only core, into buffers no EDS is assembled from;
- fused XOR: the same with K5 (``xor_cuda.encode2d_xor_hash``), the parity
  from the compiled XOR schedule; K5 reads contiguous shards, so its row
  extends transpose and its EDS is assembled with ``cat``;
- unfused dense: ``rs_cuda.extend_square`` builds the EDS in place with K4
  (``rs_cuda.encode_into``), then K2 hashes every leaf of the EDS;
- unfused XOR: the same with K6 (``xor_cuda.encode2d_xor``).

``_rows_cols_only`` is the roots-only core (no EDS output) that
``roots_device``, the batched entries and ``assembled_roots`` (the
proposer's square assembled on the card from the blob arena, one launch
of ``assemble_cuda.assemble_square``) run.

Every route ends in one launch of the tree kernel (``nmt_cuda.nmt_tree``):
it reads the four quadrant tiles of leaf digests in place (on the fused
route K1's [col, row] outputs as transposed views, on the unfused routes
four slices of K2's grid) and the Q0 namespaces as a view of the shares,
and returns the row and column roots, with the row levels for
``eds_row_levels_device``. The device DAH merkle (``merkle_root_pow2``)
is one launch of K3's merkle form (``merkle_cuda.dah_merkle``) on the
(2, 2k, 90) roots as the tree kernel wrote them, for one square or a whole
batch. The leaves of an existing EDS (``eds_roots_device``,
``eds_row_levels_device``) run K2.

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

import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import devledger, faults, integrity, tracing
from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.app import calibration
from celestia_tpu_torch.ops import (
    assemble, assemble_cuda, merkle_cuda, nmt_cuda, rs, rs_cuda, transfers, xor_cuda,
    xor_schedule,
)
from celestia_tpu_torch.ops.nmt_cuda import NMT_NODE_SIZE, leaf_namespaces as _leaf_namespaces


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The kernel functions the routes call. The dense encodes take the
    strided in-place form (``rs_cuda.encode_hash_into``/``encode_into``):
    (src, dst, m2), each a (k, cells, 512) view."""

    encode2d_hash: Callable
    leaf_digests2d: Callable
    dah_merkle: Callable
    encode2d: Callable
    encode2d_xor_hash: Callable
    encode2d_xor: Callable
    nmt_tree: Callable
    assemble_square: Callable
    nmt_tree_rows: Callable


KERNELS = Kernels(rs_cuda.encode_hash_into, rs_cuda.leaf_digests2d,
                  merkle_cuda.dah_merkle, rs_cuda.encode_into,
                  xor_cuda.encode2d_xor_hash, xor_cuda.encode2d_xor,
                  nmt_cuda.nmt_tree, assemble_cuda.assemble_square, nmt_cuda.nmt_tree_rows)
PLAIN = Kernels(rs_cuda.encode_hash_into_reference,
                rs_cuda.leaf_digests2d_reference,
                merkle_cuda.dah_merkle_reference, rs_cuda.encode_into_reference,
                xor_cuda.encode2d_xor_hash_reference,
                xor_cuda.encode2d_xor_reference,
                nmt_cuda.nmt_tree_reference, assemble.assemble_square_reference,
                nmt_cuda.nmt_tree_rows_reference)

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


def merkle_root_pow2(items: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
    """RFC-6962 merkle root of (..., n, 90) items, n = 4k a power of two
    (tendermint merkle.HashFromByteSlices; the DAH hashes its 4k axis roots,
    pkg/da/data_availability_header.go:92-108): one ``dah_merkle`` call
    for every tree of the batch."""
    lead = tuple(items.shape[:-2])
    out = kernels.dah_merkle(items.reshape(-1, *items.shape[-2:]))
    return out.reshape(*lead, 32)


def _eds_leaves(eds: torch.Tensor, kernels: Kernels):
    """The tree kernel's inputs over an existing EDS: K2's (2k, 2k, 8)
    leaf-digest grid as four quadrant slices, and Q0's namespaces read
    from the shares."""
    w = eds.shape[0]
    k = w // 2
    q0_ns = eds[:k, :k, :NAMESPACE_SIZE]
    grid = kernels.leaf_digests2d(eds.reshape(w, w * SHARE_SIZE),
                                  rs_cuda.pad_namespaces(_leaf_namespaces(q0_ns, k)))
    return (grid[:k, :k], grid[:k, k:], grid[k:, :k], grid[k:, k:]), q0_ns


def _eds_tree(eds: torch.Tensor, kernels: Kernels, keep_levels: bool = False):
    """The tree kernel over an existing EDS's leaves. ``keep_levels`` goes
    to ``nmt_tree`` (which then builds the rows alone)."""
    quads, q0_ns = _eds_leaves(eds, kernels)
    return kernels.nmt_tree(quads, q0_ns, keep_levels)


def nmt_roots_of_eds(eds: torch.Tensor, kernels: Kernels = KERNELS):
    """(2k, 2k, 512) EDS -> (row_roots, col_roots), leaf namespaces read
    from Q0 (the JAX spelling takes them as an argument)."""
    roots, _levels = _eds_tree(eds, kernels)
    return roots[0], roots[1]


def _new_eds(q0: torch.Tensor) -> torch.Tensor:
    """A (2k, 2k, 512) buffer with Q0 in its quadrant (one copy); the
    encodes write the other three in place."""
    k = q0.shape[0]
    eds = torch.empty((2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=q0.device)
    eds[:k, :k].copy_(q0)
    return eds


def _scratch_quadrants(q0: torch.Tensor):
    """The three quadrant encodes as (src, dst) views when no EDS is kept:
    Q2 in a buffer of its own, read by Q3 in place; Q1's and Q3's bytes
    only feed their leaf hashes, so each is written as its encode's
    (shards, cells) buffer, unread."""
    q1, q2, q3 = (torch.empty_like(q0) for _ in range(3))
    return ((q0, q2), (q0.transpose(0, 1), q1), (q2.transpose(0, 1), q3))


def _roots_of_fused_dense(x0: torch.Tensor, m2: rs.EncodeMatrix, kernels: Kernels,
                          keep_eds: bool):
    """(k, k, 512) contiguous -> (eds or None, roots (2, 2k, 90)) on the
    fused dense route: K2 on Q0's leaves, K1 for the three quadrant
    encodes, each reading its operand and writing its parity in place
    through strides (``rs_cuda.eds_quadrants``), then the tree kernel.
    With ``keep_eds`` the parity lands in one (2k, 2k, 512) EDS, Q0 copied
    into it once; without, the EDS is never assembled."""
    k = x0.shape[0]
    eds = _new_eds(x0) if keep_eds else None
    quads = rs_cuda.eds_quadrants(eds, x0) if keep_eds else _scratch_quadrants(x0)
    q0_ns = x0[..., :NAMESPACE_SIZE]
    x2 = x0.reshape(k, k * SHARE_SIZE)
    d0 = kernels.leaf_digests2d(x2, rs_cuda.own_namespaces(x2))  # Q0 names its own cells
    # K1's digests are [shard, cell]: [row, col] for Q2, [col, row] for Q1, Q3
    d2, d1t, d3t = (kernels.encode2d_hash(src, dst, m2) for src, dst in quads)
    roots, _levels = kernels.nmt_tree((d0, d1t.transpose(0, 1), d2, d3t.transpose(0, 1)), q0_ns)
    return eds, roots


def _roots_of_fused_xor(shares: torch.Tensor, kernels: Kernels, keep_eds: bool):
    """(k, k, 512) -> (eds or None, roots) on the fused XOR route: K5 for
    the quadrant encodes. K5 reads contiguous (k, N) shards, so the row
    extends transpose in and out and the EDS is assembled with ``cat``."""
    k = shares.shape[0]
    ops = xor_cuda.schedule_operands(k, shares.device)

    def encode(x):
        return kernels.encode2d_xor_hash(x, ops)

    n = k * SHARE_SIZE
    x0 = shares.reshape(k, n)
    q0_ns = shares[..., :NAMESPACE_SIZE]
    d0 = kernels.leaf_digests2d(x0, rs_cuda.own_namespaces(x0))  # [row, col]
    q2f, d2 = encode(x0)  # native: [row, col]
    q2 = q2f.reshape(k, k, SHARE_SIZE)
    q1t, d1t = encode(shares.transpose(0, 1).reshape(k, n))  # [col, row]
    q3t, d3t = encode(q2.transpose(0, 1).reshape(k, n))  # [col, row]
    eds = None
    if keep_eds:
        q1 = q1t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
        q3 = q3t.reshape(k, k, SHARE_SIZE).transpose(0, 1)
        eds = torch.cat([torch.cat([shares, q1], dim=1), torch.cat([q2, q3], dim=1)], dim=0)
    roots, _levels = kernels.nmt_tree((d0, d1t.transpose(0, 1), d2, d3t.transpose(0, 1)), q0_ns)
    return eds, roots


def _roots(shares: torch.Tensor, m2: rs.EncodeMatrix, fused: bool | None = None,
           xor: bool | None = None, kernels: Kernels = KERNELS, keep_eds: bool = True):
    """(k, k, 512) contiguous -> (eds, roots (2, 2k, 90): the row roots, then
    the column roots, as the tree kernel writes them) on the route that
    ``fused`` and ``xor`` name; None resolves each through
    ``_fused_active`` / ``_xor_active``. Byte-identical any way. Without
    ``keep_eds`` the EDS is None: the fused routes do not assemble it, the
    unfused ones build it as the leaf hash's input and drop it."""
    k = shares.shape[0]
    if fused is None:
        fused = _fused_active(k)
    if xor is None:
        xor = _xor_active(k)
    if fused and xor:
        return _roots_of_fused_xor(shares, kernels, keep_eds)
    if fused:
        return _roots_of_fused_dense(shares, m2, kernels, keep_eds)
    eds = _unfused_eds(shares, m2, xor, kernels)
    roots, _levels = _eds_tree(eds, kernels)
    return (eds if keep_eds else None), roots


def _unfused_eds(shares: torch.Tensor, m2: rs.EncodeMatrix, xor: bool, kernels: Kernels):
    """The unfused routes' EDS: three encodes without the hash (K4, or K6
    through the XOR schedule)."""
    if xor:
        return xor_cuda.extend_square_xor(
            shares, xor_cuda.schedule_operands(shares.shape[0], shares.device),
            kernels.encode2d_xor)
    return rs_cuda.extend_square(shares, m2, kernels.encode2d)


def _rows_cols_only(shares: torch.Tensor, m2: rs.EncodeMatrix, fused: bool | None = None,
                    xor: bool | None = None, kernels: Kernels = KERNELS):
    """The one roots-only core: (k, k, 512) -> (row_roots, col_roots), the
    EDS never an output. Every roots-only entry (``roots_device``,
    ``roots_only_batched``, ``batched_roots_device``) runs it, so the
    replay verifier's roots and the proposer's cannot diverge."""
    _eds, roots = _roots(shares, m2, fused=fused, xor=xor, kernels=kernels, keep_eds=False)
    return roots[0], roots[1]


def extend_and_root(shares: torch.Tensor, m2: rs.EncodeMatrix,
                    kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> (eds (2k,2k,512), row_roots (2k,90),
    col_roots (2k,90), dah_hash (32,)). The merkle reads the tree kernel's
    (2, 2k, 90) roots as they lie: no message or copy is built for it."""
    eds, roots = _roots(shares, m2, kernels=kernels)
    dah = merkle_root_pow2(roots.reshape(-1, NMT_NODE_SIZE), kernels)
    return eds, roots[0], roots[1], dah


def extend_and_root_batched(shares: torch.Tensor, m2: rs.EncodeMatrix,
                            kernels: Kernels = KERNELS):
    """(B, k, k, 512) -> batched (eds, row_roots, col_roots, dah): the
    multi-block form (catch-up, replay), one square after another on the
    device's stream, then one merkle launch for the B DAHs."""
    eds, roots = zip(*(_roots(s, m2, kernels=kernels) for s in shares))
    roots = torch.stack(roots)  # (B, 2, 2k, 90)
    dah = merkle_root_pow2(roots.reshape(roots.shape[0], -1, NMT_NODE_SIZE), kernels)
    return torch.stack(eds), roots[:, 0], roots[:, 1], dah


def _batch_chunk(k: int, b: int) -> int:
    """Squares per chunk of a batched roots call, the JAX package's rule:
    the whole batch for k <= 64, at most 2 above (there it bounded the
    TPU's working set), the largest divisor of b within the cap."""
    cap = b if k <= 64 else 2
    chunk = min(cap, b)
    while b % chunk:
        chunk -= 1
    return chunk


def roots_only_batched(shares: torch.Tensor, m2: rs.EncodeMatrix,
                       kernels: Kernels = KERNELS):
    """(B, k, k, 512) -> batched (row_roots, col_roots), no EDS output: the
    replay verifier compares roots only. Each square runs the roots-only
    core in turn on the device's stream, so the working set is one
    square's."""
    pairs = [_rows_cols_only(s, m2, kernels=kernels) for s in shares]
    return torch.stack([r for r, _c in pairs]), torch.stack([c for _r, c in pairs])


# ------------------------------------------------------------------ #
# Host entries: numpy (or torch) in, numpy out, on the resolved device.
# Each wraps its work as the JAX package's entries do (extend_tpu.py:521-604,
# :1021-1115): an ``extend.device`` span with ``extend.stage`` and
# ``extend.rs_nmt`` children, the ``device.extend`` fault site, and on the
# EDS-returning resident entries the ``device.extend.output`` site and the
# integrity audit. ``backend`` names the card (or "cpu"). The square is
# staged through ``transfers.device_put_chunked`` (site ``extend.stage``),
# which adds a ``transfer.extend.stage`` span under ``extend.stage``, as the
# JAX package's sharded staging does.
#
# The mesh routing (the JAX package's extend_tpu.py:380-520): while an
# operator has configured a mesh (``parallel.configure_mesh``), the entries
# below route a square whose rows the mesh's 'sp' divides through the
# row-sharded spelling of ``celestia_tpu_torch.parallel``, with the same
# bytes; another square falls back to the single-device route, as in the
# JAX package. The mesh places the work: the square is staged row-sharded
# onto the devices of the mesh's first dp row
# (``transfers.device_put_sharded_rows``) and the results gather onto its
# first device, which the spans' ``backend`` names. The mesh runs the
# wrappers (``KERNELS``), so it routes only a call that asks for them on the
# device the mesh gathers onto (``device`` resolved first, None = CUDA); a
# call naming other kernels (``PLAIN``) or another device takes the
# single-device route with what it names (the JAX entries take neither
# argument). The state lives here because ``parallel`` imports this module;
# the builders import ``parallel`` when they build.

_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Install (None clears) the process-wide mesh; public entry
    ``parallel.configure_mesh``. Drops the row-sharded builders' caches,
    whose programs hold the mesh they were built for."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    for builder in (_rowsharded, _rowsharded_roots, _rowsharded_levels, _rowsharded_full):
        builder.cache_clear()


def active_mesh():
    return _ACTIVE_MESH


def _mesh_if_divisible(n_rows: int):
    """The active mesh when its 'sp' divides n_rows, else None: the caller
    falls back to the single-device route."""
    m = _ACTIVE_MESH
    if m is None or n_rows % m.shape["sp"]:
        return None
    return m


def _mesh_for(n_rows: int, dev: torch.device, kernels: Kernels):
    """The active mesh when it routes this call: its 'sp' divides n_rows,
    the call asks for the wrappers and for the device the mesh gathers onto.
    Else None: the call takes the single-device route with its own kernels
    on its own device."""
    m = _mesh_if_divisible(n_rows)
    if m is None or kernels is not KERNELS or not device_mod.same(dev, m.first):
        return None
    return m


def _mesh_compile_key():
    """The mesh part of the row-sharded builders' key: a flip of the mesh's
    shape is a new build at the same k."""
    m = _ACTIVE_MESH
    return None if m is None else tuple(sorted(m.shape.items()))


@functools.lru_cache(maxsize=8)
@devledger.instrument_builder("extend.rowsharded", key_extra=_mesh_compile_key)
def _rowsharded(k: int):
    from celestia_tpu_torch import parallel

    return parallel.extend_and_root_rowsharded(_ACTIVE_MESH, k)


@functools.lru_cache(maxsize=8)
@devledger.instrument_builder("extend.rowsharded_roots", key_extra=_mesh_compile_key)
def _rowsharded_roots(k: int):
    """The roots-only spelling: no EDS row is assembled, as roots_device's
    contract asks."""
    from celestia_tpu_torch import parallel

    return parallel.roots_rowsharded(_ACTIVE_MESH, k)


@functools.lru_cache(maxsize=8)
@devledger.instrument_builder("extend.rowsharded_levels", key_extra=_mesh_compile_key)
def _rowsharded_levels(k: int):
    from celestia_tpu_torch import parallel

    return parallel.eds_row_level_buffer_rowsharded(_ACTIVE_MESH, k)


@functools.lru_cache(maxsize=8)
@devledger.instrument_builder("extend.rowsharded_full", key_extra=_mesh_compile_key)
def _rowsharded_full(k: int):
    from celestia_tpu_torch import parallel

    return parallel.extend_root_levels_rowsharded(_ACTIVE_MESH, k)


def _stage_sharded(arr, mesh, site: str = "extend.stage") -> transfers.RowShards:
    """A square (or EDS) row-sharded over the devices of the mesh's first dp
    row: host rows land on their shards through the telemetered transfer
    (``site``); a device tensor is split on the device, without a host round
    trip; ``RowShards`` already on those devices pass through."""
    devices = list(mesh.devices[0])
    if isinstance(arr, transfers.RowShards):
        if arr.devices != devices:
            raise ValueError(f"row shards on {arr.devices}, the mesh row is {devices}")
        return arr
    if arr.shape[0] % len(devices):
        raise ValueError(f"{arr.shape[0]} rows not divisible by sp={len(devices)}")
    if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
        per = arr.shape[0] // len(devices)
        return transfers.RowShards(arr[i * per:(i + 1) * per].to(d).contiguous()
                                   for i, d in enumerate(devices))
    host = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if host.dtype != np.uint8:
        raise ValueError(f"expected uint8 bytes, got {host.dtype}")
    return transfers.device_put_sharded_rows(host, mesh, site=site)


def _square_size(shares) -> int:
    shape = tuple(shares.shape)  # a host array, a tensor or transfers.RowShards
    k = shape[0]
    if (len(shape) != 3 or shape[1] != k or shape[2] != SHARE_SIZE
            or k < 1 or k & (k - 1) or k > DEFAULT_SQUARE_SIZE_UPPER_BOUND):
        raise ValueError(f"shares must be (k, k, {SHARE_SIZE}) with k a power "
                         f"of two <= {DEFAULT_SQUARE_SIZE_UPPER_BOUND}, got {shape}")
    return k


def _stage(arr, dev: torch.device) -> torch.Tensor:
    """Host array or tensor -> contiguous uint8 tensor on dev. Host bytes
    go through the chunked transfer; a tensor already on a device does not
    cross the host."""
    if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
        if arr.dtype != torch.uint8:
            raise ValueError(f"expected uint8 bytes, got {arr.dtype}")
        return arr.to(dev).contiguous()
    host = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if host.dtype != np.uint8:
        raise ValueError(f"expected uint8 bytes, got {host.dtype}")
    return transfers.device_put_chunked(host, dev, site="extend.stage")


def _eds_size(eds) -> int:
    w = int(eds.shape[0])
    if tuple(eds.shape) != (w, w, SHARE_SIZE) or w < 2 or w & (w - 1):
        raise ValueError(f"eds must be (2k, 2k, {SHARE_SIZE}), got {tuple(eds.shape)}")
    return w // 2


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _backend(dev: torch.device) -> str:
    """The ``backend`` attribute of the spans: the card's name, or "cpu"."""
    if dev.type == "cuda":
        return _card_name(dev.index if dev.index is not None else torch.cuda.current_device())
    return dev.type


def _numpy(*tensors: torch.Tensor):
    return tuple(t.cpu().numpy() for t in tensors)


@contextlib.contextmanager
def _extend_device(entry: str, dev: torch.device, k: int, mesh=None):
    """The ``extend.device`` span and the ``device.extend`` fault site;
    yields the backend name (the mesh's first device's when a mesh routes
    the call)."""
    backend = _backend(dev if mesh is None else mesh.first)
    with tracing.span("extend.device", backend=backend, k=k, entry=entry):
        faults.fire("device.extend", entry=entry)
        yield backend


def _staged(shares, dev: torch.device, k: int, backend: str, mesh=None):
    with tracing.span("extend.stage", backend=backend, k=k):
        return _stage(shares, dev) if mesh is None else _stage_sharded(shares, mesh)


def roots_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (row_roots, col_roots), through the
    roots-only core: the EDS is never assembled."""
    dev = device_mod.resolve(device)
    k = _square_size(shares)
    mesh = _mesh_for(k, dev, kernels)
    with _extend_device("roots_device", dev, k, mesh) as backend:
        x = _staged(shares, dev, k, backend, mesh)
        with tracing.span("extend.rs_nmt", backend=backend, k=k, fused="rs+nmt",
                          sharded=mesh is not None):
            t0 = time.perf_counter()
            if mesh is not None:
                rows, cols = _rowsharded_roots(k)(x)
            else:
                rows, cols = _rows_cols_only(x, rs.encode_matrix(k, dev), kernels=kernels)
            transfers.profile_fence(cols, "roots_device", t0, k=k)
            return _numpy(rows, cols)


def _extend_resident(entry: str, shares, device, kernels: Kernels):
    """The resident extend with the JAX package's envelope: the EDS (device
    tensor), row and column roots (device tensors), after the output fault
    site and the audit."""
    dev = device_mod.resolve(device)
    k = _square_size(shares)
    mesh = _mesh_for(k, dev, kernels)
    with _extend_device(entry, dev, k, mesh) as backend:
        x = _staged(shares, dev, k, backend, mesh)
        with tracing.span("extend.rs_nmt", backend=backend, k=k, fused="rs+nmt",
                          sharded=mesh is not None):
            t0 = time.perf_counter()
            if mesh is not None:
                eds, rows, cols, _dah = _rowsharded(k)(x)
            else:
                eds, (rows, cols) = _roots(x, rs.encode_matrix(k, dev), kernels=kernels)
            transfers.profile_fence(cols, entry, t0, k=k)
        # SDC model: the result is damaged in flight; the audit must catch it
        flip = faults.fire("device.extend.output", entry=entry)
        if flip is not None:
            eds = flip(eds)
        eng = integrity.get()
        if eng.enabled:
            integrity.audit_or_raise(eng, eds, k, site="device.extend.output",
                                     where="device.extend")
        return eds, rows, cols


def extend_roots_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (eds, row_roots, col_roots); the caller
    computes the DAH hash on the host (da module)."""
    return _numpy(*_extend_resident("extend_roots_device", shares, device, kernels))


def extend_roots_device_resident(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> (eds tensor on the device, rows numpy, cols numpy).

    The EDS stays a device buffer; only the axis roots (2·2k·90 bytes)
    cross to the host. ref: app/extend_block.go:14."""
    eds, rows, cols = _extend_resident("extend_roots_device_resident", shares, device, kernels)
    return (eds, *_numpy(rows, cols))


def extend_and_root_device(shares, device=None, kernels: Kernels = KERNELS):
    """(k, k, 512) uint8 -> numpy (eds, row_roots, col_roots, dah), the DAH
    hash computed on the device."""
    dev = device_mod.resolve(device)
    k = _square_size(shares)
    mesh = _mesh_for(k, dev, kernels)
    with _extend_device("extend_and_root_device", dev, k, mesh) as backend:
        x = _staged(shares, dev, k, backend, mesh)
        with tracing.span("extend.rs_nmt", backend=backend, k=k, fused="rs+nmt+dah",
                          sharded=mesh is not None):
            t0 = time.perf_counter()
            if mesh is not None:
                out = _rowsharded(k)(x)
            else:
                out = extend_and_root(x, rs.encode_matrix(k, dev), kernels)
            transfers.profile_fence(out[3], "extend_and_root_device", t0, k=k)
            return _numpy(*out)


def batched_roots_device(shares, device=None, kernels: Kernels = KERNELS):
    """The replay verifier's entry: B squares of (k, k, 512) uint8 (a list,
    or a stacked (B, k, k, 512) array) -> numpy (row_roots (B, 2k, 90),
    col_roots (B, 2k, 90)).

    Squares go in chunks of ``_batch_chunk(k, B)`` (a ragged tail a square
    at a time): each square of a chunk is staged on its own and runs the
    roots-only core on the device's stream, and the chunk's roots come back
    in one D2H copy once every chunk is queued. No square is copied into a
    stack on the host."""
    dev = device_mod.resolve(device)
    b = len(shares)
    if b == 0:
        raise ValueError("batched_roots_device needs at least one square")
    k = _square_size(shares[0])
    if any(tuple(sq.shape) != (k, k, SHARE_SIZE) for sq in shares):
        raise ValueError(f"every square must be ({k}, {k}, {SHARE_SIZE})")
    with tracing.span("extend.device", backend=_backend(dev), k=k, batch=b,
                      entry="batched_roots_device"):
        m2 = rs.encode_matrix(k, dev)
        chunk = _batch_chunk(k, b)
        full = b - b % chunk
        groups = [range(g, g + chunk) for g in range(0, full, chunk)]
        groups += [range(i, i + 1) for i in range(full, b)]
        t0 = time.perf_counter()
        outs = []  # (squares, 2, 2k, 90) a chunk, fetched after the last is queued
        for group in groups:
            pairs = [_rows_cols_only(_stage(shares[i], dev), m2, kernels=kernels)
                     for i in group]
            outs.append(torch.stack([torch.stack(pair) for pair in pairs]))
        transfers.profile_fence(outs[-1], "batched_roots_device", t0, k=k, batch=b)
        host = np.concatenate([o.cpu().numpy() for o in outs])  # one D2H a chunk
        return host[:, 0], host[:, 1]


def eds_roots_device(eds, device=None, kernels: Kernels = KERNELS):
    """NMT axis roots of an existing (2k, 2k, 512) EDS (host array or
    device tensor) -> numpy (row_roots, col_roots). Leaf namespaces are
    read from Q0 on the device."""
    dev = device_mod.resolve(device)
    k = _eds_size(eds)
    with tracing.span("extend.nmt", backend=_backend(dev), k=k, entry="eds_roots_device"):
        t0 = time.perf_counter()
        rows, cols = nmt_roots_of_eds(_stage(eds, dev), kernels)
        transfers.profile_fence(cols, "eds_roots_device", t0, k=k)
        return _numpy(rows, cols)


def eds_row_levels_device(eds, device=None, kernels: Kernels = KERNELS) -> list[np.ndarray]:
    """Every row-tree level of an existing (2k, 2k, 512) EDS:
    [leaf nodes (2k, 2k, 90), (2k, k, 90), ..., roots (2k, 1, 90)] as
    numpy. levels[L][r, j] is row r's subtree node over leaves
    [j·2^L, (j+1)·2^L)."""
    dev = device_mod.resolve(device)
    k = _eds_size(eds)
    mesh = _mesh_for(2 * k, dev, kernels)  # sp shards the 2k EDS rows here
    with tracing.span("extend.nmt_levels", backend=_backend(dev if mesh is None else mesh.first),
                      k=k, entry="eds_row_levels_device", sharded=mesh is not None):
        t0 = time.perf_counter()
        if mesh is not None:
            levels = _rowsharded_levels(k)(_stage_sharded(eds, mesh))
        else:
            _roots, levels = _eds_tree(_stage(eds, dev), kernels, keep_levels=True)
        transfers.profile_fence(levels, "eds_row_levels_device", t0, k=k)
        return nmt_cuda.split_levels(levels.cpu().numpy(), k)  # one D2H copy


# ------------------------------------------------------------------ #
# Device-in, device-out entries for the block pipeline (node/pipeline.py),
# the JAX package's extend_and_root_staged and extend_root_levels_staged
# (celestia_tpu/ops/extend_tpu.py:489, :502) on one device: the square is
# already staged and the results stay on its device, so the legs of
# consecutive blocks overlap. The launches queue on the caller's current
# stream and return before the card is done.


def _staged_mesh(staged, kernels: Kernels):
    """(k, the mesh that routes it or None) of a staged square: a tensor as
    ``_mesh_for`` decides on its device; row shards on the active mesh
    alone, through the wrappers."""
    k = _square_size(staged)
    if not isinstance(staged, transfers.RowShards):
        return k, _mesh_for(k, staged.device, kernels)
    mesh = _mesh_if_divisible(k)
    if mesh is None or kernels is not KERNELS:
        raise ValueError("row shards run on the active mesh alone, through the wrappers")
    return k, mesh


def extend_and_root_staged(dev, kernels: Kernels = KERNELS):
    """A staged (k, k, 512) uint8 square -> (eds (2k, 2k, 512), row_roots
    (2k, 90), col_roots (2k, 90), dah (32,)), all on its device. Routed
    through the row-sharded spelling when the active mesh routes it
    (``_mesh_for``: the square on the device the mesh gathers onto), or when
    ``dev`` is ``transfers.RowShards`` staged on the mesh; the results then
    lie on the mesh's first device."""
    k, mesh = _staged_mesh(dev, kernels)
    if mesh is not None:
        return _rowsharded(k)(_stage_sharded(dev, mesh))
    return extend_and_root(dev, rs.encode_matrix(k, dev.device), kernels)


def extend_root_levels_staged(dev: torch.Tensor, kernels: Kernels = KERNELS):
    """A staged (k, k, 512) uint8 square -> (eds, row_roots, col_roots, dah,
    levels), all on its device, as ``extend_and_root_staged`` and
    ``eds_row_levels_device`` give them: levels a tuple of views of one
    flat buffer, [leaf nodes (2k, 2k, 90), (2k, k, 90), ..., (2k, 1, 90)].
    The JAX package's single-device spelling, the unfused pair, on the
    port's unfused route: the three encodes without the hash, then K2 over
    the EDS, so every cell is hashed once, and the tree twice over that one
    leaf grid: both axes' roots, which the DAH merkles, and the row levels
    (the tree keeps levels for the rows alone). Where the active mesh routes
    the square, as in ``extend_and_root_staged``, this is the mesh's fused
    pass (Row C, ``parallel.extend_root_levels_rowsharded``): each shard's
    leaves hashed once feed its row levels and the column roots."""
    k, mesh = _staged_mesh(dev, kernels)
    if mesh is not None:
        return _rowsharded_full(k)(_stage_sharded(dev, mesh))
    eds = _unfused_eds(dev, rs.encode_matrix(k, dev.device), _xor_active(k), kernels)
    quads, q0_ns = _eds_leaves(eds, kernels)
    roots, _levels = kernels.nmt_tree(quads, q0_ns)
    _rows, levels = kernels.nmt_tree(quads, q0_ns, True)
    dah = merkle_root_pow2(roots.reshape(-1, NMT_NODE_SIZE), kernels)
    return eds, roots[0], roots[1], dah, tuple(nmt_cuda.split_levels(levels, k))


# ------------------------------------------------------------------ #
# Device-side square assembly from the resident blob arena
# (ops/blob_pool.py), the JAX package's extend_tpu.assembled_roots
# (celestia_tpu/ops/extend_tpu.py:838). With the blob bytes already on the
# card, only per-blob and host-cell metadata and the deduplicated host
# shares cross per proposal; the assembled square feeds the roots-only core
# as it lies on the card and never exists on the host.


def _stage_meta(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One metadata block to the card at site ``proposal.stage``; an empty
    block crosses nothing."""
    if arr.size == 0:
        return torch.from_numpy(arr).to(dev)
    return transfers.device_put_chunked(arr, dev, site="proposal.stage")


def assembled_roots(
    arena,
    host_shares: np.ndarray,    # (H, 512) uint8 — dedup'd host table
    host_pos: np.ndarray,       # (Hc,) int32 — cell indexes of host cells, ascending
    host_row: np.ndarray,       # (Hc,) int32 — row into host_shares
    blob_start: np.ndarray,     # (B,) int32 — first cell per resident blob, ASCENDING
    blob_nshares: np.ndarray,   # (B,) int32
    blob_off: np.ndarray,       # (B,) int32 — absolute arena offsets
    blob_len: np.ndarray,       # (B,) int32 — blob byte lengths
    ns_table: np.ndarray,       # (B, 29) uint8
    k: int,
    kernels: Kernels = KERNELS,
):
    """Assemble the (k, k, 512) square on the arena's device and return
    numpy (row_roots, col_roots): the roots-only proposal path.

    ``arena`` is a ``blob_pool.DeviceBlobArena`` (the launch then waits on
    its inserts) or its byte tensor; the square is built where it lies (a
    CPU arena runs the plain versions). The upload is O(#blobs + #host
    cells), not O(k²). The JAX package pads its counts to powers of two to
    bound its jit cache; the kernel takes the true counts, so nothing is
    padded. The caller holds the arena's lock until this returns."""
    if k < 1 or k & (k - 1) or k > DEFAULT_SQUARE_SIZE_UPPER_BOUND:
        raise ValueError(f"k must be a power of two <= {DEFAULT_SQUARE_SIZE_UPPER_BOUND}, "
                         f"got {k}")
    s = k * k
    starts_arr = np.asarray(blob_start, np.int64)
    if len(starts_arr) > 1 and not np.all(np.diff(starts_arr) > 0):
        # the blob lookup misattributes cells if starts are not strictly
        # ascending: fail loudly rather than sign corrupt roots
        raise ValueError("blob_start must be strictly ascending")
    pos = np.asarray(host_pos, np.int64)
    rows = np.asarray(host_row, np.int64)
    n_h = len(host_shares)
    if len(pos) != len(rows) or (len(pos) and (
            pos[0] < 0 or pos[-1] >= s or np.any(np.diff(pos) <= 0)
            or rows.min() < 0 or rows.max() >= n_h)):
        raise ValueError("host_pos must be strictly ascending cells of the square and "
                         "host_row rows of host_shares, one each")
    tensor = getattr(arena, "arena", arena)
    dev = tensor.device
    with tracing.span("extend.assemble", backend="gpu" if dev.type == "cuda" else dev.type,
                      k=k, blobs=len(ns_table), host_cells=len(pos)):
        t0 = time.perf_counter()
        hs_dev = _stage_meta(np.ascontiguousarray(host_shares, np.uint8).reshape(
            n_h, SHARE_SIZE), dev)
        ns_dev = _stage_meta(np.ascontiguousarray(ns_table, np.uint8).reshape(
            -1, NAMESPACE_SIZE), dev)
        bm_dev = _stage_meta(np.stack([np.asarray(a, np.int32).reshape(-1) for a in
                                       (blob_start, blob_nshares, blob_off, blob_len)]), dev)
        hsp_dev = _stage_meta(np.stack([pos.astype(np.int32), rows.astype(np.int32)]), dev)
        if hasattr(arena, "ready"):
            arena.ready()  # the launch follows every insert it may read
        square = kernels.assemble_square(tensor, hs_dev, bm_dev, ns_dev, hsp_dev, k)
        row_roots, col_roots = _rows_cols_only(square, rs.encode_matrix(k, dev),
                                               kernels=kernels)
        transfers.profile_fence(col_roots, "assembled_roots", t0, k=k)
        return _numpy(row_roots, col_roots)
