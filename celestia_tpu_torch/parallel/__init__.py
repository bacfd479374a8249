"""Multi-GPU: the row-sharded extend over a device mesh (port of the JAX
package's parallel/__init__.py).

The scaling axes are the JAX package's:

- dp (data parallel): independent squares across devices (block replay,
  proposal bursts, a node catching up);
- sp: the rows of one square across devices. Row extension and the row
  trees are local to a shard; the column extension contracts over the
  sharded row axis, and the column trees need every row's leaf digests.

``Mesh`` is a (dp, sp) array of ``torch.device``. An explicit device list
may name a device more than once: the port's spelling of the JAX package's
virtual devices, so one card runs every shard's kernels on sub-blocks of
the square, in turn, with bytes equal to the single-device path's. Across
processes, ``parallel.multihost`` carries dp over ``torch.distributed``; sp
stays inside a process.

The collectives inside a process are device-to-device copies into buffers
on the receiving shard's device (``COLLECTIVE_BYTES`` counts their bytes):

- all_gather: every shard's Q0 rows onto each shard (the dense spelling's
  column encode);
- reduce_scatter: each shard's rows of every shard's Q2 partial parity,
  combined there by XOR (the XOR spelling);
- gather: the outputs onto the mesh's first device, in global row order
  (all top rows, then all bottom rows, as the JAX package's ``reassemble``
  builds them). The EDS, the leaf-digest grid, the roots, the DAH and the
  row levels end up there as one tensor each, because every consumer of a
  resident EDS takes one tensor; the JAX package keeps a logically global
  sharded array instead.

Each shard's work is queued under its device's guard on that device's
current stream; PyTorch orders a copy between two devices after the work
queued on both devices' current streams (a two-way event barrier), so the
shards of distinct cards overlap and those of one card serialize. Nothing
falls back: a shard whose kernel fails to launch raises.

The local spellings of the contraction (``_Shard``):

- dense: the row extends of a shard's rows (Q1, and Q3 of its Q2 rows) run
  K1 (``rs_cuda.encode_hash_into``) on the row block transposed in as its
  (k, rows_per, 512) shards, writing their parity in place. Leopard's FFT
  needs every row of a column, so Q2 gathers Q0's rows onto each shard and
  runs one whole column encode there (a zero-padded partial would cost a
  whole encode anyway), then keeps its own rows;
- XOR: the row extends run K5 on the full schedule; the Q2 partial is the
  shard's column-block schedule (``xor_schedule.sharded_schedule_arrays``)
  through the plain ``xor_schedule.apply_planes``, as the JAX package runs
  jnp ``apply_planes``, and the partials combine by XOR.

Every shard hashes each of its leaves once: K2 for its Q0 cells (each under
its own namespace), K1's digests for its parity cells (the XOR spelling
hashes its Q2 rows with K2 under the parity namespace). The row trees of a
shard's rows are the tree kernel's row-block mode (``nmt_cuda.nmt_tree_rows``)
over its own digest tiles; the column trees need the gathered (2k, 2k) digest
grid (2 MiB at k = 128). All outputs are byte-identical to the single-device
path's.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import extend, nmt_cuda, rs, rs_cuda, xor_cuda
from celestia_tpu_torch.ops import xor_schedule
from celestia_tpu_torch.ops.nmt_cuda import NMT_NODE_SIZE

AXES = ("dp", "sp")

# bytes each in-process collective copied into a receiving buffer
COLLECTIVE_BYTES = {"all_gather": 0, "reduce_scatter": 0, "gather": 0}


def reset_collective_bytes() -> None:
    for name in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[name] = 0


class Mesh:
    """An array of ``torch.device`` with named axes, ``(dp, sp)`` from
    ``make_mesh``. ``shape`` maps each axis to its size, as a JAX mesh's
    does. ``process_index`` and ``process_count`` place a process's mesh in
    a multi-process run (``multihost.process_mesh``); the devices are the
    process's own."""

    def __init__(self, devices: np.ndarray, axis_names=AXES, process_index: int = 0,
                 process_count: int = 1):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.process_index = process_index
        self.process_count = process_count

    @property
    def first(self) -> torch.device:
        """The device the combined outputs are gathered onto."""
        return self.devices.flat[0]

    def row(self, r: int) -> "Mesh":
        """Dp row ``r`` as a mesh of its own, (1, sp)."""
        return Mesh(self.devices[r:r + 1], self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def device_array(devices, shape) -> np.ndarray:
    """An object array of ``torch.device`` of the given shape."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def make_mesh(dp: int, sp: int, devices=None) -> Mesh:
    """A (dp, sp) mesh over ``devices``: every CUDA device by default. An
    explicit list may repeat a device (virtual shards on one card, or
    ``[torch.device("cpu")] * n`` on the CPU)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < dp * sp:
        raise ValueError(f"need {dp * sp} devices, have {len(devices)}")
    return Mesh(device_array(list(devices)[: dp * sp], (dp, sp)))


def configure_mesh(mesh: Mesh | None) -> None:
    """Install (or clear, with None) the process-wide active mesh: while it
    is set, the roots and levels entries of ``ops/extend.py`` route through
    the row-sharded spelling whenever the mesh's sp divides the square's
    rows, with bytes equal to the single-device route's."""
    if mesh is not None and "sp" not in mesh.shape:
        raise ValueError("mesh must carry an 'sp' axis (see make_mesh)")
    extend.set_active_mesh(mesh)


def _on(dev: torch.device):
    """The device guard for a shard's work (the kernels' C entries set the
    current device; the guard restores the caller's)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _copy(dst: torch.Tensor, src: torch.Tensor, collective: str) -> None:
    """One collective copy into a receiving buffer, counted."""
    dst.copy_(src)
    COLLECTIVE_BYTES[collective] += src.numel() * src.element_size()


def _parity_ns(rows: int, cells: int, dev: torch.device) -> torch.Tensor:
    """K2's namespace operand for cells under the parity namespace."""
    parity = torch.as_tensor(rs_cuda.PARITY_NS, device=dev)
    return rs_cuda.pad_namespaces(parity.expand(rows, cells, NAMESPACE_SIZE))


@dataclasses.dataclass
class _Shard:
    """One shard's rows of the EDS and their leaf digests: ``tiles`` are its
    (rows_per, k, 8) digest tiles of Q0, Q1, Q2 and Q3 in [row, col]
    orientation; ``top`` and ``bottom`` its (rows_per, 2k, 512) EDS rows
    (None when no EDS is kept); ``x`` its Q0 rows."""

    x: torch.Tensor
    tiles: tuple
    top: torch.Tensor | None
    bottom: torch.Tensor | None


class _RowSharded:
    """The row-sharded program of one square size on one mesh row: the
    per-shard operands (encode matrices, XOR schedules), built once."""

    def __init__(self, mesh: Mesh, k: int, xor: bool | None):
        sp = mesh.shape["sp"]
        if k % sp:
            raise ValueError(f"square size {k} not divisible by sp={sp}")
        self.k, self.sp, self.rows_per = k, sp, k // sp
        self.xor = extend._xor_active(k) if xor is None else bool(xor)
        self.mesh = mesh
        self.devices = list(mesh.devices[0])
        self.first = self.devices[0]
        if self.xor:
            template, fa, fb, ri = xor_schedule.sharded_schedule_arrays(k, sp)
            self.ops = [xor_cuda.schedule_operands(k, d) for d in self.devices]
            self.col_index = [xor_schedule.schedule_index(template, d, fa[i], fb[i], ri[i])
                              for i, d in enumerate(self.devices)]
        else:
            self.m2 = [rs.encode_matrix(k, d) for d in self.devices]

    # -- the shards ------------------------------------------------------ #

    def _encode_rows(self, i: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Row-extend shard i's (rows_per, k, 512) rows ``src``, parity into
        the view ``dst``; returns the parity's digests, [row, col]."""
        k, n = self.k, self.rows_per * SHARE_SIZE
        if self.xor:
            parity, d = xor_cuda.encode2d_xor_hash(
                src.transpose(0, 1).reshape(k, n), self.ops[i])
            dst.copy_(parity.view(k, self.rows_per, SHARE_SIZE).transpose(0, 1))
        else:
            d = rs_cuda.encode_hash_into(src.transpose(0, 1), dst.transpose(0, 1), self.m2[i])
        return d.transpose(0, 1)

    def _q2_dense(self, xs: list[torch.Tensor]):
        """The dense Q2: every shard gathers Q0 and column-encodes it whole;
        each keeps its rows and their digests."""
        k, rp = self.k, self.rows_per
        out = []
        for i, dev in enumerate(self.devices):
            with _on(dev):
                q0 = torch.empty((k, k, SHARE_SIZE), dtype=torch.uint8, device=dev)
                for j, x in enumerate(xs):
                    _copy(q0[j * rp:(j + 1) * rp], x, "all_gather")
                q2 = torch.empty_like(q0)
                d2 = rs_cuda.encode_hash_into(q0, q2, self.m2[i])  # [row, col]
                out.append((q2[i * rp:(i + 1) * rp], d2[i * rp:(i + 1) * rp]))
        return out

    def _q2_xor(self, xs: list[torch.Tensor]):
        """The XOR Q2: each shard's partial parity over its rows' bit-planes
        through its column-block schedule; each shard XORs every shard's
        partial for its own rows, then hashes them with K2."""
        k, rp = self.k, self.rows_per
        partials = []
        for i, (dev, x) in enumerate(zip(self.devices, xs)):
            with _on(dev):
                planes = torch.movedim(rs.unpack_bits(x.transpose(0, 1)), -2, 0)  # (8rp, k, 512)
                partials.append(xor_schedule.apply_planes(
                    planes.reshape(8 * rp, k * SHARE_SIZE), self.col_index[i]))  # (8k, k·512)
        out = []
        for i, dev in enumerate(self.devices):
            with _on(dev):
                acc = torch.zeros((8 * rp, k * SHARE_SIZE), dtype=torch.uint8, device=dev)
                recv = torch.empty_like(acc)
                for part in partials:
                    _copy(recv, part[8 * i * rp:8 * (i + 1) * rp], "reduce_scatter")
                    acc.bitwise_xor_(recv)
                bits = torch.movedim(acc.view(8 * rp, k, SHARE_SIZE), 0, -2)  # (k, 8rp, 512)
                q2 = rs.pack_bits(bits).transpose(0, 1).contiguous()  # (rp, k, 512)
                d2 = rs_cuda.leaf_digests2d(q2.view(rp, k * SHARE_SIZE),
                                                 _parity_ns(rp, k, dev))
                out.append((q2, d2))
        return out

    def shards(self, staged, keep_rows: bool) -> list[_Shard]:
        """Every shard's EDS rows (with ``keep_rows``) and digest tiles."""
        k, rp = self.k, self.rows_per
        xs = extend._stage_sharded(staged, self.mesh).shards
        q2s = self._q2_xor(xs) if self.xor else self._q2_dense(xs)
        out = []
        for i, (dev, x, (q2, d2)) in enumerate(zip(self.devices, xs, q2s)):
            with _on(dev):
                x2 = x.view(rp, k * SHARE_SIZE)
                d0 = rs_cuda.leaf_digests2d(x2, rs_cuda.own_namespaces(x2))
                if keep_rows:
                    top = torch.empty((rp, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=dev)
                    bottom = torch.empty_like(top)
                    top[:, :k].copy_(x)
                    bottom[:, :k].copy_(q2)
                    p1, p3 = top[:, k:], bottom[:, k:]
                else:
                    top = bottom = None
                    p1, p3 = (torch.empty((k, rp, SHARE_SIZE), dtype=torch.uint8,
                                          device=dev).transpose(0, 1) for _ in range(2))
                d1 = self._encode_rows(i, x, p1)
                d3 = self._encode_rows(i, q2, p3)
                out.append(_Shard(x, (d0, d1, d2, d3), top, bottom))
        return out

    # -- the gathers onto the first device ------------------------------- #

    def _gather_rows(self, parts, shape, dtype) -> torch.Tensor:
        """(top block, bottom block) pairs of shape (rows_per, ...) into one
        (2k, ...) tensor in global row order."""
        k, rp = self.k, self.rows_per
        out = torch.empty((2 * k, *shape), dtype=dtype, device=self.first)
        for i, (top, bottom) in enumerate(parts):
            _copy(out[i * rp:(i + 1) * rp], top, "gather")
            _copy(out[k + i * rp:k + (i + 1) * rp], bottom, "gather")
        return out

    def eds(self, shards: list[_Shard]) -> torch.Tensor:
        return self._gather_rows([(s.top, s.bottom) for s in shards],
                                 (2 * self.k, SHARE_SIZE), torch.uint8)

    def grid(self, shards: list[_Shard]):
        """The gathered (2k, 2k, 8) leaf-digest grid as its four quadrant
        tiles, and Q0's namespaces (the shares' first 32 bytes, the 29 the
        tree reads and 3 it ignores) on the first device."""
        k, rp = self.k, self.rows_per
        grid = self._gather_rows(
            [(torch.cat(s.tiles[:2], dim=1), torch.cat(s.tiles[2:], dim=1)) for s in shards],
            (2 * k, 8), torch.uint32)
        ns = torch.empty((k, k, 32), dtype=torch.uint8, device=self.first)
        for i, s in enumerate(shards):
            _copy(ns[i * rp:(i + 1) * rp], s.x[..., :32], "gather")
        return (grid[:k, :k], grid[:k, k:], grid[k:, :k], grid[k:, k:]), ns

    def dah(self, roots: torch.Tensor) -> torch.Tensor:
        return extend.merkle_root_pow2(roots.reshape(-1, NMT_NODE_SIZE))

    # -- the programs ---------------------------------------------------- #

    def roots(self, staged):
        """(row_roots, col_roots) on the first device; no EDS is assembled."""
        with _on(self.first):
            shards = self.shards(staged, keep_rows=False)
            quads, ns = self.grid(shards)
            roots, _levels = nmt_cuda.nmt_tree(quads, ns)
            return roots[0], roots[1]

    def extend_and_root(self, staged):
        with _on(self.first):
            shards = self.shards(staged, keep_rows=True)
            quads, ns = self.grid(shards)
            roots, _levels = nmt_cuda.nmt_tree(quads, ns)
            return self.eds(shards), roots[0], roots[1], self.dah(roots)

    def extend_root_levels(self, staged):
        """Row C: each shard's leaf digests feed both the roots and its row
        levels (the tree's row-block mode over its own tiles); the column
        roots are the row-block mode over the gathered grid's transpose."""
        k, rp = self.k, self.rows_per
        with _on(self.first):
            shards = self.shards(staged, keep_rows=True)
            local = []
            for dev, s in zip(self.devices, shards):
                with _on(dev):
                    local.append(nmt_cuda.nmt_tree_rows(
                        s.tiles, s.x[..., :NAMESPACE_SIZE], True))
            (q0, q1, q2, q3), ns = self.grid(shards)
            cols, _none = nmt_cuda.nmt_tree_rows(
                (q0.transpose(0, 1), q2.transpose(0, 1), q1.transpose(0, 1),
                 q3.transpose(0, 1)), ns.transpose(0, 1))
            roots = torch.empty((2, 2 * k, NMT_NODE_SIZE), dtype=torch.uint8, device=self.first)
            for i, (r, _lv) in enumerate(local):
                _copy(roots[0, i * rp:(i + 1) * rp], r[0, :rp], "gather")
                _copy(roots[0, k + i * rp:k + (i + 1) * rp], r[0, rp:], "gather")
            roots[1].copy_(cols[0])
            flat = _gather_levels(self.first, k, [
                (nmt_cuda.split_levels(lv, k, 2 * rp), ((i * rp, rp), (k + i * rp, rp)))
                for i, (_r, lv) in enumerate(local)])
            return (self.eds(shards), roots[0], roots[1], self.dah(roots),
                    tuple(nmt_cuda.split_levels(flat, k)))


def _gather_levels(first: torch.device, k: int, parts) -> torch.Tensor:
    """Every shard's row levels into one flat buffer on ``first``, of
    (2k, 2k >> L, 90) levels in global row order (``nmt_cuda.split_levels``
    views it). ``parts`` holds each shard's stack of levels and the global
    row blocks, (first row, rows), that the stack's rows fill in turn."""
    flat = torch.empty(sum(a * b * c for a, b, c in nmt_cuda.level_shapes(k)),
                       dtype=torch.uint8, device=first)
    views = nmt_cuda.split_levels(flat, k)
    with _on(first):
        for stack, blocks in parts:
            for view, lv in zip(views, stack):
                src = 0
                for lo, n in blocks:
                    _copy(view[lo:lo + n], lv[src:src + n], "gather")
                    src += n
    return flat


# ---------------------------------------------------------------------- #
# the public spellings, each a function of the staged square built once per
# (mesh, k), as the JAX package's jitted builders


def extend_and_root_rowsharded(mesh: Mesh, k: int, xor: bool | None = None):
    """One square, its rows sharded over the mesh's 'sp' axis (the devices
    of its first dp row). Returns a function of the (k, k, 512) uint8 square
    (a host array, a device tensor, or ``transfers.RowShards`` on those
    devices) -> (eds (2k, 2k, 512), row_roots (2k, 90), col_roots (2k, 90),
    dah (32,)), on the mesh's first device.

    ``xor=None`` resolves the contraction spelling by
    ``extend._xor_active(k)`` once, when the function is built."""
    return _RowSharded(mesh, k, xor).extend_and_root


def roots_rowsharded(mesh: Mesh, k: int, xor: bool | None = None):
    """As ``extend_and_root_rowsharded``, returning (row_roots, col_roots)
    alone: no EDS row is assembled and no DAH is hashed (the roots-only
    entries' contract on the mesh)."""
    return _RowSharded(mesh, k, xor).roots


def extend_root_levels_rowsharded(mesh: Mesh, k: int, xor: bool | None = None):
    """The block pipeline's compute leg on the mesh (Row C): extend, axis
    roots, DAH and every row-tree level in one pass, each shard's leaves
    hashed once and feeding both its row levels and the column roots.
    Returns a function of the square -> (eds, row_roots, col_roots, dah,
    levels), levels a tuple of (2k, 2k >> L, 90) views of one flat buffer in
    global row order, byte-identical to ``extend_and_root_rowsharded``
    followed by ``eds_row_levels_rowsharded``."""
    return _RowSharded(mesh, k, xor).extend_root_levels


def eds_row_level_buffer_rowsharded(mesh: Mesh, k: int):
    """Row-tree levels of an existing (2k, 2k, 512) EDS, its 2k rows sharded
    over 'sp'. Row trees are per row, so each shard hashes its own rows (K2,
    then the tree's row-block mode) with no collective; the namespace rule
    reads the global row index (a cell keeps its own namespace when its row
    and column are both below k). Returns a function of the EDS -> the one
    flat buffer of (2k, 2k >> L, 90) levels on the mesh's first device, as
    ``nmt_cuda.split_levels`` views it (the buffer
    ``extend.eds_row_levels_device`` fetches in one copy)."""
    w = 2 * k
    sp = mesh.shape["sp"]
    if w % sp:
        raise ValueError(f"EDS width {w} not divisible by sp={sp}")
    devices = list(mesh.devices[0])
    per = w // sp

    def run(eds) -> torch.Tensor:
        rows = extend._stage_sharded(eds, mesh).shards
        parts = []
        for i, (dev, r) in enumerate(zip(devices, rows)):
            top = min(max(k - i * per, 0), per)  # this shard's rows below k
            with _on(dev):
                ns = torch.cat([
                    torch.cat([r[:top, :k, :NAMESPACE_SIZE],
                               torch.as_tensor(rs_cuda.PARITY_NS, device=dev).expand(
                                   top, k, NAMESPACE_SIZE)], dim=1),
                    torch.as_tensor(rs_cuda.PARITY_NS, device=dev).expand(
                        per - top, w, NAMESPACE_SIZE)], dim=0)
                grid = rs_cuda.leaf_digests2d(r.view(per, w * SHARE_SIZE),
                                              rs_cuda.pad_namespaces(ns))
                tiles = (grid[:top, :k], grid[:top, k:], grid[top:, :k], grid[top:, k:])
                _roots, levels = nmt_cuda.nmt_tree_rows(
                    tiles, r[:top, :k, :NAMESPACE_SIZE] if top else None, True)
                parts.append((nmt_cuda.split_levels(levels, k, per), ((i * per, per),)))
        return _gather_levels(devices[0], k, parts)

    return run


def eds_row_levels_rowsharded(mesh: Mesh, k: int):
    """As ``eds_row_level_buffer_rowsharded``, returning the tuple of
    (2k, 2k >> L, 90) levels, views of that buffer."""
    run = eds_row_level_buffer_rowsharded(mesh, k)
    return lambda eds: tuple(nmt_cuda.split_levels(run(eds), k))


class ShardedBatch(list):
    """A batch staged over a mesh: one ``transfers.RowShards`` a square, the
    squares of dp row r on that row's devices (``shard_batch``)."""


def shard_batch(batch, mesh: Mesh, site: str = "parallel.batch") -> ShardedBatch:
    """Stage a (B, k, k, 512) batch over the mesh: B/dp consecutive squares
    to each dp row, each square's rows over that row's sp devices."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    b = len(batch)
    if b % dp:
        raise ValueError(f"a batch of {b} squares does not divide over dp={dp}")
    per = b // dp
    out = ShardedBatch()
    for r in range(dp):
        out += [extend._stage_sharded(sq, mesh.row(r), site)
                for sq in batch[r * per:(r + 1) * per]]
    return out


def sharded_extend_and_root(mesh: Mesh, k: int):
    """The dp batch: a function of a (B, k, k, 512) batch (host array, or
    ``shard_batch``'s staging) -> (eds (B, 2k, 2k, 512), row_roots (B, 2k,
    90), col_roots (B, 2k, 90), dah (B, 32)) on the mesh's first device.
    Dp row r extends squares [r·B/dp, (r + 1)·B/dp): through the row-sharded
    spelling when sp > 1, through ``extend.extend_and_root_batched`` on its
    device when sp = 1."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if k % sp:
        raise ValueError(f"square size {k} not divisible by sp={sp}")
    first = mesh.first
    rows = [_RowSharded(mesh.row(r), k, None) for r in range(dp)] if sp > 1 else None

    def run(batch):
        staged = batch if isinstance(batch, ShardedBatch) else shard_batch(batch, mesh)
        per = len(staged) // dp
        outs = []
        for r in range(dp):
            part = staged[r * per:(r + 1) * per]
            if rows is not None:
                outs += [rows[r].extend_and_root(s) for s in part]
                continue
            dev = mesh.devices[r, 0]
            with _on(dev):
                eds, rr, cc, dah = extend.extend_and_root_batched(
                    [s.shards[0] for s in part], rs.encode_matrix(k, dev))
            outs += list(zip(eds, rr, cc, dah))
        with _on(first):
            result = []
            for j in range(4):
                parts = [o[j] for o in outs]
                dst = torch.empty((len(parts), *parts[0].shape), dtype=parts[0].dtype,
                                  device=first)
                for i, t in enumerate(parts):
                    _copy(dst[i], t, "gather")
                result.append(dst)
            return tuple(result)

    return run
