"""EDS repair (rsmt2d.Repair) on the card: port of the JAX package's
ops/repair_tpu.py.

The Leopard erasure decode factors into

    out = Unscale_axis ∘ CORE_n ∘ Scale_axis (codeword bytes)

where CORE_n (IFFT -> formal derivative -> FFT) is one fixed GF(256)-linear
map per n = 2k, shared by every axis and every erasure pattern, and
Scale/Unscale are per-position constant multiplies from the error locator.
Which cells each sweep recovers depends only on the presence mask, never on
byte values, so the whole multi-sweep schedule (orientation, per-axis
constants, write masks) is planned on the host from the mask up front
(``plan_sweeps``, a copy of the JAX package's), and the card runs the
planned sweeps back to back with no host round trip between them.

Each sweep is one launch of the decode sweep kernel
(``repair_cuda.sweep``, ``csrc/rs_decode.cu``), which runs the core as
Leopard's butterfly program and writes the recovered cells in place in the
square through strides: no transposed copy for a column sweep. The JAX
package's arrays are immutable; here the erased-cell clear makes the one
new (2k, 2k, 512) tensor the sweeps repair in place, so the caller's EDS
never changes, and ``run()`` may be called again (a sweep is idempotent on
repaired data) and returns the same bytes.

Entries (each takes ``device=None``, meaning CUDA, and raises without a GPU
unless given ``device="cpu"``, where the sweeps run their plain version):
``stage_resident_repair``, ``repair_resident_verified`` (repair and verify
the axis roots against the DAH on the card; only the roots cross) and
``repair_device`` (the counterpart of ``repair_tpu.repair_tpu``: the
repaired square fetched to the host). Both full entries carry the
``repair.device`` span, the ``device.repair`` fault site, the
``device.repair.output`` site with the integrity audit, and the ``repair``
timing (label ``backend="gpu"`` where the JAX package says "tpu").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import faults, integrity, tracing
from celestia_tpu_torch.ops import extend, gf256, repair_cuda, rs, transfers
from celestia_tpu_torch.telemetry import metrics


@dataclasses.dataclass
class SweepPlan:
    """One planned decode sweep (all axes of one orientation at once).

    Scale constants travel as bytes (w·n, ~65 KB at k = 128); the kernel
    multiplies by them through its half-row table (``rs.decode_table``),
    the plain version gathers their 8×8 bit matrices from
    ``rs.bitmul_table``."""

    transpose: bool  # False: rows are axes; True: columns are axes
    scale_bytes: np.ndarray  # (w, n) uint8 — locator scale constant
    unscale_bytes: np.ndarray  # (w, n) uint8
    write: np.ndarray  # (w, n) bool — cells this sweep recovers (axis order)


def plan_sweeps(present: np.ndarray, k: int) -> list[SweepPlan]:
    """Derive the full sweep schedule from the presence mask alone.

    Mask evolution is value-independent: an axis with >= k present cells
    becomes fully present after its decode. Axes below k are carried in
    the batch (static shapes) but masked out of the write."""
    from celestia_tpu_torch.da.repair import UnrepairableError

    mask = present.copy()
    _log, exp = gf256._tables()
    plans: list[SweepPlan] = []
    while not mask.all():
        progress = False
        for transpose in (False, True):
            m = mask.T if transpose else mask
            counts = m.sum(axis=1)
            decodable = (counts >= k) & ~m.all(axis=1)
            if not decodable.any():
                continue
            # erasure indicators in codeword order [parity | data]
            erased = np.concatenate([~m[:, k:], ~m[:, :k]], axis=1).astype(
                np.int64
            )
            loc = gf256._error_locator_logs_batch(erased)[:, : 2 * k]
            scale_logs = np.where(erased == 0, loc, gf256.K_MODULUS)
            unscale_logs = np.where(
                erased == 1,
                (gf256.K_MODULUS - loc) % gf256.K_MODULUS,
                gf256.K_MODULUS,
            )
            to_bytes = lambda logs: np.where(  # noqa: E731
                logs == gf256.K_MODULUS, 0, exp[logs]
            ).astype(np.uint8)
            write = ~m & decodable[:, None]
            plans.append(
                SweepPlan(
                    transpose=transpose,
                    scale_bytes=to_bytes(scale_logs),
                    unscale_bytes=to_bytes(unscale_logs),
                    write=write,
                )
            )
            if transpose:
                mask.T[decodable] = True
            else:
                mask[decodable] = True
            progress = True
        if not progress:
            raise UnrepairableError(
                f"impossible to recover: {int((~mask).sum())} cells still missing"
            )
    return plans


def _resident_constants(w: int, dev: torch.device):
    """The operands the sweeps read on ``dev``, uploaded once per (w,
    device) by ``rs``'s caches and kept there: the decode program and its
    multiply tables for the kernel, the bit matrices for the plain version
    on the CPU."""
    return rs.decode_bits(w, dev) if dev.type == "cpu" else rs.decode_operands(w, dev)


def _stage_plans(plans: list[SweepPlan], dev: torch.device) -> list[repair_cuda.StagedSweep]:
    """Every sweep's constants in one (S, 3, w, n) uint8 array, one upload."""
    if not plans:
        return []
    consts = np.stack([np.stack([p.scale_bytes, p.unscale_bytes, p.write.astype(np.uint8)])
                       for p in plans])
    staged = torch.from_numpy(consts).to(dev)
    return [repair_cuda.StagedSweep(p.transpose, staged[i]) for i, p in enumerate(plans)]


def stage_resident_repair(eds, present: np.ndarray, device=None):
    """Plan a repair and stage everything on the device.

    ``eds`` may be a host array (uploaded here, through
    ``transfers.device_put_chunked``) or a tensor already on the device —
    e.g. the EDS that ``extend.extend_roots_device_resident`` just
    produced: the repair-after-extend flow passes it straight through and
    no share byte crosses to the card.

    Returns (run, n_sweeps): run() launches the planned sweeps on a
    cleared copy of the square (erased cells zeroed; the caller's tensor is
    never written) and returns that tensor, repaired. Sweeps are idempotent
    on repaired data, so run() may be called again and returns the same
    bytes."""
    dev = device_mod.resolve(device)
    k = extend._eds_size(eds)
    if isinstance(eds, torch.Tensor) and (eds.device.type != "cpu" or dev.type == "cpu"):
        # already on a device (on the CPU only when the CPU is the device)
        if eds.dtype != torch.uint8:
            raise ValueError(f"expected uint8 bytes, got {eds.dtype}")
        dev_raw = eds.to(dev)
    else:
        # dispatch the upload before planning: the chunked copies stream the
        # raw square while the host plans the sweeps from the mask
        host = eds.numpy() if isinstance(eds, torch.Tensor) else np.asarray(eds)
        with tracing.span("repair.upload", backend=extend._backend(dev), k=k):
            dev_raw = transfers.device_put_chunked(host, dev, site="repair.stage")
    with tracing.span("repair.plan", backend="host", k=k,
                      missing=int((~present).sum())) as plan_span:
        plans = plan_sweeps(present, k)
        plan_span.set(sweeps=len(plans))

    _resident_constants(2 * k, dev)  # uploaded once, before any sweep
    keep = torch.from_numpy(np.ascontiguousarray(present)).to(dev)
    # the one new square the sweeps repair in place: erased cells zeroed
    fixed = torch.where(keep[..., None], dev_raw, 0)
    staged = _stage_plans(plans, dev)
    backend = extend._backend(dev)

    def run() -> torch.Tensor:
        with tracing.span("repair.sweep", backend=backend, k=k, n_sweeps=len(staged)):
            for plan in staged:
                repair_cuda.sweep(fixed, plan)
            return fixed

    return run, len(plans)


def repair_resident_verified(
    eds,
    present: np.ndarray,
    row_roots: list[bytes] | None = None,
    col_roots: list[bytes] | None = None,
    device=None,
) -> torch.Tensor:
    """Repair and verify on the device; only the roots cross to the host.

    ``eds`` is ideally the tensor the extend path just produced (a node's
    rsmt2d.Repair flow starts from an EDS it just extended, BASELINE
    config 4). The sweeps run on the card, the NMT axis roots of the
    repaired square are recomputed there (``extend.eds_roots_device``) and
    compared with the DAH roots on the host (2·2k·90 bytes fetched, not the
    square). Returns the repaired square as a device tensor. Raises
    ValueError on a root mismatch."""
    dev = device_mod.resolve(device)
    k = extend._eds_size(eds)
    backend = extend._backend(dev)
    with tracing.span("repair.device", backend=backend, k=k,
                      entry="repair_resident_verified",
                      missing=int((~present).sum())), \
            metrics.measure("repair", backend="gpu"):
        faults.fire("device.repair", entry="repair_resident_verified")
        run, _ = stage_resident_repair(eds, present, dev)
        fixed = _postprocess_repair(run(), k, entry="repair_resident_verified")
        if row_roots is not None or col_roots is not None:
            with tracing.span("repair.verify", backend=backend, k=k):
                rows, cols = extend.eds_roots_device(fixed, dev)
                if row_roots is not None and [
                    r.tobytes() for r in rows
                ] != list(row_roots):
                    raise ValueError("repaired row roots do not match DAH")
                if col_roots is not None and [
                    c.tobytes() for c in cols
                ] != list(col_roots):
                    raise ValueError("repaired column roots do not match DAH")
        return fixed


def repair_device(eds, present: np.ndarray, device=None) -> np.ndarray:
    """Repair a (2k, 2k, 512) EDS on the card and return it on the host:
    the counterpart of the JAX package's ``repair_tpu.repair_tpu``.

    The host plans the sweeps from the mask; the card runs them back to
    back; the repaired square is fetched once at the end
    (``transfers.device_get_chunked``). Byte-identical to the host
    ``da.repair.repair``."""
    dev = device_mod.resolve(device)
    k = extend._eds_size(eds)
    with tracing.span("repair.device", backend=extend._backend(dev), k=k,
                      entry="repair_device", missing=int((~present).sum())), \
            metrics.measure("repair", backend="gpu"):
        faults.fire("device.repair", entry="repair_device")
        run, _ = stage_resident_repair(eds, present, dev)
        out = _postprocess_repair(run(), k, entry="repair_device")
        return transfers.device_get_chunked(out, site="repair.fetch")


def _postprocess_repair(fixed: torch.Tensor, k: int, *, entry: str) -> torch.Tensor:
    """The device.repair.output fault site and the integrity audit over the
    repaired square: a seeded bitflip damages the result in flight (a
    flipped copy; the repaired tensor itself is not written), and the
    syndrome audit must raise IntegrityError before any caller trusts the
    bytes. Audits off = one boolean check."""
    flip = faults.fire("device.repair.output", entry=entry)
    if flip is not None:
        fixed = flip(fixed)
    eng = integrity.get()
    if eng.enabled:
        integrity.audit_or_raise(eng, fixed, k, site="device.repair.output",
                                 where="device.repair")
    return fixed
