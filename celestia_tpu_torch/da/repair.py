"""EDS repair (erasure decoding): the rsmt2d.Repair capability, port of the
JAX package's da/repair.py (BASELINE config 4: a 256×256 EDS with 25% of
its shares erased).

Each axis decodes with Leopard's own O(n log n) erasure decode
(``ops/gf256.leopard_decode_batch``: the error locator, IFFT, formal
derivative, FFT — the algorithm the reference's codec library runs).
Erasures can leave an axis under-determined until the crossing axis
supplies cells, so rows and columns are repaired in turn to a fixed point,
the strategy rsmt2d uses (invoked from pkg/da/data_availability_header.go:74
context). ``_solve_axis_dense`` is an independent dense solver over the
encode matrix, the oracle the tests hold the decodes against.

``repair`` runs on the host (numpy); ``repair_eds`` sends a device-backed
square to ``ops/repair.repair_resident_verified`` and a host-backed one to
``repair``. When DAH roots are given, the repaired square's roots are
recomputed on ``device`` (None means CUDA) and compared.
"""

from __future__ import annotations

import numpy as np

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import tracing
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.telemetry import metrics


class UnrepairableError(Exception):
    """Too many erasures: no axis with >= k available cells made progress."""


def _axis_decode_matrix(avail_idx: np.ndarray, k: int) -> np.ndarray:
    """(k,) available positions (in 0..2k-1, sorted, first k used) ->
    (k, k) matrix A with A @ original_data = available_cells."""
    m = gf256.encode_matrix(k)
    a = np.zeros((k, k), dtype=np.uint8)
    for row, pos in enumerate(avail_idx):
        if pos < k:
            a[row, pos] = 1
        else:
            a[row] = m[pos - k]
    return a


def _solve_sweep_batched(view: np.ndarray, mask: np.ndarray,
                         todo: list[int], k: int) -> None:
    """Decode every repairable axis of the sweep in one batched Leopard
    decode (the butterflies are erasure-pattern-independent, so all axes
    share the transform work)."""
    idx = np.asarray(todo)
    view[idx] = gf256.leopard_decode_batch(view[idx], mask[idx], k)
    mask[idx] = True


def _solve_axis_dense(cells: np.ndarray, present: np.ndarray, k: int) -> np.ndarray:
    """Independent dense solver (the tests' oracle): with original =
    A^-1 @ avail and any cell row g of the full generator G (G[:k] = I,
    G[k:] = M), the recovery matrix for the missing positions is
    R = G[missing] @ A^-1, so missing_cells = R @ avail_cells."""
    avail = np.flatnonzero(present)[:k]
    missing = np.flatnonzero(~present)
    a_inv = gf256.gf_inverse(_axis_decode_matrix(avail, k))
    m = gf256.encode_matrix(k)
    g_missing = np.zeros((len(missing), k), dtype=np.uint8)
    for row, pos in enumerate(missing):
        if pos < k:
            g_missing[row, pos] = 1
        else:
            g_missing[row] = m[pos - k]
    recovery = gf256.gf_matmul(g_missing, a_inv)
    out = np.array(cells, copy=True)
    out[missing] = gf256.gf_matmul(recovery, cells[avail])
    return out


def repair(
    shares: np.ndarray,
    present: np.ndarray,
    row_roots: list[bytes] | None = None,
    col_roots: list[bytes] | None = None,
    device=None,
) -> np.ndarray:
    """Repair a (2k, 2k, 512) EDS with boolean presence mask (2k, 2k).

    Erased cells' contents are ignored. Returns the full EDS; raises
    UnrepairableError when the erasure pattern is not decodable and
    ValueError when recomputed roots mismatch the provided DAH roots. The
    roots are computed on ``device`` (None means CUDA)."""
    dev = device_mod.resolve(device)
    width = shares.shape[0]
    k = width // 2
    with tracing.span("repair.host", backend="host", k=k,
                      missing=int((~present).sum())) as rspan, \
            metrics.measure("repair", backend="host"):
        eds = np.array(shares, dtype=np.uint8, copy=True)
        eds[~present] = 0
        present = present.copy()

        n_sweeps = 0
        while not present.all():
            progress = False
            # rows, then columns
            for transpose in (False, True):
                view = eds.transpose(1, 0, 2) if transpose else eds
                mask = present.T if transpose else present
                todo = [
                    i
                    for i in range(width)
                    if not mask[i].all() and mask[i].sum() >= k
                ]
                if todo:
                    with tracing.span(
                        "repair.sweep", backend="host", k=k,
                        axis="col" if transpose else "row", axes=len(todo),
                    ):
                        _solve_sweep_batched(view, mask, todo, k)
                    n_sweeps += 1
                    progress = True
            if not progress:
                raise UnrepairableError(
                    f"impossible to recover: {int((~present).sum())} cells still missing"
                )
        rspan.set(sweeps=n_sweeps)

        if row_roots is not None or col_roots is not None:
            with tracing.span("repair.verify", backend="host", k=k):
                _verify_roots(eds, k, row_roots, col_roots, dev)
        return eds


def repair_eds(
    square,
    present: np.ndarray,
    row_roots: list[bytes] | None = None,
    col_roots: list[bytes] | None = None,
    device=None,
):
    """Repair an ExtendedDataSquare where it lives.

    A device-backed square (``da.ExtendedDataSquare.from_device``) is
    repaired and root-verified on its device
    (``ops/repair.repair_resident_verified``); only the axis roots cross to
    the host, and the result is a device-backed square. A host-backed
    square takes the host Leopard decode, its roots checked on ``device``.
    ``device`` None means CUDA, on either path. Both give the same bytes."""
    from celestia_tpu_torch import da

    if square.device_data is not None:
        from celestia_tpu_torch.ops import repair as repair_ops

        fixed = repair_ops.repair_resident_verified(
            square.device_data, present, row_roots, col_roots, device
        )
        return da.ExtendedDataSquare.from_device(fixed, square.original_width)
    fixed = repair(square.data, present, row_roots, col_roots, device)
    return da.ExtendedDataSquare(fixed, square.original_width, device)


def _verify_roots(eds: np.ndarray, k: int, row_roots, col_roots, device) -> None:
    from celestia_tpu_torch import da

    square = da.ExtendedDataSquare(eds, k, device)
    if row_roots is not None:
        got = square.row_roots()
        if got != list(row_roots):
            raise ValueError("repaired row roots do not match DAH")
    if col_roots is not None:
        got = square.col_roots()
        if got != list(col_roots):
            raise ValueError("repaired column roots do not match DAH")
