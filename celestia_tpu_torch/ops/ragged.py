"""Ragged cross-height gather over the paged-EDS page table (port of the
JAX package's ops/ragged.py).

A light-client crowd samples the last few heights at once. The
``PagedEdsCache`` row-group pages already form a page table, so a
mixed-height, mixed-k group is answered from per-job (page, row-in-page,
length) descriptors with one gather per page geometry
(``ragged_cuda.ragged_gather``, a hand-written kernel that reads every row
in place through the page table), instead of one read per height.

Descriptor contract:

  * ``page``        - the page's device buffer, pinned by the caller
                      (``PagedEdsCache.pages_batch``) across the whole
                      gather, so it cannot be demoted mid-read;
  * ``row-in-page`` - the row index local to the page (``i - page.row_lo``);
  * ``length``      - the job's true row length in cells (the square width).

Pages are bucketed by their exact shape (a short tail page, or another k,
is its own bucket). Each bucket is one kernel launch and one D2H copy of
exactly its rows, recorded as one ``transfer_bytes{site="eds.ragged"}``
d2h, as the JAX package records it (which pads its descriptor count to a
power of two for its compile cache and cuts the pad on the device; eager
PyTorch needs no pad).
"""

from __future__ import annotations

import contextlib
import time

from celestia_tpu_torch import tracing
from celestia_tpu_torch.ops import ragged_cuda, transfers
from celestia_tpu_torch.telemetry import metrics


def gather_rows(descs, *, site: str = "eds.ragged") -> list:
    """Answer a ragged cross-height row group with one gather per page
    geometry. ``descs`` is a list of ``(page, row_in_page, length)``
    descriptors (pages pinned by the caller). Returns host arrays aligned
    with ``descs``, each ``(length, B)``, byte-identical to per-descriptor
    ``transfers.eds_row`` reads, transfer accounting included."""
    executor = transfers._device_executor()
    if executor is not None:
        return executor(lambda: _gather_rows_direct(descs, site))
    return _gather_rows_direct(descs, site)


def _gather_rows_direct(descs, site: str) -> list:
    if not descs:
        return []
    out: list = [None] * len(descs)
    # bucket descriptors by exact page geometry: mixed-k heights and short
    # tail pages carry different shapes; a same-k crowd is one bucket
    buckets: dict[tuple, list[int]] = {}
    for t, (dev, _r, _n) in enumerate(descs):
        buckets.setdefault(tuple(int(d) for d in dev.shape), []).append(t)
    for members in buckets.values():
        start = time.perf_counter()
        # the page table: unique pages by buffer identity (many jobs hit the
        # same page; one table entry is enough)
        pages: list = []
        slot_of: dict[int, int] = {}
        slots: list[int] = []
        rows: list[int] = []
        for t in members:
            dev, r, _n = descs[t]
            slot = slot_of.get(id(dev))
            if slot is None:
                slot = slot_of[id(dev)] = len(pages)
                pages.append(dev)
            slots.append(slot)
            rows.append(int(r))
        out_dev = ragged_cuda.ragged_gather(pages, slots, rows)
        transfers.profile_fence(out_dev, site, start, n=len(members), pages=len(pages))
        host = transfers._host(out_dev)  # exactly the bucket's rows cross
        transfers._record(site, "d2h", host.nbytes, start)
        for k, t in enumerate(members):
            out[t] = host[k][: int(descs[t][2])]
    return out


@contextlib.contextmanager
def ragged_span(heights: int, jobs: int):
    """Observability envelope for one ragged group: the
    ``dispatch_ragged_*`` counters and histogram and the
    ``dispatch.ragged`` span."""
    metrics.incr_counter("dispatch_ragged_batch_total")
    metrics.incr_counter("dispatch_ragged_jobs_total", float(jobs))
    metrics.observe("dispatch_ragged_heights", float(heights))
    with tracing.span("dispatch.ragged", heights=heights, jobs=jobs):
        yield
