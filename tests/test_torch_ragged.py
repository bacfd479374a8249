"""The port's ragged cross-height gather (ops/ragged.py, ops/ragged_cuda.py)
against the JAX package's ops/ragged.py.

The JAX side gathers from jax arrays on XLA:CPU through its jitted gather;
the port gathers from CPU tensors, where ``ragged_cuda.ragged_gather`` runs
its plain version (the JAX spelling, ``torch.stack(pages)[slot, row]``).
The same pages (made with numpy from a seed) and descriptors go to both:
mixed k (2, 8, 32), short tail pages, duplicate descriptors. The rows, the
``transfer_bytes{site="eds.ragged"}`` d2h bytes, the ``dispatch_ragged_*``
counters and the ``dispatch.ragged`` span must be equal. The launch plan of
the kernel (``plan_launches``) is emulated on the CPU against the plain
gather; the kernel itself runs only on the card (chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from celestia_tpu import tracing as jax_tracing
from celestia_tpu.ops import ragged as jax_ragged
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu_torch import tracing
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import _cuda, ragged, ragged_cuda
from celestia_tpu_torch.telemetry import metrics

SEED = 1410
KS = (2, 8, 32)
ROWS_PER_PAGE = 3  # 2k is never a multiple of 3: every square has a short tail page


def pages_of(k: int, seed: int, rows_per_page: int = ROWS_PER_PAGE):
    """A random (2k, 2k, 512) square split into pages: (host square,
    [(row_lo, jax page, torch page)])."""
    host = np.random.default_rng(seed).integers(0, 256, size=(2 * k, 2 * k, SHARE_SIZE),
                                                dtype=np.uint8)
    pages = []
    for lo in range(0, 2 * k, rows_per_page):
        part = host[lo:lo + rows_per_page]
        pages.append((lo, jax.device_put(part), torch.from_numpy(part.copy())))
    return host, pages


def mixed_group(seed: int, n: int):
    """n descriptors over pages of every k in KS, interleaved, with
    duplicates: [(host square, row), ...] and the JAX and port descriptor
    lists (the same page object for every descriptor of a page)."""
    rng = np.random.default_rng(seed)
    squares = [pages_of(k, seed + k) for k in KS]
    want, jax_descs, port_descs = [], [], []
    for _ in range(n):
        host, pages = squares[rng.integers(len(squares))]
        lo, jp, tp = pages[rng.integers(len(pages))]
        r = int(rng.integers(tp.shape[0]))
        for _rep in range(1 + int(rng.integers(2))):  # a duplicate now and then
            want.append((host, lo + r))
            jax_descs.append((jp, r, host.shape[0]))
            port_descs.append((tp, r, host.shape[0]))
    return want, jax_descs, port_descs


def d2h(registry, site: str = "eds.ragged") -> float:
    return registry.get_counter("transfer_bytes", site=site, direction="d2h")


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 7), (3, 40)])
def test_gather_rows_equals_jax_rows_and_bytes(seed, n):
    want, jax_descs, port_descs = mixed_group(SEED + seed, n)
    jax0, ours0 = d2h(jax_metrics), d2h(metrics)
    theirs = jax_ragged.gather_rows(jax_descs)
    ours = ragged.gather_rows(port_descs)
    assert len(ours) == len(theirs) == len(want)
    for (host, i), a, b in zip(want, ours, theirs):
        assert a.dtype == np.uint8 and a.shape == (host.shape[0], SHARE_SIZE)
        assert a.tobytes() == np.asarray(b).tobytes() == host[i].tobytes()
    moved = d2h(metrics) - ours0
    assert moved == d2h(jax_metrics) - jax0 == sum(h.shape[0] * SHARE_SIZE for h, _i in want)


def test_gather_rows_one_record_per_geometry():
    """Each bucket (exact page shape) is one gather and one d2h record:
    k = 2's 3-row and 1-row pages, and k = 8's, are four buckets."""
    _h2, p2 = pages_of(2, 5)
    _h8, p8 = pages_of(8, 6)
    descs = [(p2[0][2], 0, 4), (p8[0][2], 1, 16), (p2[1][2], 0, 4), (p8[-1][2], 0, 16),
             (p2[0][2], 2, 4), (p8[1][2], 2, 16)]
    hist = metrics.get_timing("transfer", site="eds.ragged", direction="d2h")
    before = hist.count if hist is not None else 0
    ragged.gather_rows(descs)
    assert metrics.get_timing("transfer", site="eds.ragged", direction="d2h").count - before == 4
    assert ragged.gather_rows([]) == []


def test_gather_rows_runs_through_the_device_executor():
    calls = []

    def executor(fn):
        calls.append(fn)
        return fn()

    _h, pages = pages_of(2, 9)
    from celestia_tpu_torch.ops import transfers

    transfers.register_device_executor(executor)
    try:
        got = ragged.gather_rows([(pages[0][2], 1, 4)])
    finally:
        transfers.unregister_device_executor(executor)
    assert len(calls) == 1 and got[0].tobytes() == pages[0][2][1].numpy().tobytes()


def span_tree(spans):
    """(name, attributes, children) in start order, without the attributes
    that carry wall time or process-wide running totals."""
    drop = ("backend", "total_ms", "total_bytes")
    kids = {}
    for s in sorted(spans, key=lambda s: s.start):
        kids.setdefault(s.parent_id, []).append(s)
    ids = {s.span_id for s in spans}

    def node(s):
        return (s.name, {k: v for k, v in s.attrs.items() if k not in drop},
                [node(c) for c in kids.get(s.span_id, [])])

    return [node(s) for s in spans if s.parent_id not in ids]


def test_ragged_span_counters_and_span_equal_jax():
    _want, jax_descs, port_descs = mixed_group(SEED + 7, 9)
    jax_ragged.gather_rows(jax_descs)  # the JAX package's compile, outside the recording
    names = ("dispatch_ragged_batch_total", "dispatch_ragged_jobs_total")
    jax0 = [jax_metrics.get_counter(n) for n in names]
    ours0 = [metrics.get_counter(n) for n in names]
    jax_h0 = jax_metrics.get_timing("dispatch_ragged_heights")
    jax_h0 = list(jax_h0.counts) if jax_h0 is not None else None
    ours_h0 = metrics.get_timing("dispatch_ragged_heights")
    ours_h0 = list(ours_h0.counts) if ours_h0 is not None else None
    with jax_tracing.record() as jrec:
        with jax_ragged.ragged_span(3, len(jax_descs)):
            jax_ragged.gather_rows(jax_descs)
    with tracing.record() as rec:
        with ragged.ragged_span(3, len(port_descs)):
            ragged.gather_rows(port_descs)
    assert [metrics.get_counter(n) - b for n, b in zip(names, ours0)] == \
        [jax_metrics.get_counter(n) - b for n, b in zip(names, jax0)] == [1.0, len(port_descs)]

    def delta(hist, before):
        counts = list(hist.counts)
        return counts if before is None else [a - b for a, b in zip(counts, before)]

    assert delta(metrics.get_timing("dispatch_ragged_heights"), ours_h0) == \
        delta(jax_metrics.get_timing("dispatch_ragged_heights"), jax_h0)
    ours, theirs = span_tree(rec.spans), span_tree(jrec.spans)
    assert ours == theirs
    assert ours[0][0] == "dispatch.ragged" and ours[0][1] == {"heights": 3,
                                                              "jobs": len(port_descs)}
    assert [c[0] for c in ours[0][2]] == ["transfer.eds.ragged"] * 4


@pytest.mark.parametrize("k", [1, 2, 8, 32])
def test_plain_gather_equals_per_row_slices(k):
    host, pages = pages_of(k, 20 + k, rows_per_page=4)
    tpages = [tp for _lo, _jp, tp in pages if tp.shape[0] == pages[0][2].shape[0]]
    rng = np.random.default_rng(k)
    slots = [int(s) for s in rng.integers(len(tpages), size=11)]
    rows = [int(r) for r in rng.integers(tpages[0].shape[0], size=11)]
    got = ragged_cuda.gather_rows_reference(tpages, slots, rows)
    want = np.stack([tpages[s].numpy()[r] for s, r in zip(slots, rows)])
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = _cuda.LAUNCHES["ragged_gather"]
    assert torch.equal(ragged_cuda.ragged_gather(tpages, slots, rows), got)
    assert _cuda.LAUNCHES["ragged_gather"] == before


def emulate(pages, slots, rows, max_pages, max_descs) -> np.ndarray:
    """The kernel over ``plan_launches``: each launch reads its packed
    descriptors through its own page table into its rows of the output."""
    out = np.zeros((len(slots), *pages[0].shape[1:]), np.uint8)
    plan = ragged_cuda.plan_launches(slots, rows, max_pages, max_descs)
    assert plan[0].lo == 0 and plan[-1].hi == len(slots)
    for a, b in zip(plan, plan[1:]):
        assert a.hi == b.lo
    for launch in plan:
        assert 0 < launch.hi - launch.lo <= max_descs and 0 < len(launch.table) <= max_pages
        assert launch.descs.dtype == np.uint32 and len(launch.descs) == launch.hi - launch.lo
        for t, d in enumerate(launch.descs):
            page = pages[launch.table[int(d) >> 16]].numpy()
            out[launch.lo + t] = page[int(d) & 0xFFFF]
    return out, plan


@pytest.mark.parametrize("max_pages,max_descs,launches", [
    (ragged_cuda.MAX_PAGES, ragged_cuda.MAX_DESCS, 1),
    (4, ragged_cuda.MAX_DESCS, None),  # the page table fills first
    (ragged_cuda.MAX_PAGES, 7, 6),     # 40 descriptors, 7 a launch
    (1, 1, 40),
])
def test_launch_plan_emulation_equals_plain(max_pages, max_descs, launches):
    _host, pages = pages_of(8, 31, rows_per_page=2)
    tpages = [tp for _lo, _jp, tp in pages]
    rng = np.random.default_rng(max_pages * 100 + max_descs)
    slots = [int(s) for s in rng.integers(len(tpages), size=40)]
    rows = [int(r) for r in rng.integers(2, size=40)]
    got, plan = emulate(tpages, slots, rows, max_pages, max_descs)
    assert np.array_equal(got, ragged_cuda.gather_rows_reference(tpages, slots, rows).numpy())
    if launches is not None:
        assert len(plan) == launches
    else:
        assert len(plan) > 1 and all(len(p.table) <= 4 for p in plan)


def test_kernel_table_fits_its_parameter_limit():
    """The full table (page pointers, packed descriptors, the row length)
    stays inside the 32,764 bytes of kernel parameters Hopper takes."""
    assert ragged_cuda.MAX_PAGES * 8 + ragged_cuda.MAX_DESCS * 4 + 8 <= 32764
    src = (_cuda.CSRC / "ragged_gather.cu").read_text()
    assert f"kMaxPages = {ragged_cuda.MAX_PAGES};" in src
    assert f"kMaxDescs = {ragged_cuda.MAX_DESCS};" in src
    assert "ragged_gather.cu" in _cuda.SOURCES and "ragged_gather" in _cuda.LAUNCHES


@pytest.mark.parametrize("case", ["no_pages", "shape", "dtype", "slot", "row", "lengths"])
def test_wrapper_refuses_a_bad_bucket(case):
    a = torch.zeros((2, 4, SHARE_SIZE), dtype=torch.uint8)
    pages, slots, rows = [a, a.clone()], [0, 1], [0, 1]
    err = ValueError
    if case == "no_pages":
        pages = []
    elif case == "shape":
        pages = [a, torch.zeros((1, 4, SHARE_SIZE), dtype=torch.uint8)]
    elif case == "dtype":
        pages = [a, a.to(torch.int16)]
    elif case == "slot":
        slots, err = [0, 2], IndexError
    elif case == "row":
        rows, err = [0, 2], IndexError
    else:
        rows = [0]
    with pytest.raises(err):
        ragged_cuda.ragged_gather(pages, slots, rows)


def test_wrapper_runs_only_cpu_or_cuda_tensors():
    page = torch.empty((2, 4, SHARE_SIZE), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_cuda.ragged_gather([page], [0], [1])
