"""The port's transfers and the sliced reads of its ExtendedDataSquare,
against the JAX package's ops/transfers and da.

The JAX side reads jax arrays on XLA:CPU; the port reads CPU tensors, where
a "device" slice is cut by the same indexing the card runs. Sliced reads
must equal the full-fetch bytes and the JAX package's, move only the slice
(``transfer_bytes``), and count the same bytes as the JAX package for the
same call sequence. Chunked uploads and downloads round-trip byte for byte;
with audits on, a transient ``transfer.chunk`` bitflip heals on its retry
and a persistent one raises, as in the JAX package's own tests.
"""

import jax
import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu import integrity as jax_integrity
from celestia_tpu.ops import transfers as jax_transfers
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu_torch import da, faults, integrity
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import transfers
from celestia_tpu_torch.telemetry import metrics
from tests.test_torch_extend import square

SMALL_K = [1, 2, 4, 8, 16]
SEED = 1337
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _audits_off_after():
    yield
    integrity.configure("off")
    jax_integrity.configure("off")


def rand_square(k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(2 * k, 2 * k, SHARE_SIZE),
                                                dtype=np.uint8)


def edges(k: int) -> list[int]:
    """First, second, the quadrant boundary and the last index."""
    w = 2 * k
    return sorted({0, 1 % w, k - 1, k % w, w - 1})


@pytest.mark.parametrize("n,chunks", [(1, 1), (7, 3), (8, 8), (10, 4), (5, 9), (256, 8)])
def test_bounds_partition_exactly(n, chunks):
    b = transfers._bounds(n, chunks)
    assert b == jax_transfers._bounds(n, chunks)
    assert b[0][0] == 0 and b[-1][1] == n
    assert all(hi == lo2 for (_lo, hi), (lo2, _hi) in zip(b, b[1:]))
    assert max(hi - lo for lo, hi in b) - min(hi - lo for lo, hi in b) <= 1


def test_auto_chunks_matches_reference():
    for nbytes in (0, 1 << 19, 1 << 20, 3 << 20, 8 << 20, 64 << 20):
        for rows in (1, 2, 5, 128, 256):
            assert transfers._auto_chunks(nbytes, rows) == jax_transfers._auto_chunks(nbytes, rows)


@pytest.mark.parametrize("chunks", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("shape", [(8, SHARE_SIZE), (5, 3, SHARE_SIZE), (256, 4096)])
def test_chunked_round_trip(shape, chunks):
    arr = np.random.default_rng(len(shape)).integers(0, 256, size=shape, dtype=np.uint8)
    site = f"t.rt.{'x'.join(map(str, shape))}.{chunks}"
    before = metrics.get_counter("transfer_bytes", site=site, direction="h2d")
    dev = transfers.device_put_chunked(arr, "cpu", site=site, chunks=chunks)
    assert dev.device == CPU and dev.is_contiguous() and np.array_equal(dev.numpy(), arr)
    assert metrics.get_counter("transfer_bytes", site=site, direction="h2d") == before + arr.nbytes
    assert np.array_equal(transfers.device_get_chunked(dev, site=site, chunks=chunks), arr)
    assert metrics.get_counter("transfer_bytes", site=site, direction="d2h") == arr.nbytes
    # a CPU tensor is a host array too
    assert torch.equal(transfers.device_put_chunked(dev, "cpu", site=site), dev)


def test_put_refuses_to_fall_back_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transfers.device_put_chunked(np.zeros((2, 512), np.uint8), site="t.nogpu")


@pytest.mark.parametrize("k", SMALL_K)
def test_sliced_reads_equal_full_fetch_and_jax(k):
    arr = rand_square(k, seed=k)
    dev, jdev = torch.from_numpy(arr.copy()), jax.device_put(arr)
    w = 2 * k
    for i in edges(k):
        assert np.array_equal(transfers.eds_row(dev, i), arr[i])
        assert np.array_equal(transfers.eds_row(dev, i), jax_transfers.eds_row(jdev, i))
        assert np.array_equal(transfers.eds_col(dev, i), arr[:, i])
        assert np.array_equal(transfers.eds_col(dev, i), jax_transfers.eds_col(jdev, i))
    for r, c in [(0, 0), (0, w - 1), (w - 1, 0), (k, k - 1), (w - 1, w - 1)]:
        assert np.array_equal(transfers.eds_share(dev, r, c), arr[r, c])
        assert np.array_equal(transfers.eds_share(dev, r, c), jax_transfers.eds_share(jdev, r, c))
    idx = [w - 1, 0, k % w, 0]
    assert np.array_equal(transfers.eds_rows_batch(dev, idx), arr[idx])
    assert np.array_equal(transfers.eds_rows_batch(dev, idx),
                          jax_transfers.eds_rows_batch(jdev, idx))
    pts = [(0, w - 1), (w - 1, 0), (k % w, k - 1)]
    assert np.array_equal(transfers.eds_cells_batch(dev, pts), arr[[p[0] for p in pts],
                                                                   [p[1] for p in pts]])
    assert np.array_equal(transfers.eds_cells_batch(dev, pts),
                          jax_transfers.eds_cells_batch(jdev, pts))
    assert transfers.eds_rows_batch(dev, []).shape == (0, w, SHARE_SIZE)
    assert transfers.eds_cells_batch(dev, []).shape == (0, SHARE_SIZE)


def test_sliced_reads_copy_out_of_the_square():
    arr = rand_square(2, seed=5)
    dev = torch.from_numpy(arr.copy())
    row = transfers.eds_row(dev, 1)
    dev[1] = 0
    assert np.array_equal(row, arr[1])


def test_transfer_byte_counters_equal_the_jax_package():
    """One call sequence through both packages, every site its own: the
    byte counters agree (batches count only the requested rows or cells,
    never the JAX package's power-of-two pad)."""
    k = 4
    arr = rand_square(k, seed=11)
    dev, jdev = torch.from_numpy(arr.copy()), jax.device_put(arr)
    calls = [
        ("eds_row", (3,)), ("eds_col", (5,)), ("eds_share", (2, 7)),
        ("eds_rows_batch", ([0, 3, 5],)), ("eds_cells_batch", ([(1, 2), (7, 7), (0, 0)],)),
    ]
    for name, args in calls:
        site = f"t.count.{name}"
        getattr(transfers, name)(dev, *args, site=site)
        getattr(jax_transfers, name)(jdev, *args, site=site)
    small = arr[:, :1].copy()
    for chunks in (1, 3):
        site = f"t.count.put.{chunks}"
        transfers.device_put_chunked(small, "cpu", site=site, chunks=chunks)
        jax_transfers.device_put_chunked(small, site=site, chunks=chunks)
        transfers.device_get_chunked(torch.from_numpy(small), site=site, chunks=chunks)
        jax_transfers.device_get_chunked(jax.device_put(small), site=site, chunks=chunks)
    sites = [f"t.count.{n}" for n, _a in calls] + ["t.count.put.1", "t.count.put.3"]
    for site in sites:
        for direction in ("h2d", "d2h"):
            ours = metrics.get_counter("transfer_bytes", site=site, direction=direction)
            theirs = jax_metrics.get_counter("transfer_bytes", site=site, direction=direction)
            assert ours == theirs, (site, direction)
    assert metrics.get_counter("transfer_bytes", site="t.count.eds_rows_batch",
                               direction="d2h") == 3 * 2 * k * SHARE_SIZE


def _chunk_arr(rows: int = 8) -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, 256, size=(rows, SHARE_SIZE), dtype=np.uint8)


def test_h2d_transient_flip_heals_on_retry():
    integrity.configure("full")
    arr = _chunk_arr()
    before = metrics.get_counter("transfer_retry_total", site="t.h2d", direction="h2d")
    with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        dev = transfers.device_put_chunked(arr, "cpu", site="t.h2d", chunks=2)
    assert np.array_equal(dev.numpy(), arr)
    assert metrics.get_counter("transfer_retry_total", site="t.h2d", direction="h2d") == before + 1


def test_h2d_persistent_flip_raises():
    integrity.configure("full")
    with faults.inject(faults.rule("transfer.chunk", "bitflip"), seed=SEED):
        with pytest.raises(integrity.IntegrityError):
            transfers.device_put_chunked(_chunk_arr(), "cpu", site="t.h2d", chunks=2)


def test_d2h_transient_flip_heals_on_retry():
    arr = _chunk_arr()
    dev = torch.from_numpy(arr.copy())
    integrity.configure("full")
    before = metrics.get_counter("transfer_retry_total", site="t.d2h", direction="d2h")
    with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        out = transfers.device_get_chunked(dev, site="t.d2h", chunks=2)
    assert np.array_equal(out, arr)
    assert metrics.get_counter("transfer_retry_total", site="t.d2h", direction="d2h") == before + 1


def test_d2h_persistent_flip_raises():
    integrity.configure("full")
    with faults.inject(faults.rule("transfer.chunk", "bitflip"), seed=SEED):
        with pytest.raises(integrity.IntegrityError):
            transfers.device_get_chunked(torch.from_numpy(_chunk_arr()), site="t.d2h", chunks=2)


def test_off_means_no_checksum_and_the_same_flip_as_jax():
    """Audits off: the flip passes silently, no retry fires, and it strikes
    the byte the JAX package's flip strikes."""
    arr = _chunk_arr()
    before = metrics.get_counter("transfer_retry_total", site="t.off", direction="h2d")
    with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        dev = transfers.device_put_chunked(arr, "cpu", site="t.off", chunks=2)
    with jax_faults.inject(jax_faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        jdev = jax_transfers.device_put_chunked(arr, site="t.off", chunks=2)
    assert not np.array_equal(dev.numpy(), arr)
    assert np.array_equal(dev.numpy(), np.asarray(jdev))
    assert metrics.get_counter("transfer_retry_total", site="t.off", direction="h2d") == before


def test_device_executor_funnels_sliced_reads():
    arr = rand_square(1, seed=2)
    dev = torch.from_numpy(arr.copy())
    ran = []

    def executor(fn):
        ran.append(1)
        return fn()

    transfers.register_device_executor(executor)
    try:
        assert np.array_equal(transfers.eds_row(dev, 1), arr[1])
        assert np.array_equal(transfers.eds_cells_batch(dev, [(0, 1)]), arr[[0], [1]])
    finally:
        transfers.unregister_device_executor(executor)
    assert ran == [1, 1]
    transfers.eds_col(dev, 0)
    assert ran == [1, 1]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_eds_sliced_reads_equal_jax_class(k):
    """A from_device square (the port's extend output) serves rows, columns,
    cells, row batches and the flattened shares equal to the JAX class on
    the same bytes, and moves only the slices until a whole-square read."""
    sq = square(k, seed=20 + k)
    ours = da.extend_shares(sq.reshape(-1, SHARE_SIZE), device="cpu")
    truth = ours.device_data.numpy().copy()
    theirs = jax_da.ExtendedDataSquare.from_device(jax.device_put(truth), k)
    assert np.array_equal(truth, jax_da.extend_shares(sq.reshape(-1, SHARE_SIZE)).data)
    w = 2 * k
    row_bytes = w * SHARE_SIZE
    before = {s: metrics.get_counter("transfer_bytes", site=s, direction="d2h")
              for s in ("eds.row", "eds.col", "eds.share", "eds.rows_batch")}
    for i in edges(k):
        assert ours.row(i) == theirs.row(i) == [truth[i, j].tobytes() for j in range(w)]
        assert ours.col(i) == theirs.col(i)
    assert ours.share(w - 1, 0) == theirs.share(w - 1, 0)
    idx = [w - 1, 0, w - 1]
    assert ours.rows_batch(idx) == theirs.rows_batch(idx)
    assert ours._data is None  # nothing fetched the square
    moved = {s: metrics.get_counter("transfer_bytes", site=s, direction="d2h") - before[s]
             for s in before}
    n_edges = len(edges(k))
    # at most 8 axes stay cached (FIFO); a row in the cache is not fetched again
    assert moved["eds.row"] == n_edges * row_bytes
    assert moved["eds.col"] == n_edges * row_bytes
    assert moved["eds.share"] in (0, SHARE_SIZE)
    assert moved["eds.rows_batch"] % row_bytes == 0 and moved["eds.rows_batch"] <= 2 * row_bytes
    assert ours.flattened_shares() == theirs.flattened_shares()
    assert ours._data is not None
    ours.data = truth.copy()
    assert ours._slice_cache == {} and ours.device_data is None
