"""The port's block pipeline (celestia_tpu_torch/node/pipeline.py) and the
node's use of it against the JAX package's node/pipeline.py and Node.

Five squares go through the port's ``BlockPipeline`` (on the CPU, the
plain versions of the kernels) and the JAX one with no mesh, at k = 4 and 8
and depths 3 and 1: the same retire order, and every retired block's EDS,
roots, DAH and row levels byte for byte. Then ``Shed`` after drain, the
``ValueError`` on a wrong k, one ``pipeline.block`` bitflip with one seed
striking the same byte in both, the staged entries against the host
entries, and ``Node.extend_pipeline``'s adopted state (the DAH memo, the
provers' levels, the documents served, the store files) equal to the JAX
Node's. The host pool that a retirement on the card copies into hands a
buffer out again only once every array on it is gone.
"""

import gc

import numpy as np
import pytest
import torch

from celestia_tpu import faults as jax_faults
from celestia_tpu import parallel
from celestia_tpu.node import node as jax_node
from celestia_tpu.node import pipeline as jax_pipeline
from celestia_tpu.node.dispatch import Shed as JaxShed
from celestia_tpu.testutil.chaosnet import chain_shares
from celestia_tpu_torch import faults
from celestia_tpu_torch.node import Node
from celestia_tpu_torch.node.dispatch import DeviceDispatcher, Shed
from celestia_tpu_torch.node.pipeline import BlockPipeline, HostPool
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.telemetry import metrics

N_SQUARES = 5


@pytest.fixture(autouse=True)
def _no_mesh():
    """No mesh routes the JAX pipeline (a mesh left by another test would
    send it down the row-sharded spelling), and the JAX package's caches
    and pipelines leave its ledger once collected."""
    parallel.configure_mesh(None)
    yield
    parallel.configure_mesh(None)
    gc.collect()


def square(k: int, height: int) -> np.ndarray:
    return np.frombuffer(b"".join(chain_shares(k, height)), np.uint8).reshape(k, k, 512).copy()


def stream(pipe, squares, first: int = 1):
    out = [b for h, sq in enumerate(squares, first) if (b := pipe.feed(h, sq)) is not None]
    return out + pipe.drain()


def same(ours, theirs) -> None:
    assert ours.height == theirs.height
    for name in ("eds", "row_roots", "col_roots", "dah"):
        assert np.array_equal(getattr(ours, name), np.asarray(getattr(theirs, name))), name
    assert len(ours.levels) == len(theirs.levels)
    for a, b in zip(ours.levels, theirs.levels):
        assert np.array_equal(a, np.asarray(b))


def feed_all(pipe, squares) -> tuple[list, int, int]:
    """Feed every square: (the blocks retired by the feeds, the blocks in
    flight after the last feed, their device bytes, the ledger owner's
    value)."""
    retired = [b for h, sq in enumerate(squares, 1) if (b := pipe.feed(h, sq)) is not None]
    return retired, pipe.inflight, pipe.device_bytes()


@pytest.mark.parametrize("k,depth", [(4, 3), (8, 3), (4, 1), (8, 1)])
def test_stream_equals_the_jax_pipeline(k, depth):
    squares = [square(k, h) for h in range(1, N_SQUARES + 1)]
    adopted = []
    ours = BlockPipeline(k, depth=depth, device="cpu", on_block=lambda b: adopted.append(b.height))
    theirs = jax_pipeline.BlockPipeline(k, depth=depth)
    fed0 = metrics.get_counter("pipeline_fed_total")
    retired0 = metrics.get_counter("pipeline_blocks_total")
    mine, in_ours, bytes_ours = feed_all(ours, squares)
    other, in_theirs, bytes_theirs = feed_all(theirs, squares)
    assert in_ours == in_theirs == depth - 1
    assert bytes_ours == bytes_theirs and (bytes_ours > 0) == (depth > 1)
    mine += ours.drain()
    other += theirs.drain()
    assert [b.height for b in mine] == [b.height for b in other] == list(range(1, N_SQUARES + 1))
    assert adopted == [b.height for b in mine]
    for a, b in zip(mine, other):
        same(a, b)
    assert ours.stats()["fed"] == ours.stats()["retired"] == N_SQUARES
    assert ours.stats()["fed"] == theirs.stats()["fed"]
    assert set(ours.stats()["stage_wall_s"]) == {"h2d", "compute", "d2h"}
    assert ours.inflight == 0 and ours.device_bytes() == 0
    assert metrics.get_counter("pipeline_fed_total") == fed0 + N_SQUARES
    assert metrics.get_counter("pipeline_blocks_total") == retired0 + N_SQUARES
    assert metrics.get_gauge("pipeline_inflight") == 0.0


def test_the_per_block_results_equal_the_host_entries():
    """One block's staged results are extend_and_root_device's and
    eds_row_levels_device's bytes."""
    sq = square(4, 9)
    eds, rows, cols, dah, levels = extend.extend_root_levels_staged(torch.from_numpy(sq))
    want = extend.extend_and_root_device(sq, "cpu")
    for got, w in zip((eds, rows, cols, dah), want):
        assert np.array_equal(got.numpy(), w)
    want_levels = extend.eds_row_levels_device(want[0], "cpu")
    assert [tuple(lv.shape) for lv in levels] == [lv.shape for lv in want_levels]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(levels, want_levels))
    again = extend.extend_and_root_staged(torch.from_numpy(sq))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(again, want))


def test_feed_after_drain_sheds_and_a_wrong_k_is_refused():
    ours, theirs = BlockPipeline(4, device="cpu"), jax_pipeline.BlockPipeline(4)
    for pipe, shed in ((ours, Shed), (theirs, JaxShed)):
        with pytest.raises(ValueError, match="k=4, got k=2"):
            pipe.feed(1, np.zeros((2, 2, 512), np.uint8))
        assert pipe.drain() == [] and pipe.draining
        with pytest.raises(shed) as err:
            pipe.feed(1, square(4, 1))
        assert err.value.reason == "draining"


def test_a_pipeline_block_bitflip_strikes_the_same_byte():
    k, seed = 4, 5
    clean = square(k, 3)
    eds = []
    for pipe, flt in ((BlockPipeline(k, depth=1, device="cpu"), faults),
                      (jax_pipeline.BlockPipeline(k, depth=1), jax_faults)):
        with flt.inject(flt.rule("pipeline.block", "bitflip", times=1), seed=seed):
            block = pipe.feed(3, clean)
        eds.append(np.asarray(block.eds))
    assert np.array_equal(eds[0], eds[1])
    q0 = eds[0][:k, :k]
    diff = np.argwhere(q0 != clean)
    assert len(diff) == 1  # one byte of the staged square, as both flip it
    assert bin(int(q0[tuple(diff[0])] ^ clean[tuple(diff[0])])).count("1") == 1


def test_an_error_rule_sheds_the_block_at_the_door():
    pipe = BlockPipeline(4, device="cpu")
    with faults.inject(faults.rule("pipeline.block", "error", times=1), seed=1):
        with pytest.raises(faults.TransportFault):
            pipe.feed(1, square(4, 1))
    assert pipe.stats()["fed"] == 0 and pipe.inflight == 0


class _App:
    published_eds = None


def test_extend_pipeline_adopts_as_the_jax_node(tmp_path):
    """Three squares through each node's extend_pipeline (the port's with a
    dispatcher attached): the same DAH memo, prover levels, documents and
    store files."""
    k = 4
    squares = [square(k, h) for h in (1, 2, 3)]
    ours = Node(device="cpu", home=tmp_path / "port")
    theirs = jax_node.Node(_App(), home=str(tmp_path / "jax"))
    ours.dispatcher = DeviceDispatcher().start()
    try:
        stream(ours.extend_pipeline(k), squares)
    finally:
        assert ours.dispatcher.drain()
        ours.dispatcher = None
    stream(theirs.extend_pipeline(k), squares)
    coords = [(0, 0), (1, 5), (7, 7), (3, 2)]
    for h in (1, 2, 3):
        assert ours.block_dah(h).row_roots == theirs.block_dah(h).row_roots
        assert ours.block_dah(h).hash() == theirs.block_dah(h).hash()
        o_levels, t_levels = ours._prover_cache[h][0], theirs._prover_cache[h][0]
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(o_levels, t_levels))
        assert ours.sample_batch(h, coords) == theirs.sample_batch(h, coords)
        assert ((tmp_path / "port" / "store" / f"{h}.ctps").read_bytes()
                == (tmp_path / "jax" / "store" / f"{h}.ctps").read_bytes())
    assert ours.sample_batch_ragged([(1, 0, 1), (3, 6, 2)]) == \
        theirs.sample_batch_ragged([(1, 0, 1), (3, 6, 2)])


def test_adoption_counts_a_retention_failure_and_carries_on(tmp_path, monkeypatch):
    """A device fault while the cache takes the square is counted as a
    retention failure; the DAH memo, the levels and the store still land."""
    from celestia_tpu_torch import integrity

    node = Node(device="cpu", home=tmp_path)

    def refuse(height, value):
        raise integrity.IntegrityError("a page failed its check")

    monkeypatch.setattr(node._eds_cache, "put", refuse)
    before = metrics.get_counter("node_retention_failures_total", reason="IntegrityError")
    stream(node.extend_pipeline(4), [square(4, 1)])
    assert metrics.get_counter("node_retention_failures_total",
                               reason="IntegrityError") == before + 1
    assert 1 in node._dah_cache and node._prover_cache[1][0] is not None and 1 in node.store


def test_adoption_lets_other_errors_propagate(tmp_path, monkeypatch):
    node = Node(device="cpu", home=tmp_path)

    def broken(height, value):
        raise KeyError("not a device fault")

    monkeypatch.setattr(node._eds_cache, "put", broken)
    with pytest.raises(KeyError):
        stream(node.extend_pipeline(4), [square(4, 1)])


def test_the_pipeline_legs_run_on_the_dispatcher_thread():
    names = []
    d = DeviceDispatcher().start()
    real = d.run_device

    def spy(fn, label="run_device"):
        names.append(label)
        return real(fn, label=label)

    d.run_device = spy
    try:
        stream(BlockPipeline(4, depth=2, dispatcher=d, device="cpu"), [square(4, 1)])
    finally:
        d.drain()
    assert names == ["pipeline.h2d", "pipeline.compute", "pipeline.d2h"]


def _address(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def test_the_host_pool_recycles_a_buffer_once_its_last_view_is_gone():
    pool = HostPool()
    a = pool.array((4, 6, 90), np.uint8)
    assert a.shape == (4, 6, 90) and a.dtype == np.uint8 and a.flags.writeable
    a[:] = 7
    first = _address(a)
    view = a[1:3].T
    held = torch.from_numpy(a[0])
    del a
    gc.collect()
    b = pool.array((4, 6, 90), np.uint8)  # views still live: a fresh buffer
    assert _address(b) != first and (pool.fresh, pool.reused) == (2, 0)
    assert int(view.sum()) == 7 * view.size and int(held.sum()) == 7 * held.numel()
    del view
    gc.collect()
    c = pool.array((4, 6, 90), np.uint8)  # the tensor still reaches the buffer
    assert _address(c) not in (first, _address(b)) and pool.reused == 0
    del held
    gc.collect()
    d = pool.array((6, 4, 90), np.uint8)  # same size, another shape
    assert _address(d) == first and (pool.fresh, pool.reused) == (3, 1)
    assert int(d.sum()) == 7 * d.size  # handed out as it was left, not cleared


def test_the_host_pool_keeps_at_most_keep_free_buffers_a_size():
    pool = HostPool()
    arrays = [pool.array((16,), np.uint32) for _ in range(HostPool.KEEP + 2)]
    del arrays
    gc.collect()
    again = [pool.array((16,), np.uint32) for _ in range(HostPool.KEEP + 2)]
    assert (pool.fresh, pool.reused) == (HostPool.KEEP + 4, HostPool.KEEP)
    assert len(again) == HostPool.KEEP + 2
