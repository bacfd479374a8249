"""The port's device blob arena (celestia_tpu_torch/ops/blob_pool.py) on the
CPU against the JAX package's DeviceBlobArena.

The same sequence of puts (blob bytes made with numpy from a seed) goes to
both arenas: every key's offset, the bump pointer, the active half, every
flip and eviction, the stranded tail and the ``blob_arena_*`` gauges must
be equal, and the port's arena must hold each resident blob's bytes at its
offset. The cases mirror tests/test_blob_pool.py::TestArena.
"""

import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch

from celestia_tpu.ops import blob_pool as j_pool
from celestia_tpu.telemetry import metrics as j_metrics
from celestia_tpu_torch.ops import blob_pool
from celestia_tpu_torch.telemetry import metrics

@pytest.fixture(autouse=True, scope="module")
def _collect_jax_arenas():
    """The JAX package's arenas and Apps enrol in its device ledger until
    they are collected: collect them before the next module, so none of
    this module's outlives it."""
    yield
    gc.collect()


GAUGES = ("blob_arena_resident_bytes", "blob_arena_used_bytes", "blob_arena_capacity_bytes",
          "blob_arena_active_half_bytes")


def pair(capacity: int):
    return blob_pool.DeviceBlobArena(capacity, device="cpu"), j_pool.DeviceBlobArena(capacity)


def state(arena) -> tuple:
    return (dict(arena._offsets), arena._base, arena._next, arena._half, arena.tail_bytes,
            arena.resident_bytes())


def assert_same(ours, theirs, datas=()):
    assert state(ours) == state(theirs)
    for d in datas:
        loc = ours.offset_of(blob_pool.blob_key(d))
        if loc is not None:
            off, ln = loc
            assert ours.arena[off: off + ln].numpy().tobytes() == d
            assert np.asarray(theirs.arena[off: off + ln]).tobytes() == d


def test_blob_key_and_pad_len_equal_jax():
    for d in (b"", b"x", b"hello blob" * 1000):
        assert blob_pool.blob_key(d) == j_pool.blob_key(d)
    for n in (0, 1, 4095, 4096, 4097, 120_000, 1 << 20):
        assert blob_pool._pad_len(n) == j_pool._pad_len(n)


def test_put_offset_roundtrip():
    ours, theirs = pair(1 << 20)
    key = ours.put(b"hello blob")
    assert key == theirs.put(b"hello blob")
    assert ours.offset_of(key) == theirs.offset_of(key) == (0, 10)
    assert_same(ours, theirs, [b"hello blob"])
    assert ours.device_bytes() == theirs.device_bytes() == 1 << 20
    assert ours.arena.device == torch.device("cpu")


def test_idempotent_puts_and_eviction_equal_jax():
    ours, theirs = pair(16 * 4096)
    datas = [b"a" * 100, b"a" * 100] + [bytes([i]) * 5000 for i in range(20)]
    for d in datas:
        assert ours.put(d) == theirs.put(d)
        assert_same(ours, theirs, datas)


def test_semispace_flip_equal_jax():
    """The flip sequence of tests/test_blob_pool.py: fill the active half,
    flip to the other, fill it, flip back and evict the first half."""
    ours, theirs = pair(16 * 4096)
    datas = []
    i = 0
    while ours._next + 4096 <= ours._half:
        datas.append(bytes([i + 1]) * 3000)
        i += 1
        ours.put(datas[-1])
        theirs.put(datas[-1])
    datas.append(b"\xaa" * 3000)
    ours.put(datas[-1])
    theirs.put(datas[-1])
    assert ours.offset_of(blob_pool.blob_key(datas[-1]))[0] >= ours._half
    assert_same(ours, theirs, datas)
    while ours._next + 4096 <= 2 * ours._half:
        d = bytes([200 + ours._next // 4096]) * 3000
        datas.append(d)
        ours.put(d)
        theirs.put(d)
    datas.append(b"\xbb" * 3000)
    ours.put(datas[-1])
    theirs.put(datas[-1])
    assert_same(ours, theirs, datas)
    assert ours.offset_of(blob_pool.blob_key(datas[0])) is None


def test_oversized_never_resident_equal_jax():
    ours, theirs = pair(8192)
    for d in (b"s" * 100, b"x" * 20_000):
        ours.put(d)
        theirs.put(d)
    assert ours.offset_of(blob_pool.blob_key(b"x" * 20_000)) is None
    assert ours.offset_of(blob_pool.blob_key(b"s" * 100)) is not None
    assert_same(ours, theirs, [b"s" * 100])


@pytest.mark.parametrize("capacity", [4096, 8192, 12_288, 16 * 4096 + 100, 3 * 4096 + 1])
def test_tail_bytes_and_degenerate_region_equal_jax(capacity):
    ours, theirs = pair(capacity)
    assert (ours._half, ours.tail_bytes) == (theirs._half, theirs.tail_bytes)
    rng = np.random.default_rng(capacity)
    datas = [rng.integers(0, 256, int(rng.integers(1, 6000)), dtype=np.uint8).tobytes()
             for _ in range(12)]
    for d in datas:
        ours.put(d)
        theirs.put(d)
        assert_same(ours, theirs, datas)


def test_put_many_equal_jax_and_gauges():
    ours, theirs = pair(24 * 4096)
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, int(rng.integers(1, 9000)), dtype=np.uint8).tobytes()
             for _ in range(10)]
    batch = datas + datas[:3] + [b"z" * 60_000]  # duplicates and one oversized blob
    assert ours.put_many(batch) == theirs.put_many(batch)
    assert_same(ours, theirs, datas)
    for name in GAUGES:
        assert metrics.get_gauge(name) == j_metrics.get_gauge(name), name
    more = [bytes([i]) * 7000 for i in range(12)]
    assert ours.put_many(more) == theirs.put_many(more)
    assert_same(ours, theirs, datas + more)
    ours.drop(blob_pool.blob_key(more[-1]))
    theirs.drop(j_pool.blob_key(more[-1]))
    assert_same(ours, theirs)


def test_put_many_equals_sequential_puts():
    rng = np.random.default_rng(6)
    datas = [rng.integers(0, 256, int(rng.integers(1, 9000)), dtype=np.uint8).tobytes()
             for _ in range(20)]
    a = blob_pool.DeviceBlobArena(16 * 4096, device="cpu")
    b = blob_pool.DeviceBlobArena(16 * 4096, device="cpu")
    keys = a.put_many(datas)
    assert keys == [b.put(d) for d in datas]
    assert state(a) == state(b)
    assert torch.equal(a.arena, b.arena)


def test_concurrent_puts_keep_offsets_consistent():
    """put from more threads than cores, with a short switch interval: every
    resident key's bytes sit at its offset whenever a reader holds the lock,
    and a proposal assembled under the lock keeps the host DAH."""
    from celestia_tpu_torch import square
    from celestia_tpu_torch.app import proposal
    from celestia_tpu_torch.ops import extend
    from celestia_tpu_torch.shares import to_bytes
    from tests.test_torch_chip_smoke import chip_smoke

    txs = chip_smoke.proposal_txs(n=3, size=3000)
    sq, _kept, builder = square.build_ex(txs, 1, 128)
    k = square.square_size(len(sq))
    host = np.frombuffer(b"".join(to_bytes(sq)), np.uint8).reshape(k, k, 512)
    want = [r.tobytes() for r in extend.roots_device(host, device="cpu")[0]]
    arena = blob_pool.DeviceBlobArena(32 * 4096, device="cpu")
    errors: list = []

    def churn(seed: int):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                arena.put(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
                arena.put_many([b.data for _s, b in builder.blob_layout()])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    workers = min(32, max(4, 2 * (os.cpu_count() or 1)))
    threads = [threading.Thread(target=churn, args=(s,)) for s in range(workers)]
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for _ in range(10):
            with arena.lock:
                for key, (off, ln) in list(arena._offsets.items()):
                    got = arena.arena[off: off + ln].numpy().tobytes()
                    assert blob_pool.blob_key(got) == key
            dah = proposal.assembled_proposal_dah(arena, sq, builder, k, device="cpu")
            assert dah is None or dah.row_roots == want
    finally:
        sys.setswitchinterval(old_interval)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
