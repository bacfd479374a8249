"""The port's XOR schedule (compiler, evaluators, the plain versions of
kernels K5 and K6, operand layout) and its dense/XOR routing, against the
JAX package's ops/xor_schedule.py and extend_tpu routing.

The same numpy-seeded inputs go through both packages; outputs are index
arrays, code words and hashes, so the tolerance is exact equality. The JAX
side's Pallas kernels run in interpret mode, and its fused XOR kernel through
its eager reference, as its own tests run them on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import rs_pallas, rs_tpu
from celestia_tpu.ops import xor_schedule as jax_xs
from celestia_tpu_torch.app import calibration
from celestia_tpu_torch.ops import extend, rs, xor_cuda
from celestia_tpu_torch.ops import xor_schedule as xs

ALL_K = [1, 2, 4, 8, 16, 32, 64, 128]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("k", ALL_K)
def test_compile_schedule_matches_jax(k):
    ours, theirs = xs.compile_schedule(k), jax_xs.compile_schedule(k)
    assert ours.level_widths == theirs.level_widths
    for name in ("flat_a", "flat_b", "row_idx"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("n_in", "n_out", "n_nodes", "xor_ops", "cse_hits", "dense_ops"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert xs.schedule_stats(k) == jax_xs.schedule_stats(k)


@pytest.mark.parametrize("k", [1, 2, 8, 16])
def test_apply_planes_matches_numpy_and_jax(k):
    sched = xs.compile_schedule(k)
    planes = _bytes((8 * k, 300), seed=k) & 1
    expect = jax_xs.apply_planes_np(planes, jax_xs.compile_schedule(k))
    assert np.array_equal(xs.apply_planes_np(planes, sched), expect)
    got = xs.apply_planes(torch.from_numpy(planes), xs.schedule_index(sched, "cpu"))
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("k", [4, 16])
def test_encode2d_xor_plain_matches_pallas_kernels(k):
    x2 = _bytes((k, k * 512), seed=400 + k)
    ours = xor_cuda.encode2d_xor(torch.from_numpy(x2), xor_cuda.schedule_operands(k, "cpu"))
    assert ours.dtype == torch.uint8
    xor_kernel = np.asarray(jax_xs.encode2d_xor(jnp.asarray(x2), interpret=True))
    dense_kernel = np.asarray(rs_pallas.encode2d(
        jnp.asarray(x2), jnp.asarray(rs_tpu.encode_bit_matrix(k)), interpret=True))
    assert np.array_equal(ours.numpy(), xor_kernel)
    assert np.array_equal(ours.numpy(), dense_kernel)


@pytest.mark.parametrize("k", [4, 16])
def test_encode2d_xor_hash_plain_matches_reference(k):
    x2 = _bytes((k, k * 512), seed=500 + k)
    parity, digests = xor_cuda.encode2d_xor_hash(
        torch.from_numpy(x2), xor_cuda.schedule_operands(k, "cpu"))
    ref_parity, ref_digests = jax_xs.encode2d_xor_hash_reference(x2, tile=k * 512)
    assert parity.dtype == torch.uint8 and digests.dtype == torch.uint32
    assert np.array_equal(parity.numpy(), ref_parity)
    assert np.array_equal(digests.numpy(), ref_digests)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_kernel_operands_encode_the_schedule(k):
    """The kernels' layout, decoded through each group's slot map, is the
    schedule: every node a group holds sits at its level with its flat_a /
    flat_b operands, every node is held by some group, the level widths
    are the schedule's, and each row's operands (its segments' slots, less
    the zero-plane padding) are its row_idx entries."""
    sched = xs.compile_schedule(k)
    ops = xor_cuda.schedule_operands(k, "cpu")
    lay = ops.layout
    assert np.array_equal(ops.prog.numpy().view(np.uint32), lay.prog)
    first, zero = sched.n_in + 1, 8 * k
    level_of = np.repeat(np.arange(len(sched.level_widths)), sched.level_widths)
    held = np.zeros(sched.n_nodes, bool)
    spc = k // lay.groups
    for g in range(lay.groups):
        prog, slot = lay.prog[g], lay.plane_slot[g]
        plane = {int(sl): p for p, sl in enumerate(slot) if sl >= 0}
        for lv in range(lay.n_levels):
            count, off = prog[xor_cuda.HEADER + lv], prog[xor_cuda.HEADER + lay.n_levels + lv]
            for e0, dest in prog[off: off + 2 * count].reshape(-1, 2).astype(np.int64):
                a, b = e0 & 0xFFFF, e0 >> 16
                if a >= zero and a < zero + 8 and b >= zero and b < zero + 8:
                    continue  # a padding thread of the quarter
                t = plane[int(dest)] - first
                assert level_of[t] == lv and (lay.groups > 1 or not held[t])
                assert {plane[int(a)], plane[int(b)]} == {int(sched.flat_a[t]), int(sched.flat_b[t])}
                held[t] = True
        pairs, words = lay.row_program(g)
        words = words.astype(np.int64)
        got: dict[int, list[int]] = {}
        for t in range(xor_cuda.ENC_THREADS):
            dest, n = words[t] & 0xFFFF, words[t] >> 16
            if dest >= lay.segs * 8 * spc:
                continue  # a thread with no row
            s_l, res = divmod(int(dest) % (8 * spc), 8)
            row = 8 * (g * spc + s_l) + ((res - s_l) & 7)
            slots = np.stack([pairs[:n, t] & 0xFFFF, pairs[:n, t] >> 16], 1).reshape(-1)
            got.setdefault(row, []).extend(plane[int(sl)] for sl in slots if not zero <= sl < zero + 8)
        for row, planes in got.items():
            expect = [int(p) for p in sched.row_idx[row] if p != sched.zero]
            assert sorted(planes) == sorted(expect), row
        assert sorted(got) == list(range(8 * g * spc, 8 * (g + 1) * spc))
    assert held.all()  # so each level's held nodes are its level_widths

    assert xor_cuda.schedule_operands(k, torch.device("cpu")) is ops


def test_plain_index_is_built_at_the_first_plain_call():
    """The kernel operands do not carry the plain versions' int64 index
    tensors until a plain version asks for them, once."""
    ops = xor_cuda.operands_from_schedule(xs.compile_schedule(4), "cpu")
    assert "index" not in vars(ops)
    xor_cuda.encode2d_xor_reference(torch.from_numpy(_bytes((4, 2048), seed=3)), ops)
    index = vars(ops)["index"]
    assert index.sched is ops.sched and index.row_idx.dtype == torch.int64
    assert ops.index is index


def test_k1_schedule_is_a_copy():
    """k = 1: no node, no level, row width 1, parity = data."""
    sched = xs.compile_schedule(1)
    assert sched.n_nodes == 0 and sched.level_widths == () and sched.row_idx.shape == (8, 1)
    x2 = torch.from_numpy(_bytes((1, 512), seed=1))
    ops = xor_cuda.schedule_operands(1, "cpu")
    assert torch.equal(xor_cuda.encode2d_xor(x2, ops), x2)
    lay = ops.layout
    assert lay.groups == 1 and lay.n_levels == 0 and lay.prog[0, xor_cuda.HEADER - 1] == 8


def test_kernel_wrappers_reject_bad_inputs():
    ops = xor_cuda.schedule_operands(2, "cpu")
    with pytest.raises(ValueError):
        xor_cuda.encode2d_xor(torch.zeros((2, 700), dtype=torch.uint8), ops)
    with pytest.raises(ValueError):
        xor_cuda.encode2d_xor_hash(torch.zeros((2, 700), dtype=torch.uint8), ops)


# ---- routing: the port's table and env pins (tests/test_xor_schedule.py:299)


@pytest.fixture
def table(monkeypatch):
    """Install a routing table (or None) as the loaded one."""
    monkeypatch.delenv(extend._XOR_ENV, raising=False)

    def install(t):
        monkeypatch.setattr(calibration, "_xor_table", t)
        monkeypatch.setattr(calibration, "_xor_loaded", True)

    return install


def test_env_pins(monkeypatch, table):
    table(calibration.CrossoverTable({64: {"dense": 1.0, "xor": 5.0}}))
    monkeypatch.setenv(extend._XOR_ENV, "0")
    assert not extend._xor_active(64)
    for on in ("1", "on", "TRUE"):
        monkeypatch.setenv(extend._XOR_ENV, on)
        assert extend._xor_active(64)
    # non-pow2 and out-of-range k: no schedule exists, even forced on
    assert not extend._xor_active(48)
    assert not extend._xor_active(512)
    monkeypatch.setenv(extend._FUSED_ENV, "off")
    assert not extend._fused_active(64)
    monkeypatch.setenv(extend._FUSED_ENV, "on")
    assert extend._fused_active(64)
    monkeypatch.delenv(extend._FUSED_ENV)
    assert extend._fused_active(64)


def test_auto_consults_the_table_with_the_nearest_rung(table):
    table(calibration.CrossoverTable({64: {"dense": 5.0, "xor": 1.0},
                                      16: {"dense": 1.0, "xor": 5.0}}))
    assert calibration.xor_winner(64) == "xor"
    assert calibration.xor_winner(16) == "dense"
    assert calibration.xor_winner(128) == "xor"  # nearest rung 64
    assert calibration.xor_winner(32) == "dense"  # tie between 16 and 64: the smaller
    assert extend._xor_active(64) and extend._xor_active(128)
    assert not extend._xor_active(16) and not extend._xor_active(2)


def test_winner_is_dense_without_a_table(table, tmp_path, monkeypatch):
    table(None)
    assert calibration.xor_winner(64) == "dense"
    assert not extend._xor_active(64)
    table(calibration.CrossoverTable({}))
    assert calibration.xor_winner(64) == "dense"
    # an absent or corrupt file loads as no table
    monkeypatch.setattr(calibration, "_xor_loaded", False)
    monkeypatch.setattr(calibration, "XOR_TABLE_PATH", tmp_path / "absent.json")
    assert calibration.load_xor_table() is None
    assert calibration.xor_winner(128) == "dense"
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert calibration.CrossoverTable.load(bad) is None


def test_table_is_the_ports_own_file(tmp_path):
    """The port reads celestia_tpu_torch/config/xor_schedule.json, never
    the JAX package's config/xor_schedule.json (TPU times)."""
    path = calibration.XOR_TABLE_PATH
    assert path.parent.parent.name == "celestia_tpu_torch"
    assert path.parent.name == "config" and path.name == "xor_schedule.json"
    t = calibration.CrossoverTable({32: {"dense": 2.5, "xor": 2.0}}, 7.0,
                                   "NVIDIA H100 80GB HBM3", "700.00 W")
    out = tmp_path / "t.json"
    out.write_text(json.dumps(t.to_json()))
    back = calibration.CrossoverTable.load(out)
    assert back == t and back.winner(32) == "xor"


def test_committed_table_if_any_parses_with_its_card():
    if not calibration.XOR_TABLE_PATH.exists():
        assert calibration.CrossoverTable.load(calibration.XOR_TABLE_PATH) is None
        return
    t = calibration.CrossoverTable.load(calibration.XOR_TABLE_PATH)
    assert t is not None and t.entries and t.card and t.power_limit
    for timings in t.entries.values():
        assert set(timings) == {"dense", "xor"}


def test_the_table_rule_keeps_rungs_whose_launches_do_not_overlap():
    """``calibration.xor_table_from_launches``, the rule of
    ``--xor-table-out`` and of ``measure_xor_crossover``: a rung's time is
    3 x the mean launch per spelling, and a rung enters the table only where
    the two spellings' launch ranges are apart."""
    per_launch = {16: {"dense": [0.010, 0.012], "xor": [0.011, 0.013]},  # overlap
                  64: {"dense": [0.040, 0.042], "xor": [0.050, 0.052]},
                  128: {"dense": [0.20, 0.21], "xor": [0.10, 0.11]}}
    table, rungs = calibration.xor_table_from_launches(per_launch, 5.0, "card", "700.00 W")
    assert sorted(table.entries) == [64, 128]
    assert table.entries[64] == pytest.approx({"dense": 0.123, "xor": 0.153})
    assert table.winner(64) == "dense" and table.winner(128) == "xor"
    assert table.winner(16) == "dense"  # the nearest resolved rung
    assert [rungs[k]["resolved"] for k in (16, 64, 128)] == [False, True, True]
    assert rungs[16]["xor_launch_range_ms"] == [0.011, 0.013]
    assert (table.card, table.power_limit, table.measured_at) == ("card", "700.00 W", 5.0)


def test_measure_xor_crossover_times_the_card_only():
    """The crossover is a device-time measurement: a CPU device is refused
    (None, the card, raises without one: tests/test_torch_imports.py)."""
    with pytest.raises(ValueError, match="needs a CUDA device"):
        calibration.measure_xor_crossover((4,), device="cpu")


def test_unpinned_route_follows_the_committed_table(monkeypatch):
    monkeypatch.delenv(extend._XOR_ENV, raising=False)
    monkeypatch.setattr(calibration, "_xor_loaded", False)
    committed = calibration.load_xor_table()
    for k in ALL_K:
        winner = committed.winner(k) if committed else "dense"
        assert extend._xor_active(k) == (winner == "xor")


def test_routes_agree_under_a_table_that_picks_xor(table, monkeypatch):
    k = 4
    table(calibration.CrossoverTable({k: {"dense": 5.0, "xor": 1.0}}))
    sq = torch.from_numpy(_bytes((k, k, 512), seed=9))
    m2 = rs.encode_matrix(k, torch.device("cpu"))
    asked = []
    real = xor_cuda.schedule_operands
    monkeypatch.setattr(xor_cuda, "schedule_operands",
                        lambda kk, dev: asked.append(kk) or real(kk, dev))
    auto = extend._roots(sq, m2)
    assert asked == [k]  # the table sent the extend through the schedule
    pinned = extend._roots(sq, m2, fused=True, xor=False)
    for a, b in zip(auto, pinned):
        assert torch.equal(a, b)
