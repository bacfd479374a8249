"""The port's multi-GPU layer against the JAX package's parallel/ and the
port's own single-device path, byte for byte (a tolerance of 0 bytes).

Port meshes of ``torch.device("cpu")`` shards, (dp, sp) in (1, 2), (1, 4),
(2, 2) and (1, 8) at k = 8, and (1, 2) at k = 16 (``CASES``; the wrappers
run their plain versions on CPU tensors): ``extend_and_root_rowsharded``
dense and XOR,
``extend_root_levels_rowsharded`` (Row C), ``eds_row_levels_rowsharded``
and ``sharded_extend_and_root`` equal the port's single-device outputs and
the JAX package's host path (``celestia_tpu.da``; the row levels from the
JAX ``NmtRowProver``). Then the refusal of a k that sp does not divide, the
tree kernel's row-block mode against the (2k, 2k) tree,
``sharded_schedule_arrays`` against the JAX arrays, and
``device_put_sharded_rows`` (its bytes, fault site and audit) against the
JAX package's. ``test_torch_parallel_routing.py`` holds the JAX mesh
functions themselves, the routed entries and the pipeline.
"""

import functools

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu import parallel as jax_parallel
from celestia_tpu.ops import transfers as jax_transfers
from celestia_tpu.ops import xor_schedule as jax_xor_schedule
from celestia_tpu.proof import NmtRowProver as JaxNmtRowProver
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu.testutil.chaosnet import chain_shares
from celestia_tpu_torch import faults, integrity, parallel
from celestia_tpu_torch.ops import _cuda, extend, nmt_cuda, rs, transfers, xor_schedule
from celestia_tpu_torch.telemetry import metrics

CPU = torch.device("cpu")
MESHES = [(1, 2), (1, 4), (2, 2), (1, 8)]
# every mesh at k = 8, which already gives each sp its rows; k = 16 on one
# mesh (the plain SHA-256 of each CPU shard is what a case costs)
CASES = [(dp, sp, 8) for dp, sp in MESHES] + [(1, 2, 16)]
SEED = 1337


@pytest.fixture(autouse=True)
def _no_mesh():
    """No mesh outlives a test, in either package."""
    parallel.configure_mesh(None)
    jax_parallel.configure_mesh(None)
    yield
    parallel.configure_mesh(None)
    jax_parallel.configure_mesh(None)
    integrity.configure("off")


def cpu_mesh(dp: int, sp: int) -> parallel.Mesh:
    return parallel.make_mesh(dp, sp, [CPU] * (dp * sp))


def square(k: int, height: int = 3) -> np.ndarray:
    return np.frombuffer(b"".join(chain_shares(k, height)), np.uint8).reshape(k, k, 512).copy()


@functools.lru_cache(maxsize=None)
def single(k: int, height: int = 3):
    """The port's single-device outputs: (eds, rows, cols, dah) tensors and
    the row levels as numpy."""
    out = extend.extend_and_root(torch.from_numpy(square(k, height)), rs.encode_matrix(k, CPU))
    return out, extend.eds_row_levels_device(out[0], device="cpu")


@functools.lru_cache(maxsize=None)
def jax_host(k: int, height: int = 3):
    """The JAX package's host path: EDS, row and column roots, the DAH
    hash, and every row level from the JAX prover's memo."""
    eds = jax_da.extend_shares(square(k, height))
    dah = jax_da.new_data_availability_header(eds)
    w = 2 * k
    levels = [np.zeros((w, w >> lv, 90), np.uint8) for lv in range(w.bit_length())]
    for r in range(w):
        prover = JaxNmtRowProver(jax_da.erasured_axis_leaves(eds.row(r), r, k))
        for lv, out in enumerate(levels):
            span = 1 << lv
            for j in range(w >> lv):
                out[r, j] = np.frombuffer(prover._roots[(j * span, (j + 1) * span)], np.uint8)
    roots = lambda rr: np.frombuffer(b"".join(rr), np.uint8).reshape(w, 90)  # noqa: E731
    return eds.data, roots(eds.row_roots()), roots(eds.col_roots()), dah.hash(), levels


def same_as_references(k: int, out) -> None:
    """(eds, rows, cols, dah) equal the port's single-device route and the
    JAX host path."""
    (eds, rows, cols, dah), _levels = single(k)
    j_eds, j_rows, j_cols, j_dah, _j_levels = jax_host(k)
    for got, want, jwant in zip(out, (eds, rows, cols, dah), (j_eds, j_rows, j_cols, j_dah)):
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert np.array_equal(got, want.numpy())
        assert got.tobytes() == (jwant if isinstance(jwant, bytes) else jwant.tobytes())


def same_levels(k: int, levels) -> None:
    _out, want = single(k)
    j_levels = jax_host(k)[4]
    assert len(levels) == len(want) == len(j_levels)
    for got, a, b in zip(levels, want, j_levels):
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert np.array_equal(got, a) and np.array_equal(got, b)


# ---------------------------------------------------------------------- #
# the row-sharded spellings on every mesh


@pytest.mark.parametrize("dp,sp,k", CASES)
@pytest.mark.parametrize("xor", [False, True], ids=["dense", "xor"])
def test_extend_and_root_rowsharded(dp, sp, k, xor):
    out = parallel.extend_and_root_rowsharded(cpu_mesh(dp, sp), k, xor=xor)(square(k))
    same_as_references(k, out)


@pytest.mark.parametrize("dp,sp,k", CASES)
def test_extend_root_levels_rowsharded(dp, sp, k):
    """Row C: the EDS, roots and DAH of the extend and the levels of
    eds_row_levels_device, from one pass."""
    eds, rows, cols, dah, levels = parallel.extend_root_levels_rowsharded(
        cpu_mesh(dp, sp), k)(square(k))
    same_as_references(k, (eds, rows, cols, dah))
    same_levels(k, levels)
    assert levels[0].untyped_storage().data_ptr() == levels[-1].untyped_storage().data_ptr()


@pytest.mark.parametrize("dp,sp,k", CASES)
def test_eds_row_levels_rowsharded(dp, sp, k):
    (eds, _rows, _cols, _dah), _levels = single(k)
    same_levels(k, parallel.eds_row_levels_rowsharded(cpu_mesh(dp, sp), k)(eds.numpy()))


@pytest.mark.parametrize("dp,sp,k", CASES)
def test_sharded_extend_and_root(dp, sp, k):
    """The dp batch: one square a dp row, each row extending its own."""
    heights = list(range(1, dp + 1))
    batch = np.stack([square(k, h) for h in heights])
    eds, rows, cols, dah = parallel.sharded_extend_and_root(cpu_mesh(dp, sp), k)(batch)
    assert eds.shape == (len(heights), 2 * k, 2 * k, 512)
    for i, h in enumerate(heights):
        (s_eds, s_rows, s_cols, s_dah), _lv = single(k, h)
        assert torch.equal(eds[i], s_eds) and torch.equal(rows[i], s_rows)
        assert torch.equal(cols[i], s_cols)
        assert dah[i].numpy().tobytes() == s_dah.numpy().tobytes() == jax_host(k, h)[3]


def test_a_k_the_mesh_does_not_divide_is_refused():
    mesh = cpu_mesh(1, 3)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.extend_and_root_rowsharded(mesh, 8)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.extend_root_levels_rowsharded(mesh, 8)
    with pytest.raises(ValueError, match="sp"):
        parallel.eds_row_levels_rowsharded(mesh, 8)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.sharded_extend_and_root(mesh, 8)


# ---------------------------------------------------------------------- #
# the tree's row-block mode, the column-block schedules, the sharded upload


def _grid(k: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    grid = torch.randint(0, 2**32, (2 * k, 2 * k, 8), generator=g, dtype=torch.int64)
    grid = torch.where(grid >= 2**31, grid - 2**32, grid).to(torch.int32).view(torch.uint32)
    ns = torch.sort(torch.randint(0, 256, (k * k, 32), generator=g, dtype=torch.uint8),
                    dim=0).values.reshape(k, k, 32)
    return grid, ns


def _ranges(k: int) -> list[tuple[int, int]]:
    """Row ranges [lo, lo + n) of the (2k, 2k) grid: all of them up to
    k = 2; at larger k those starting at the edges, inside a half and at the
    boundary, each one row long, to the boundary, and to the end."""
    w = 2 * k
    if k <= 2:
        return [(lo, n) for lo in range(w) for n in range(1, w - lo + 1)]
    starts = {0, 1, k // 2 + 1, k - 1, k, k + 3, w - 1}
    return sorted({(lo, n) for lo in starts for n in {1, max(k - lo, 1), w - lo}})


@pytest.mark.parametrize("k", [1, 2, 8])
def test_the_row_block_mode_equals_the_trees_rows(k):
    """Row ranges [lo, lo + n) of the (2k, 2k) grid (``_ranges``) through
    the plain row-block mode equal those rows of the whole tree (roots and
    levels); the column roots are the row-block mode over the transpose.
    The kernel wrapper on CPU tensors runs the plain version and counts no
    launch."""
    grid, ns = _grid(k, k)
    quads = (grid[:k, :k], grid[:k, k:], grid[k:, :k], grid[k:, k:])
    roots, _none = nmt_cuda.nmt_tree_reference(quads, ns)
    _rows, levels = nmt_cuda.nmt_tree_reference(quads, ns, True)
    views = nmt_cuda.split_levels(levels, k)
    before = dict(_cuda.LAUNCHES)
    for lo, n in _ranges(k):
        top = max(0, min(lo + n, k) - lo)
        b0 = max(lo, k)
        tiles = (grid[lo:lo + top, :k], grid[lo:lo + top, k:],
                 grid[b0:lo + n, :k], grid[b0:lo + n, k:])
        got, got_levels = nmt_cuda.nmt_tree_rows(tiles, ns[lo:lo + top] if top else None, True)
        assert torch.equal(got[0], roots[0, lo:lo + n])
        for a, b in zip(nmt_cuda.split_levels(got_levels, k, n), views):
            assert torch.equal(a, b[lo:lo + n])
    cols, none = nmt_cuda.nmt_tree_rows(
        tuple(q.transpose(0, 1) for q in (quads[0], quads[2], quads[1], quads[3])),
        ns.transpose(0, 1))
    assert none is None and torch.equal(cols[0], roots[1])
    assert dict(_cuda.LAUNCHES) == before


def test_the_row_block_mode_refuses_bad_tiles():
    grid, ns = _grid(4, 0)
    with pytest.raises(ValueError, match="at least one row"):
        nmt_cuda.nmt_tree_rows((grid[:0, :4], grid[:0, 4:], grid[:0, :4], grid[:0, 4:]), None)
    with pytest.raises(ValueError, match="quadrant 1"):
        nmt_cuda.nmt_tree_rows((grid[:2, :4], grid[:3, 4:], grid[4:5, :4], grid[4:5, 4:]),
                               ns[:2])
    with pytest.raises(ValueError, match="q0_ns"):
        nmt_cuda.nmt_tree_rows((grid[:2, :4], grid[:2, 4:], grid[4:5, :4], grid[4:5, 4:]), None)


@pytest.mark.parametrize("k,sp", [(8, 2), (8, 4), (8, 8), (16, 2), (16, 8)])
def test_sharded_schedule_arrays_equal_the_jax_arrays(k, sp):
    ours = xor_schedule.sharded_schedule_arrays(k, sp)
    theirs = jax_xor_schedule.sharded_schedule_arrays(k, sp)
    assert ours[0].level_widths == theirs[0].level_widths
    for a, b in zip(ours[1:], theirs[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for i in range(sp):
        a, b = xor_schedule.compile_col_block(k, sp, i), jax_xor_schedule.compile_col_block(k, sp, i)
        assert a.level_widths == b.level_widths and np.array_equal(a.row_idx, b.row_idx)
        assert np.array_equal(a.flat_a, b.flat_a) and np.array_equal(a.flat_b, b.flat_b)


def test_device_put_sharded_rows_lands_each_block_and_counts_as_jax():
    k = 8
    sq = square(k)
    mesh = cpu_mesh(2, 4)
    site = "t.sharded"
    before = (metrics.get_counter("transfer_bytes", site=site, direction="h2d"),
              jax_metrics.get_counter("transfer_bytes", site=site, direction="h2d"))
    staged = transfers.device_put_sharded_rows(sq, mesh, site=site)
    jax_transfers.device_put_sharded_rows(sq, jax_parallel.make_mesh(dp=2, sp=4), site=site)
    assert staged.shape == sq.shape and staged.nbytes == sq.nbytes
    assert len(staged.shards) == 4 and staged.devices == [CPU] * 4
    assert np.array_equal(np.concatenate([t.numpy() for t in staged.shards]), sq)
    assert metrics.get_counter("transfer_bytes", site=site, direction="h2d") - before[0] == (
        sq.nbytes)
    assert jax_metrics.get_counter("transfer_bytes", site=site, direction="h2d") - before[1] == (
        sq.nbytes)
    with pytest.raises(ValueError, match="divide"):
        transfers.device_put_sharded_rows(sq[:6], mesh, site=site)


def test_device_put_sharded_rows_audits_as_jax():
    """Audits off: one transfer.chunk flip strikes the byte the JAX
    package's strikes. Audits full: a transient flip heals on its one
    retry; a persistent one raises."""
    sq = square(8)
    mesh = cpu_mesh(1, 2)
    with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        ours = transfers.device_put_sharded_rows(sq, mesh, site="t.flip")
    with jax_faults.inject(jax_faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        theirs = jax_transfers.device_put_sharded_rows(sq, jax_parallel.make_mesh(dp=1, sp=2),
                                                       site="t.flip")
    got = np.concatenate([t.numpy() for t in ours.shards])
    assert not np.array_equal(got, sq) and np.array_equal(got, np.asarray(theirs))
    integrity.configure("full")
    before = metrics.get_counter("transfer_retry_total", site="t.audit", direction="h2d")
    with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
        healed = transfers.device_put_sharded_rows(sq, mesh, site="t.audit")
    assert np.array_equal(np.concatenate([t.numpy() for t in healed.shards]), sq)
    assert metrics.get_counter("transfer_retry_total", site="t.audit", direction="h2d") == (
        before + 1)
    with faults.inject(faults.rule("transfer.chunk", "bitflip"), seed=SEED):
        with pytest.raises(integrity.IntegrityError):
            transfers.device_put_sharded_rows(sq, mesh, site="t.audit")
