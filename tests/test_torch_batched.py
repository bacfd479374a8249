"""The roots-only core, the batched entries and the strided encode layout,
byte for byte against the JAX package.

The JAX side: ``extend_tpu.batched_roots_device`` and ``_batch_chunk``
themselves, and for every square the JAX package's host path
(``celestia_tpu.da.extend_shares``: Leopard's encode and hashlib NMTs), which
its own tests hold equal to its device path. The port runs with
device="cpu", where the kernel wrappers take their plain versions.
"""

import functools

import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import extend, rs, rs_cuda
from tests.test_torch_extend import square

SMALL_K = [1, 2, 4, 8, 16]
BATCHES = [1, 2, 3, 5]
CPU = torch.device("cpu")
ROUTES = [(True, False), (True, True), (False, False), (False, True)]
ROUTE_IDS = ["fused-dense", "fused-xor", "unfused-dense", "unfused-xor"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def squares(k: int, b: int) -> np.ndarray:
    return np.stack([square(k, seed=1000 * k + i) for i in range(b)])


@functools.lru_cache(maxsize=None)
def jax_host(k: int, seed: int):
    """The JAX package's host path for one square: (eds, rows, cols, dah)."""
    sq = square(k, seed=seed)
    eds = jax_da.extend_shares(sq.reshape(k * k, SHARE_SIZE))
    rows = np.stack([np.frombuffer(r, np.uint8) for r in eds.row_roots()])
    cols = np.stack([np.frombuffer(c, np.uint8) for c in eds.col_roots()])
    return eds.data, rows, cols, jax_da.new_data_availability_header(eds).hash()


def jax_roots(k: int, b: int):
    outs = [jax_host(k, 1000 * k + i) for i in range(b)]
    return np.stack([o[1] for o in outs]), np.stack([o[2] for o in outs])


def test_batch_chunk_table_matches_reference():
    table = {(k, b): extend._batch_chunk(k, b) for k in range(1, 129) for b in range(1, 10)}
    assert table == {(k, b): extend_tpu._batch_chunk(k, b)
                     for k in range(1, 129) for b in range(1, 10)}


# every batch size at k = 2, and every k at B = 2
BATCH_CASES = [(2, b) for b in BATCHES] + [(k, 2) for k in SMALL_K if k != 2]


@pytest.mark.parametrize("k,b", BATCH_CASES)
def test_batched_roots_device_lists_and_stacked(k, b):
    sq = squares(k, b)
    want_rows, want_cols = jax_roots(k, b)
    for shares in (sq, list(sq)):
        rows, cols = extend.batched_roots_device(shares, device="cpu")
        assert rows.shape == (b, 2 * k, 90) and cols.shape == (b, 2 * k, 90)
        assert np.array_equal(rows, want_rows) and np.array_equal(cols, want_cols)


@pytest.mark.parametrize("k,b", [(2, 3)])
def test_batched_roots_device_matches_jax_entry(k, b):
    sq = squares(k, b)
    j_rows, j_cols = extend_tpu.batched_roots_device(list(sq))
    rows, cols = extend.batched_roots_device(list(sq), device="cpu")
    assert np.array_equal(rows, np.asarray(j_rows)) and np.array_equal(cols, np.asarray(j_cols))


@pytest.mark.parametrize("chunk", [1, 2])
def test_batched_chunks_and_ragged_tail(chunk, monkeypatch):
    """The chunked branch (k = 128's on the card: chunks of at most 2 and a
    ragged tail a square at a time) at a small k, the chunk rule pinned;
    every square is staged on its own, never stacked on the host."""
    k, b = 4, 5
    sq = squares(k, b)
    monkeypatch.setattr(extend, "_batch_chunk", lambda _k, _b: chunk)
    staged = []
    stage = extend._stage

    def spy_stage(arr, dev):
        staged.append(tuple(arr.shape))
        return stage(arr, dev)

    monkeypatch.setattr(extend, "_stage", spy_stage)
    for shares in (list(sq), sq):
        staged.clear()
        rows, cols = extend.batched_roots_device(shares, device="cpu")
        want_rows, want_cols = jax_roots(k, b)
        assert np.array_equal(rows, want_rows) and np.array_equal(cols, want_cols)
        assert staged == [(k, k, SHARE_SIZE)] * b


def test_batched_roots_device_refuses_mixed_sizes():
    with pytest.raises(ValueError):
        extend.batched_roots_device([square(2), square(4)], device="cpu")
    with pytest.raises(ValueError):
        extend.batched_roots_device([], device="cpu")


@pytest.mark.parametrize("k", [2, 8])
def test_extend_and_root_batched_matches_jax(k):
    b = 3
    sq = squares(k, b)
    eds, rows, cols, dah = extend.extend_and_root_batched(
        torch.from_numpy(sq), rs.encode_matrix(k, CPU))
    for i in range(b):
        j_eds, j_rows, j_cols, j_dah = jax_host(k, 1000 * k + i)
        assert np.array_equal(eds[i].numpy(), j_eds)
        assert np.array_equal(rows[i].numpy(), j_rows)
        assert np.array_equal(cols[i].numpy(), j_cols)
        assert dah[i].numpy().tobytes() == j_dah
    b_rows, b_cols = extend.roots_only_batched(torch.from_numpy(sq), rs.encode_matrix(k, CPU))
    assert torch.equal(b_rows, rows) and torch.equal(b_cols, cols)


@pytest.mark.parametrize("fused,xor", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("k", [2, 8])
def test_rows_cols_only_equals_roots_device_on_every_route(k, fused, xor, monkeypatch):
    monkeypatch.setenv(extend._FUSED_ENV, "1" if fused else "0")
    monkeypatch.setenv(extend._XOR_ENV, "1" if xor else "0")
    sq = square(k, seed=1000 * k)
    rows, cols = extend._rows_cols_only(torch.from_numpy(sq), rs.encode_matrix(k, CPU))
    d_rows, d_cols = extend.roots_device(sq, device="cpu")
    _eds, j_rows, j_cols, _dah = jax_host(k, 1000 * k)
    assert np.array_equal(rows.numpy(), d_rows) and np.array_equal(cols.numpy(), d_cols)
    assert np.array_equal(d_rows, j_rows) and np.array_equal(d_cols, j_cols)
    eds, (e_rows, e_cols) = extend._roots(torch.from_numpy(sq), rs.encode_matrix(k, CPU),
                                          fused=fused, xor=xor)
    assert np.array_equal(eds.numpy(), _eds)
    assert torch.equal(e_rows, rows) and torch.equal(e_cols, cols)


def test_roots_only_core_assembles_no_eds(monkeypatch):
    """The fused dense roots-only core never allocates a (2k, 2k, 512)
    buffer; the resident path allocates one and copies Q0 into it once."""
    k = 4
    made = []
    new_eds = extend._new_eds

    def spy(q0):
        made.append(q0.shape)
        return new_eds(q0)

    monkeypatch.setattr(extend, "_new_eds", spy)
    m2 = rs.encode_matrix(k, CPU)
    x = torch.from_numpy(square(k))
    extend._rows_cols_only(x, m2, fused=True, xor=False)
    assert made == []
    extend._roots(x, m2, fused=True, xor=False)
    assert made == [(k, k, SHARE_SIZE)]


@pytest.mark.parametrize("k", SMALL_K)
def test_strided_encode_plain_matches_extend_quadrants(k):
    """The in-place layout: each quadrant encode reads and writes EDS views
    at shard and cell strides that are multiples of 512 (column extend
    (2k·512, 512), row extend (512, 2k·512)); through the plain path it
    equals the glue spelling, rs.extend_quadrants, and the JAX package."""
    q0 = torch.from_numpy(square(k, seed=7 + k))
    m2 = rs.encode_matrix(k, CPU)
    eds = rs_cuda.extend_square(q0, m2, rs_cuda.encode_into_reference)
    glue = rs.extend_quadrants(q0, lambda x: rs_cuda.encode2d_reference(x, m2))
    assert torch.equal(eds, glue)
    assert np.array_equal(eds.numpy(), jax_da.extend_shares(
        q0.numpy().reshape(k * k, SHARE_SIZE)).data)
    row = 2 * k * SHARE_SIZE
    layout = [(rs_cuda.check_cells(src, "src", (k, k, SHARE_SIZE), CPU),
               rs_cuda.check_cells(dst, "dst", (k, k, SHARE_SIZE), CPU))
              for src, dst in rs_cuda.eds_quadrants(eds, eds[:k, :k])]
    assert layout == [((row, SHARE_SIZE), (row, SHARE_SIZE)),
                      ((SHARE_SIZE, row), (SHARE_SIZE, row)),
                      ((SHARE_SIZE, row), (SHARE_SIZE, row))]
    # the strided form, through the wrapper, equals the contiguous one
    x2 = q0.reshape(k, k * SHARE_SIZE)
    out = torch.empty_like(q0)
    digests = rs_cuda.encode_hash_into(q0, out, m2)
    parity, want = rs_cuda.encode2d_hash(x2, m2)
    assert torch.equal(out.reshape(k, -1), parity) and torch.equal(digests, want)


def test_check_cells_refuses_bad_strides():
    k = 2
    eds = torch.zeros((2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8)
    with pytest.raises(ValueError):  # cells not contiguous
        rs_cuda.check_cells(eds[:k, :k].transpose(1, 2), "x", (k, SHARE_SIZE, k), CPU)
    with pytest.raises(ValueError):  # a stride that is not a multiple of 512
        rs_cuda.check_cells(torch.zeros((k, k, SHARE_SIZE + 16), dtype=torch.uint8)[..., :SHARE_SIZE],
                            "x", (k, k, SHARE_SIZE), CPU)
    with pytest.raises(ValueError):
        rs_cuda.check_cells(eds[:k, :k].float(), "x", (k, k, SHARE_SIZE), CPU)
