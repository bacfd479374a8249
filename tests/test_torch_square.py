"""The port's square construction and commitments (celestia_tpu_torch.square,
inclusion, inclusion.cache) against the JAX package's, byte for byte.

The same txs (made with numpy from a seed) go through both packages'
``build`` / ``build_ex`` / ``construct`` / ``deconstruct`` and share-range
helpers: squares, kept txs, blob layouts, ranges and commitments must be
equal (tolerance 0: bytes). The cases mirror tests/test_square.py; the
squares are small (k <= 16) apart from one k = 64 construction. The DAH of
``da.extend_shares(to_bytes(construct(...)))`` (the port on the CPU) equals
the JAX package's.
"""

import numpy as np
import pytest

from celestia_tpu import blob as j_blob
from celestia_tpu import da as j_da
from celestia_tpu import inclusion as j_inclusion
from celestia_tpu import namespace as j_ns
from celestia_tpu import square as j_square
from celestia_tpu.inclusion import cache as j_cache
from celestia_tpu.shares import to_bytes as j_to_bytes
from celestia_tpu_torch import appconsts, da, inclusion, square
from celestia_tpu_torch import blob as blob_pkg
from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch.inclusion import cache
from celestia_tpu_torch.shares import to_bytes
from celestia_tpu_torch.shares.splitters import sparse_shares_needed

GOV = appconsts.DEFAULT_GOV_MAX_SQUARE_SIZE


def rand_bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def make_blob_tx(rng, blob_sizes, sub_id=None) -> bytes:
    """A BlobTx's wire bytes, built with the JAX package (the port's
    marshalling is held equal to it in test_torch_shares.py)."""
    blobs = [j_blob.new_blob(j_ns.new_v0(sub_id or rand_bytes(rng, 5)), rand_bytes(rng, s), 0)
             for s in blob_sizes]
    return j_blob.marshal_blob_tx(rand_bytes(rng, 64), blobs)


def sizes_of(btxs) -> dict:
    out = {}
    for btx in btxs:
        parsed, _ = blob_pkg.unmarshal_blob_tx(btx)
        out[parsed.tx] = [len(b.data) for b in parsed.blobs]
    return out


def assert_same_build(txs, max_size=GOV):
    """build_ex and construct_ex agree with the JAX package's: squares, kept
    txs and blob layouts."""
    sq, kept, builder = square.build_ex(txs, 1, max_size)
    j_sq, j_kept, j_builder = j_square.build_ex(txs, 1, max_size)
    assert to_bytes(sq) == j_to_bytes(j_sq)
    assert kept == j_kept
    assert [(s, b.data, b.namespace().bytes) for s, b in builder.blob_layout()] == [
        (s, b.data, b.namespace().bytes) for s, b in j_builder.blob_layout()]
    sq2, builder2 = square.construct_ex(kept, 1, max_size)
    assert to_bytes(sq2) == to_bytes(sq) == to_bytes(square.construct(kept, 1, max_size))
    assert builder2.num_txs() == j_builder.num_txs()
    return sq, kept, builder


def test_empty_square_equal_jax():
    sq, txs = square.build([], 1, 64)
    assert to_bytes(sq) == j_to_bytes(j_square.empty_square()) and txs == []
    assert to_bytes(square.construct([], 1, 64)) == to_bytes(square.empty_square())
    assert square.deconstruct(square.empty_square(), lambda tx: []) == []


def test_only_txs_equal_jax():
    rng = np.random.default_rng(1)
    assert_same_build([rand_bytes(rng, 100) for _ in range(5)])


@pytest.mark.parametrize("blob_sizes", [[100], [1000, 2000], [1, 478, 100000]])
def test_build_construct_equal_jax(blob_sizes):
    rng = np.random.default_rng(sum(blob_sizes))
    txs = [rand_bytes(rng, 50), rand_bytes(rng, 120)]
    sq, kept, _b = assert_same_build(txs + [make_blob_tx(rng, [s]) for s in blob_sizes])
    k = square.square_size(len(sq))
    assert k * k == len(sq) and k <= 16


def test_k64_construction_equal_jax():
    """One square at the governance default, k = 64: many blobs of odd
    sizes and normal txs."""
    rng = np.random.default_rng(64)
    txs = [rand_bytes(rng, int(rng.integers(1, 3000))) for _ in range(20)]
    txs += [make_blob_tx(rng, [int(rng.integers(1, 40_000)) for _ in range(3)])
            for _ in range(30)]
    sq, kept, _b = assert_same_build(txs)
    assert square.square_size(len(sq)) == 64 and kept == txs


def test_blobs_sorted_by_namespace_equal_jax():
    rng = np.random.default_rng(2)
    txs = [make_blob_tx(rng, [500], sub_id=b"\x09"), make_blob_tx(rng, [500], sub_id=b"\x01")]
    sq, _kept, _b = assert_same_build(txs, 64)
    blob_ns = [s.namespace() for s in sq if not s.namespace().is_reserved()]
    assert blob_ns == sorted(blob_ns, key=lambda n: n.bytes)


def test_deconstruct_equal_jax():
    rng = np.random.default_rng(3)
    btxs = [make_blob_tx(rng, [s]) for s in (100, 3000)]
    txs = [rand_bytes(rng, 80)] + btxs
    sq, kept, _b = assert_same_build(txs, 64)
    sizes = sizes_of(btxs)
    got = square.deconstruct(sq, lambda inner: sizes[inner])
    j_sq, _ = j_square.build(txs, 1, 64)
    assert got == kept == j_square.deconstruct(j_sq, lambda inner: sizes[inner])


def test_overflow_and_order_rules_equal_jax():
    rng = np.random.default_rng(4)
    big = [make_blob_tx(rng, [400_000]) for _ in range(10)]
    with pytest.raises(ValueError):
        square.construct(big, 1, 2)
    with pytest.raises(ValueError):
        j_square.construct(big, 1, 2)
    many = [make_blob_tx(rng, [100_000]) for _ in range(30)]
    sq, kept, _b = assert_same_build(many, 16)
    assert len(kept) < 30 and len(sq) <= 16 * 16
    bad = [make_blob_tx(rng, [100]), rand_bytes(rng, 50)]
    with pytest.raises(ValueError, match="can not be appended after blob tx"):
        square.construct(bad, 1, 64)
    # an index-wrapped inner tx: build drops it, construct rejects it, as in JAX
    wrapped = j_blob.marshal_blob_tx(j_blob.marshal_index_wrapper(b"inner", [1]),
                                     [j_blob.new_blob(j_ns.new_v0(b"\x01"), b"x" * 10, 0)])
    assert square.build([wrapped], 1, 64)[1] == j_square.build([wrapped], 1, 64)[1] == []
    with pytest.raises(ValueError):
        square.construct([wrapped], 1, 64)


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_roundtrip_equal_jax(trial):
    rng = np.random.default_rng(100 + trial)
    txs = [rand_bytes(rng, int(rng.integers(1, 2000))) for _ in range(int(rng.integers(0, 5)))]
    btxs = [make_blob_tx(rng, [int(rng.integers(1, 20000)) for _ in range(int(rng.integers(1, 4)))])
            for _ in range(int(rng.integers(1, 6)))]
    sq, kept, _b = assert_same_build(txs + btxs, 64)
    sizes = sizes_of(btxs)
    assert square.deconstruct(sq, lambda inner: sizes[inner]) == kept


def test_share_ranges_equal_jax():
    rng = np.random.default_rng(5)
    txs = [rand_bytes(rng, 100), rand_bytes(rng, 600), make_blob_tx(rng, [500]),
           make_blob_tx(rng, [5000, 7])]
    for i in range(4):
        r, jr = square.tx_share_range(txs, i, 1), j_square.tx_share_range(txs, i, 1)
        assert (r.start, r.end) == (jr.start, jr.end) and 0 <= r.start < r.end
    for tx_index, blob_index in ((2, 0), (3, 0), (3, 1)):
        r = square.blob_share_range(txs, tx_index, blob_index, 1)
        jr = j_square.blob_share_range(txs, tx_index, blob_index, 1)
        assert (r.start, r.end) == (jr.start, jr.end)
    sq, _kept, _b = assert_same_build(txs)
    for n in (ns.TX_NAMESPACE, ns.PAY_FOR_BLOB_NAMESPACE, ns.TAIL_PADDING_NAMESPACE):
        r = square.get_share_range_for_namespace(sq, n)
        j_sq, _ = j_square.build(txs, 1, GOV)
        jr = j_square.get_share_range_for_namespace(j_sq, j_ns.from_bytes(n.bytes))
        assert (r.start, r.end) == (jr.start, jr.end)


def test_commitment_rules_equal_jax():
    for n in (0, 1, 2, 5, 17, 64, 65, 129, 4000):
        for t in (1, 64):
            if n:
                assert inclusion.sub_tree_width(n, t) == j_inclusion.sub_tree_width(n, t)
                assert inclusion.merkle_mountain_range_sizes(n, t) == \
                    j_inclusion.merkle_mountain_range_sizes(n, t)
            assert inclusion.next_share_index(13, max(n, 1), t) == \
                j_inclusion.next_share_index(13, max(n, 1), t)
        assert inclusion.blob_min_square_size(n) == j_inclusion.blob_min_square_size(n)
    rng = np.random.default_rng(6)
    sizes = [1, 478, 1000, 40_000]
    jb = [j_blob.new_blob(j_ns.new_v0(bytes([i + 1]) * 3), rand_bytes(rng, s), 0)
          for i, s in enumerate(sizes)]
    tb = [blob_pkg.new_blob(ns.new_v0(b.namespace_id[-10:]), b.data, 0) for b in jb]
    for t, j in zip(tb, jb):
        assert inclusion.create_commitment(t) == j_inclusion.create_commitment(j)
    assert inclusion.create_commitments(tb) == j_inclusion.create_commitments(jb)
    assert inclusion.fits_in_square(10, 16, 8, 300) == j_inclusion.fits_in_square(10, 16, 8, 300)


def test_commitment_from_square_equal_jax():
    """get_commitment over the port's EDS row trees (extended on the CPU)
    equals create_commitment, and the JAX package's get_commitment."""
    rng = np.random.default_rng(7)
    jblobs = [j_blob.new_blob(j_ns.new_v0(b"\x01\x02\x03"), rand_bytes(rng, 5000), 0),
              j_blob.new_blob(j_ns.new_v0(b"\x04\x05\x06"), rand_bytes(rng, 40_000), 0)]
    txs = [j_blob.marshal_blob_tx(rand_bytes(rng, 64), jblobs)]
    builder = square.Builder.from_txs(GOV, 1, txs)
    sq = builder.export()
    j_builder = j_square.Builder.from_txs(GOV, 1, txs)
    eds = da.extend_shares(to_bytes(sq), "cpu")
    cacher = cache.EDSSubtreeRootCacher(eds)
    j_cacher = j_cache.EDSSubtreeRootCacher(j_da.extend_shares(j_to_bytes(j_builder.export())))
    threshold = appconsts.subtree_root_threshold(1)
    for i, b in enumerate(jblobs):
        start = builder.find_blob_starting_index(0, i)
        assert start == j_builder.find_blob_starting_index(0, i)
        n = sparse_shares_needed(len(b.data))
        assert builder.blob_share_length(0, i) == n
        got = cache.get_commitment(cacher, start, n, threshold)
        assert got == j_cache.get_commitment(j_cacher, start, n, threshold)
        assert got == j_inclusion.create_commitment(b, threshold)


@pytest.mark.parametrize("blob_sizes", [[100], [3000, 20_000], [1, 477, 478, 479, 961]])
def test_dah_of_constructed_square_equal_jax(blob_sizes):
    rng = np.random.default_rng(len(blob_sizes))
    txs = [rand_bytes(rng, 200)] + [make_blob_tx(rng, [s]) for s in blob_sizes]
    sq = square.construct(txs, 1, GOV)
    dah = da.new_data_availability_header(da.extend_shares(to_bytes(sq), "cpu"))
    j_dah = j_da.new_data_availability_header(
        j_da.extend_shares(j_to_bytes(j_square.construct(txs, 1, GOV))))
    assert dah.row_roots == j_dah.row_roots and dah.column_roots == j_dah.column_roots
    assert dah.hash() == j_dah.hash()
