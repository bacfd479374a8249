"""The port's blob envelopes and share layer (celestia_tpu_torch.blob,
shares, shares.splitters, shares.parse, appconsts) against the JAX
package's, byte for byte.

Every input is made with numpy from a seed and goes through both packages:
the shares, ranges, counts, parsed txs and blobs, envelopes and sizes must
be equal (tolerance 0: bytes). The cases mirror tests/test_shares.py.
"""

import numpy as np
import pytest

from celestia_tpu import appconsts as j_appconsts
from celestia_tpu import blob as j_blob
from celestia_tpu import namespace as j_ns
from celestia_tpu import shares as j_shares
from celestia_tpu.shares import info_byte as j_info
from celestia_tpu.shares import parse as j_parse
from celestia_tpu.shares import splitters as j_split
from celestia_tpu_torch import appconsts, blob
from celestia_tpu_torch import namespace as ns
from celestia_tpu_torch import shares
from celestia_tpu_torch.shares import info_byte
from celestia_tpu_torch.shares import parse
from celestia_tpu_torch.shares import splitters as split


def rand_bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def blob_pair(sub_id: bytes, data: bytes):
    """The same blob in both packages."""
    return (j_blob.new_blob(j_ns.new_v0(sub_id), data, 0),
            blob.new_blob(ns.new_v0(sub_id), data, 0))


def datas(sh) -> list[bytes]:
    return [s.data for s in sh]


def test_appconsts_equal_jax():
    names = [n for n in dir(j_appconsts) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(appconsts, n) == getattr(j_appconsts, n), n
    for v in (0, 1, 2, 3):
        assert appconsts.square_size_upper_bound(v) == j_appconsts.square_size_upper_bound(v)
        assert appconsts.subtree_root_threshold(v) == j_appconsts.subtree_root_threshold(v)


@pytest.mark.parametrize("sizes", [[1], [100, 200, 300], [474], [475], [2000, 10, 5000],
                                   [1] * 100])
def test_compact_split_and_parse_equal_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    txs = [rand_bytes(rng, s) for s in sizes]
    j_sp = j_split.CompactShareSplitter(j_ns.TX_NAMESPACE, 0)
    t_sp = split.CompactShareSplitter(ns.TX_NAMESPACE, 0)
    for tx in txs:
        j_sp.write_tx(tx)
        t_sp.write_tx(tx)
    got = t_sp.export()
    assert datas(got) == datas(j_sp.export())
    assert parse.parse_txs(got) == txs == j_parse.parse_txs(j_sp.export())
    assert [s.reserved_bytes() for s in got] == [s.reserved_bytes() for s in j_sp.export()]


def test_compact_counter_equal_jax():
    rng = np.random.default_rng(3)
    jc, tc = j_split.CompactShareCounter(), split.CompactShareCounter()
    t_sp = split.CompactShareSplitter(ns.TX_NAMESPACE, 0)
    for size in [10, 474, 478, 1000, 3, 5000]:
        assert tc.add(size) == jc.add(size)
        t_sp.write_tx(rand_bytes(rng, size))
        assert tc.size() == jc.size() == t_sp.count()
    tc.revert()
    jc.revert()
    assert (tc.shares, tc.remainder) == (jc.shares, jc.remainder)


@pytest.mark.parametrize("sizes", [[1], [478], [479], [10, 1000, 100000], [477, 960, 961]])
def test_sparse_split_and_parse_equal_jax(sizes):
    rng = np.random.default_rng(len(sizes) * 7 + sizes[0])
    pairs = [blob_pair(bytes([i + 1]), rand_bytes(rng, s)) for i, s in enumerate(sizes)]
    got = split.split_blobs([t for _j, t in pairs])
    assert datas(got) == datas(j_split.split_blobs([j for j, _t in pairs]))
    parsed = parse.parse_blobs(got)
    assert [(b.data, b.namespace().bytes) for b in parsed] == [
        (t.data, t.namespace().bytes) for _j, t in pairs]


def test_shares_needed_equal_jax():
    for n in list(range(0, 2000, 7)) + [478, 479, 960, 961, 100000]:
        assert split.sparse_shares_needed(n) == j_split.sparse_shares_needed(n)
        assert split.compact_shares_needed(n) == j_split.compact_shares_needed(n)


def test_namespace_padding_and_padding_shares_equal_jax():
    rng = np.random.default_rng(9)
    (j1, t1), (j2, t2) = (blob_pair(bytes([i]), rand_bytes(rng, 10)) for i in (1, 2))
    jw, tw = j_split.SparseShareSplitter(), split.SparseShareSplitter()
    for w, a, b in ((jw, j1, j2), (tw, t1, t2)):
        w.write(a)
        w.write_namespace_padding_shares(3)
        w.write(b)
    assert datas(tw.export()) == datas(jw.export())
    assert len(parse.parse_blobs(tw.export())) == 2
    assert shares.tail_padding_share().data == j_shares.tail_padding_share().data
    assert shares.reserved_padding_share().data == j_shares.reserved_padding_share().data
    assert datas(shares.namespace_padding_shares(ns.new_v0(b"\x05"), 0, 2)) == datas(
        j_shares.namespace_padding_shares(j_ns.new_v0(b"\x05"), 0, 2))
    for n in (1, 2, 3, 5, 17, 128):
        assert shares.round_up_power_of_two(n) == j_shares.round_up_power_of_two(n)
        assert shares.round_down_power_of_two(n) == j_shares.round_down_power_of_two(n)


def test_split_txs_equal_jax():
    rng = np.random.default_rng(11)
    normal = [rand_bytes(rng, 50), rand_bytes(rng, 60)]
    pfb = blob.marshal_index_wrapper(rand_bytes(rng, 70), [5])
    assert pfb == j_blob.marshal_index_wrapper(pfb[2:72], [5])
    t_tx, t_pfb, t_ranges = split.split_txs(normal + [pfb])
    j_tx, j_pfb, j_ranges = j_split.split_txs(normal + [pfb])
    assert datas(t_tx) == datas(j_tx) and datas(t_pfb) == datas(j_pfb)
    assert {k: (r.start, r.end) for k, r in t_ranges.items()} == {
        k: (r.start, r.end) for k, r in j_ranges.items()}


def test_share_sequences_equal_jax():
    rng = np.random.default_rng(13)
    pairs = [blob_pair(b"\x01", rand_bytes(rng, 1000)), blob_pair(b"\x02", rand_bytes(rng, 10))]
    t_sh = split.split_blobs([t for _j, t in pairs]) + [shares.tail_padding_share()]
    j_sh = j_split.split_blobs([j for j, _t in pairs]) + [j_shares.tail_padding_share()]
    for ignore in (False, True):
        got = parse.parse_share_sequences(t_sh, ignore_padding=ignore)
        want = j_parse.parse_share_sequences(j_sh, ignore_padding=ignore)
        assert [(s.namespace.bytes, datas(s.shares)) for s in got] == [
            (s.namespace.bytes, datas(s.shares)) for s in want]


def test_share_accessors_equal_jax():
    rng = np.random.default_rng(17)
    t_sp = split.CompactShareSplitter(ns.PAY_FOR_BLOB_NAMESPACE, 0)
    t_sp.write_tx(rand_bytes(rng, 700))
    sh = t_sp.export() + split.split_blobs([blob_pair(b"\x03", rand_bytes(rng, 600))[1]])
    for s in sh:
        j = j_shares.Share(s.data)
        assert (s.namespace().bytes, s.version(), s.is_sequence_start(), s.sequence_len(),
                s.is_compact_share(), s.is_padding(), s.raw_data()) == (
            j.namespace().bytes, j.version(), j.is_sequence_start(), j.sequence_len(),
            j.is_compact_share(), j.is_padding(), j.raw_data())
    for b in range(256):
        got, want = info_byte.parse_info_byte(b), j_info.parse_info_byte(b)
        assert (got.version, got.is_sequence_start, int(got)) == (
            want.version, want.is_sequence_start, int(want))


def test_blob_tx_envelopes_equal_jax():
    rng = np.random.default_rng(19)
    j_b, t_b = blob_pair(b"\x07", rand_bytes(rng, 100))
    raw = blob.marshal_blob_tx(b"signed-tx-bytes", [t_b])
    assert raw == j_blob.marshal_blob_tx(b"signed-tx-bytes", [j_b])
    btx, ok = blob.unmarshal_blob_tx(raw)
    assert ok and btx.tx == b"signed-tx-bytes" and btx.blobs[0].data == t_b.data
    for junk in (b"\x01\x02\x03", rand_bytes(rng, 100), b"BLOB" + rand_bytes(rng, 20)):
        assert blob.unmarshal_blob_tx(junk)[1] == j_blob.unmarshal_blob_tx(junk)[1]
    raw = blob.marshal_index_wrapper(b"inner", [1, 500, 70000])
    assert raw == j_blob.marshal_index_wrapper(b"inner", [1, 500, 70000])
    w, ok = blob.unmarshal_index_wrapper(raw)
    assert ok and w.tx == b"inner" and w.share_indexes == [1, 500, 70000]
    for n in (0, 1, 127, 128, 16384, 1 << 16, 1 << 40):
        assert blob.uvarint(n) == j_blob.uvarint(n)
        assert blob.uvarint_len(n) == j_blob.uvarint_len(n)
        assert blob.read_uvarint(blob.uvarint(n), 0) == (n, len(blob.uvarint(n)))


@pytest.mark.parametrize("tx,idx", [(b"", []), (b"", [5]), (b"x" * 300, []),
                                    (b"x" * 300, [16384, 1]), (b"a", [0]),
                                    (b"y" * 127, [127, 128, 2**20])])
def test_index_wrapper_size_equal_jax(tx, idx):
    size = blob.marshal_index_wrapper_size(tx, idx)
    assert size == j_blob.marshal_index_wrapper_size(tx, idx) == len(
        blob.marshal_index_wrapper(tx, idx))
    assert blob.marshal_index_wrapper_with_head(blob._iw_tx_field(tx), idx) == \
        blob.marshal_index_wrapper(tx, idx) == j_blob.marshal_index_wrapper(tx, idx)


def test_parse_cache_is_byte_budgeted_as_in_jax():
    assert blob._PARSE_CACHE.budget == j_blob._PARSE_CACHE.budget
    assert blob._PARSE_CACHE.factor == j_blob._PARSE_CACHE.factor
    assert blob._IW_FIELD_CACHE.budget == j_blob._IW_FIELD_CACHE.budget
    lru = blob._ByteBudgetLRU(budget_bytes=100, overhead_factor=1)
    for i in range(5):
        lru.put(i, i, 30)
    assert lru.used <= 100 and lru.get(0) is None and lru.get(4) == 4
    lru.put("giant", 1, 101)
    assert lru.get("giant") is None
