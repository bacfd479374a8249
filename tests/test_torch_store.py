"""The port's block store (celestia_tpu_torch/store) against the JAX
package's (celestia_tpu/store).

The same seeded inputs (EDS bytes, a DAH document, row levels) go through
both packages' ``BlockStore`` in two directories: the files are
byte-identical, for k = 1 to 16, several ``rows_per_page`` values (short
tail pages included), with and without levels; each package reads the
other's directory (``read_page``, ``page_crcs``, ``read_dah``,
``read_levels``, ``reindex``). The cases of tests/test_store.py and the
store cases of tests/test_powercut.py run on both: re-index skip reasons,
compaction, the read-only state machine under ``enospc``, ``fsync_fail``
and ``short_write``, the ``store.write`` and ``store.read`` drills, each
with equal results and equal counter moves in each package's registry. The
``store`` command of the port's CLI gives the JAX command's JSON and exit
codes on the same directory.
"""

import errno
import json
import os
import shutil

import numpy as np
import pytest
import torch

from celestia_tpu import cli as jax_cli
from celestia_tpu import da as jax_da
from celestia_tpu import faults as jax_faults
from celestia_tpu import store as jax_store
from celestia_tpu.integrity import IntegrityError as JaxIntegrityError
from celestia_tpu.store import powercut as jax_powercut
from celestia_tpu.telemetry import metrics as jax_metrics
from celestia_tpu.testutil.chaosnet import chain_shares
from celestia_tpu_torch import cli, da, faults, store
from celestia_tpu_torch.integrity import IntegrityError
from celestia_tpu_torch.ops import extend
from celestia_tpu_torch.proof import NmtRowProver
from celestia_tpu_torch.store import powercut
from celestia_tpu_torch.telemetry import metrics

SEED = 1337
K = 4
W = 2 * K


def eds_bytes(k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(2 * k, 2 * k, 512), dtype=np.uint8)


def dah_doc(k: int, seed: int) -> dict:
    """A DAH document shaped like a served one: 2k row and 2k column roots
    of 90 bytes, hex."""
    r = np.random.default_rng(seed + 1)
    roots = r.integers(0, 256, size=(4 * k, 90), dtype=np.uint8)
    return {"row_roots": [x.tobytes().hex() for x in roots[:2 * k]],
            "column_roots": [x.tobytes().hex() for x in roots[2 * k:]]}


def levels_of(k: int, seed: int) -> list[np.ndarray]:
    """Row-tree levels of a 2k-wide square's shapes: (2k, 2k >> L, 90)."""
    r = np.random.default_rng(seed + 2)
    w = 2 * k
    return [r.integers(0, 256, size=(w, w >> lv, 90), dtype=np.uint8)
            for lv in range(w.bit_length())]


class Twin:
    """A JAX store and the port's, in two directories under one tmp_path."""

    def __init__(self, tmp_path, **kw):
        self.jax_root, self.port_root = tmp_path / "jax", tmp_path / "port"
        self.jax = jax_store.BlockStore(self.jax_root, **kw)
        self.port = store.BlockStore(self.port_root, **kw)

    def put(self, height: int, k: int = K, seed: int | None = None, levels: bool = False,
            **kw):
        seed = height if seed is None else seed
        arr, doc = eds_bytes(k, seed), dah_doc(k, seed)
        lv = levels_of(k, seed) if levels else None
        theirs = self.jax.put_eds(height, arr, k, dah_doc=doc, levels=lv, **kw)
        ours = self.port.put_eds(height, arr, k, dah_doc=doc, levels=lv, **kw)
        return theirs, ours, arr

    def files(self) -> tuple[dict, dict]:
        return ({p.name: p.read_bytes() for p in sorted(self.jax_root.iterdir())},
                {p.name: p.read_bytes() for p in sorted(self.port_root.iterdir())})

    def fresh(self, deep: bool = True):
        """Both directories re-adopted by fresh stores: (reports, stores)."""
        j = jax_store.BlockStore(self.jax_root)
        p = store.BlockStore(self.port_root)
        return (j.reindex(deep=deep), p.reindex(deep=deep)), (j, p)

    def both(self, fn) -> None:
        """fn(root) on each directory: the same damage in both."""
        fn(self.jax_root)
        fn(self.port_root)


def entry_fields(e) -> dict:
    return {f: getattr(e, f) for f in ("height", "k", "share_size", "rows_per_page", "page_count",
                                       "page_slot", "dah_len", "levels_len", "dah_crc",
                                       "levels_crc")}


def counters(name: str, **labels) -> tuple[float, float]:
    return jax_metrics.get_counter(name, **labels), metrics.get_counter(name, **labels)


def moved(before: tuple[float, float], name: str, **labels) -> tuple[float, float]:
    j, p = counters(name, **labels)
    return j - before[0], p - before[1]


# ---------------------------------------------------------------------- #
# the format: byte-identical files, and each package reads the other's


@pytest.mark.parametrize("with_levels", [False, True])
@pytest.mark.parametrize("rows_per_page", [2, 3, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_files_are_byte_identical(tmp_path, k, rows_per_page, with_levels):
    tw = Twin(tmp_path)
    theirs, ours, _arr = tw.put(5, k, seed=k * 100 + rows_per_page, levels=with_levels,
                                rows_per_page=rows_per_page)
    assert entry_fields(ours) == entry_fields(theirs)
    assert ours.rows_per_page == min(rows_per_page, 2 * k)
    if -(-2 * k // ours.rows_per_page) * ours.rows_per_page != 2 * k:
        assert ours.page_rows(ours.page_count - 1) < ours.rows_per_page  # a short tail page
    jf, pf = tw.files()
    assert list(pf) == ["5.ctps"] and pf == jf
    assert (ours.levels_len > 0) == with_levels


def test_torch_levels_pack_like_numpy():
    lv = levels_of(4, 9)
    blob = jax_store.pack_levels(lv)
    assert store.pack_levels([torch.from_numpy(x) for x in lv]) == blob
    assert store.pack_levels(lv) == blob
    back = store.unpack_levels(blob)
    assert all(np.array_equal(a, b) for a, b in zip(back, jax_store.unpack_levels(blob)))
    with pytest.raises(ValueError, match="on the host"):
        store.pack_levels([torch.zeros((1, 1, 90), dtype=torch.uint8, device="meta")])


def test_put_takes_a_cpu_tensor_like_numpy(tmp_path):
    tw = Twin(tmp_path)
    arr = eds_bytes(2, 3)
    tw.jax.put_eds(1, arr, 2, dah_doc=dah_doc(2, 3))
    tw.port.put_eds(1, torch.from_numpy(arr.copy()), 2, dah_doc=dah_doc(2, 3))
    jf, pf = tw.files()
    assert pf == jf


def _read_all(reader, height: int) -> dict:
    e = reader.entry(height)
    pages = [reader.read_page(height, i) for i in range(e.page_count)]
    lv = reader.read_levels(height)
    return {"pages": [(a.tobytes(), a.shape, crc) for a, crc in pages],
            "crcs": reader.page_crcs(height), "dah": reader.read_dah(height),
            "levels": None if lv is None else [(x.tobytes(), x.shape) for x in lv],
            "entry": entry_fields(e)}


@pytest.mark.parametrize("with_levels", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(tmp_path, writer, with_levels):
    root = tmp_path / "store"
    kind = jax_store if writer == "jax" else store
    w = kind.BlockStore(root)
    for h, rpp in ((1, 3), (2, 8)):
        w.put_eds(h, eds_bytes(8, h), 8, dah_doc=dah_doc(8, h),
                  levels=levels_of(8, h) if with_levels else None, rows_per_page=rpp)
    j, p = jax_store.BlockStore(root), store.BlockStore(root)
    assert p.reindex() == j.reindex() == {"heights": 2, "skipped": {}}
    for h in (1, 2):
        ours, theirs = _read_all(p, h), _read_all(j, h)
        assert ours == theirs
        assert b"".join(x[0] for x in ours["pages"]) == eds_bytes(8, h).tobytes()
        assert ours["dah"] == dah_doc(8, h)
    assert {k: v for k, v in p.stats().items()} == j.stats()


# ---------------------------------------------------------------------- #
# tests/test_store.py, on both packages


class TestRoundTrip:
    def test_pages_read_back_byte_identical(self, tmp_path):
        tw = Twin(tmp_path)
        eds = jax_da.extend_shares(chain_shares(K, 1))
        dah = jax_da.new_data_availability_header(eds)
        data = np.asarray(eds.data)
        for s in (tw.jax, tw.port):
            s.put_eds(1, data, K, dah_doc=dah.to_json(), rows_per_page=2)
        e = tw.port.entry(1)
        assert e is not None and e.page_count == W // 2
        got = np.concatenate([tw.port.read_page(1, i)[0] for i in range(e.page_count)])
        assert np.array_equal(got, data)
        assert tw.port.heights() == [1] and 1 in tw.port and len(tw.port) == 1
        assert tw.files()[0] == tw.files()[1]

    def test_dah_byte_identical(self, tmp_path):
        tw = Twin(tmp_path)
        eds = da.extend_shares(chain_shares(K, 1), device="cpu")
        dah = da.new_data_availability_header(eds)
        jeds = jax_da.extend_shares(chain_shares(K, 1))
        jdah = jax_da.new_data_availability_header(jeds)
        assert dah.to_json() == jdah.to_json()
        tw.jax.put_eds(1, np.asarray(jeds.data), K, dah_doc=jdah.to_json())
        tw.port.put_eds(1, eds.data, K, dah_doc=dah.to_json())
        back = da.DataAvailabilityHeader.from_json(tw.port.read_dah(1))
        assert back.hash() == dah.hash() == jdah.hash()
        assert tw.port.read_dah(1) == dah.to_json() == tw.jax.read_dah(1)
        assert tw.files()[0] == tw.files()[1]

    def test_reput_replaces_atomically(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        _t, _o, arr2 = tw.put(1, seed=99)  # same height, fresh bytes
        for s in (tw.jax, tw.port):
            assert len(s) == 1
            e = s.entry(1)
            got = np.concatenate([s.read_page(1, i)[0] for i in range(e.page_count)])
            assert np.array_equal(got, arr2)
        assert not list(tmp_path.rglob("*.tmp"))
        assert tw.files()[0] == tw.files()[1]

    def test_wrong_width_rejected(self, tmp_path):
        tw = Twin(tmp_path)
        for s in (tw.jax, tw.port):
            with pytest.raises(ValueError, match="EDS width 8 != 2\\*k for k=5"):
                s.put_eds(1, eds_bytes(K, 1), K + 1, dah_doc=dah_doc(K, 1))

    def test_stats_shape(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        tw.put(2, levels=True)
        for s in (tw.jax, tw.port):
            s.read_page(1, 0)
        ours, theirs = tw.port.stats(), tw.jax.stats()
        assert ours.pop("root") == str(tw.port_root) and theirs.pop("root") == str(tw.jax_root)
        assert ours == theirs
        assert ours["kind"] == "blockstore" and ours["heights"] == 2
        assert (ours["height_lo"], ours["height_hi"]) == (1, 2)
        assert ours["puts"] == 2 and ours["page_reads"] == 1
        assert metrics.get_gauge("store_heights") == 2.0
        assert metrics.get_gauge("store_bytes") == float(ours["bytes"])


class TestLevelsRoundTrip:
    def test_pack_unpack_identity(self):
        rng = np.random.default_rng(SEED)
        levels = [rng.integers(0, 256, size=(W, n, 90), dtype=np.uint8) for n in (8, 4, 2, 1)]
        blob = store.pack_levels(levels)
        assert blob == jax_store.pack_levels(levels)
        back = store.unpack_levels(blob)
        assert len(back) == len(levels)
        assert all(np.array_equal(a, b) for a, b in zip(levels, back))

    def test_stored_levels_seed_byte_identical_provers(self, tmp_path):
        """The port's device levels (on the CPU here) stored and read back
        seed provers equal to fresh ones; the file equals the one the JAX
        package writes with its own levels of the same square."""
        tw = Twin(tmp_path)
        eds = da.extend_shares(chain_shares(K, 1), device="cpu")
        dah = da.new_data_availability_header(eds)
        levels = extend.eds_row_levels_device(eds.device_data, device="cpu")
        jeds = jax_da.extend_shares(chain_shares(K, 1))
        from celestia_tpu.ops import extend_tpu

        jlevels = extend_tpu.eds_row_levels_device(np.asarray(jeds.data))
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(levels, jlevels))
        tw.port.put_eds(1, eds.data, K, dah_doc=dah.to_json(), levels=levels)
        tw.jax.put_eds(1, np.asarray(jeds.data), K, dah_doc=dah.to_json(), levels=jlevels)
        assert tw.files()[0] == tw.files()[1]
        loaded = tw.port.read_levels(1)
        assert loaded is not None and len(loaded) == len(levels)
        for i in (0, W // 2, W - 1):
            fresh = NmtRowProver.from_node_levels([lv[i] for lv in levels])
            stored = NmtRowProver.from_node_levels([lv[i] for lv in loaded])
            assert stored.root() == fresh.root() == dah.row_roots[i]
            p1, p2 = fresh.prove_range(1, 3), stored.prove_range(1, 3)
            assert (p1.start, p1.end, p1.nodes) == (p2.start, p2.end, p2.nodes)

    def test_absent_levels_read_as_none(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        assert tw.port.read_levels(1) is None and tw.jax.read_levels(1) is None


class TestReindexRecovery:
    """A restarted store adopts whatever a crash left: damaged files are
    quarantined with a labeled counter bump in both packages alike."""

    def test_truncated_tail_quarantined(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        tw.put(2)
        e = tw.port.entry(2)

        def damage(root):
            with open(root / "2.ctps", "r+b") as f:
                f.truncate(e.page_offset(0) + store.RECORD_HEADER_SIZE + 4)

        tw.both(damage)
        before = counters("store_reindex_skipped_total", reason="truncated")
        (theirs, ours), (j, p) = tw.fresh()
        assert ours == theirs == {"heights": 1, "skipped": {"truncated": 1}}
        assert 1 in p and 2 not in p and p.heights() == j.heights()
        assert moved(before, "store_reindex_skipped_total", reason="truncated") == (1.0, 1.0)

    def test_corrupt_page_quarantined_deep_refused_shallow(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        at = tw.port.entry(1).page_offset(0) + store.RECORD_HEADER_SIZE

        def damage(root):
            with open(root / "1.ctps", "r+b") as f:
                f.seek(at)
                byte = f.read(1)
                f.seek(at)
                f.write(bytes([byte[0] ^ 0x01]))

        tw.both(damage)
        (theirs, ours), (_j, p) = tw.fresh(deep=True)
        assert ours == theirs == {"heights": 0, "skipped": {"page_crc": 1}}
        assert 1 not in p
        (theirs, ours), (j, p) = tw.fresh(deep=False)
        assert ours == theirs == {"heights": 1, "skipped": {}}
        sdc = counters("sdc_detected_total", site="store.read")
        bad = counters("store_read_corrupt_total")
        with pytest.raises(JaxIntegrityError) as je:
            j.read_page(1, 0)
        with pytest.raises(IntegrityError) as pe:
            p.read_page(1, 0)
        assert pe.value.site == je.value.site == "store.read"
        assert str(pe.value).split(":")[0] == str(je.value).split(" — ")[0]
        assert moved(sdc, "sdc_detected_total", site="store.read") == (1.0, 1.0)
        assert moved(bad, "store_read_corrupt_total") == (1.0, 1.0)

    def test_duplicate_height_quarantined(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)
        tw.both(lambda root: shutil.copy(root / "1.ctps", root / "9.ctps"))
        (theirs, ours), (j, p) = tw.fresh()
        assert ours == theirs == {"heights": 1, "skipped": {"duplicate": 1}}
        assert p.heights() == j.heights() == [1]

    def test_garbage_empty_and_tmp_orphans(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)

        def damage(root):
            (root / "7.ctps").write_bytes(b"not a store file")
            (root / "8.ctps").write_bytes(b"")
            (root / "9.ctps.tmp").write_bytes(b"half-written")

        tw.both(damage)
        (theirs, ours), (j, p) = tw.fresh()
        assert ours == theirs == {"heights": 1, "skipped": {"bad_header": 2}}
        assert p.heights() == j.heights() == [1]

    def test_header_crc_damage_is_bad_header(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1)

        def damage(root):
            with open(root / "1.ctps", "r+b") as f:
                f.seek(8)  # inside the packed header fields
                f.write(b"\xff\xff")

        tw.both(damage)
        (theirs, ours), (_j, p) = tw.fresh()
        assert ours == theirs == {"heights": 0, "skipped": {"bad_header": 1}}
        assert len(p) == 0

    def test_damaged_dah_and_levels_refused_at_read(self, tmp_path):
        tw = Twin(tmp_path)
        tw.put(1, levels=True)
        e = tw.port.entry(1)

        def damage(root):
            with open(root / "1.ctps", "r+b") as f:
                for at in (store.HEADER_SIZE + 3, store.HEADER_SIZE + e.dah_len + 20):
                    f.seek(at)
                    byte = f.read(1)
                    f.seek(at)
                    f.write(bytes([byte[0] ^ 0x10]))

        tw.both(damage)
        (theirs, ours), (j, p) = tw.fresh()
        assert ours == theirs == {"heights": 1, "skipped": {}}  # the pages are sound
        for read in ("read_dah", "read_levels"):
            with pytest.raises(JaxIntegrityError):
                getattr(j, read)(1)
            with pytest.raises(IntegrityError) as pe:
                getattr(p, read)(1)
            assert pe.value.site == "store.read"


class TestDrills:
    def test_store_write_bitflip_caught_at_read(self, tmp_path):
        """Rot on disk: a store.write bitflip mangles a page AFTER its CRC
        was stamped; one seed flips the same bit in both packages."""
        tw = Twin(tmp_path)
        with jax_faults.inject(jax_faults.rule("store.write", "bitflip"), seed=SEED) as ji:
            tw.jax.put_eds(1, eds_bytes(K, 1), K, dah_doc=dah_doc(K, 1))
        with faults.inject(faults.rule("store.write", "bitflip"), seed=SEED) as pi:
            tw.port.put_eds(1, eds_bytes(K, 1), K, dah_doc=dah_doc(K, 1))
        assert [s for _q, s, _k in pi.schedule] == [s for _q, s, _k in ji.schedule] \
            == ["store.write"]
        assert tw.files()[0] == tw.files()[1]
        with pytest.raises(IntegrityError) as exc:
            tw.port.read_page(1, 0)
        assert exc.value.site == "store.read"
        (theirs, ours), _ = tw.fresh(deep=True)
        assert ours == theirs == {"heights": 0, "skipped": {"page_crc": 1}}

    @pytest.mark.parametrize("times", [1, None])
    def test_store_read_bitflip_refused(self, tmp_path, times):
        tw = Twin(tmp_path)
        tw.put(1)
        sdc = counters("sdc_detected_total", site="store.read")
        bad = counters("store_read_corrupt_total")
        with jax_faults.inject(jax_faults.rule("store.read", "bitflip", times=times), seed=SEED):
            with pytest.raises(JaxIntegrityError):
                tw.jax.read_page(1, 0)
        with faults.inject(faults.rule("store.read", "bitflip", times=times), seed=SEED):
            with pytest.raises(IntegrityError) as exc:
                tw.port.read_page(1, 0)
            if times is None:  # a persistent flip strikes every read
                with pytest.raises(IntegrityError):
                    tw.port.read_page(1, 0)
            else:  # a one-shot flip: the next read is clean
                tw.port.read_page(1, 0)
        assert exc.value.site == "store.read"
        jd, pd = moved(sdc, "sdc_detected_total", site="store.read")
        assert jd == 1.0 and pd == (2.0 if times is None else 1.0)
        assert moved(bad, "store_read_corrupt_total")[1] == pd
        assert tw.port.stats()["page_reads"] == (0 if times is None else 1)


class TestFormatConstants:
    def test_header_and_record_sizes_are_pinned(self):
        assert store.HEADER_SIZE == jax_store.HEADER_SIZE == 64
        assert store.RECORD_HEADER_SIZE == jax_store.RECORD_HEADER_SIZE == 16
        assert (store.MAGIC, store.VERSION, store.SUFFIX) == (
            jax_store.MAGIC, jax_store.VERSION, jax_store.SUFFIX)

    def test_fixed_page_offsets(self, tmp_path):
        tw = Twin(tmp_path)
        theirs, e, _arr = tw.put(1, rows_per_page=2)
        assert e.page_base == store.HEADER_SIZE + e.dah_len + e.levels_len == theirs.page_base
        for i in range(e.page_count):
            assert e.page_offset(i) == e.page_base + i * (
                store.RECORD_HEADER_SIZE + e.page_slot) == theirs.page_offset(i)
            assert e.page_rows(i) == 2 == theirs.page_rows(i)


# ---------------------------------------------------------------------- #
# compaction


@pytest.mark.parametrize("budget,keep_recent", [(0, 1), (0, 0), (10**9, 2), ("two", 16), ("two", 1)])
def test_compact_equals_jax(tmp_path, budget, keep_recent):
    tw = Twin(tmp_path)
    for h in range(1, 6):
        tw.put(h, levels=h % 2 == 0)
    size = tw.port.entry(1).page_offset(tw.port.entry(1).page_count)
    if budget == "two":
        budget = 2 * size + 10
    dahs = {h: tw.port.read_dah(h) for h in range(1, 6)}
    before = counters("store_compact_evicted_total")
    ours = tw.port.compact(budget, keep_recent=keep_recent)
    theirs = tw.jax.compact(budget, keep_recent=keep_recent)
    assert ours == theirs
    assert moved(before, "store_compact_evicted_total") == (ours["evicted"],) * 2
    assert tw.port.heights() == tw.jax.heights()
    assert tw.files()[0] == tw.files()[1]
    for h in tw.port.heights():  # retained DAH bytes unchanged
        assert tw.port.read_dah(h) == dahs[h]
    for h in ours["evicted_heights"]:
        with pytest.raises(KeyError):
            tw.port.read_page(h, 0)


def test_read_of_an_evicted_file_is_a_miss(tmp_path):
    tw = Twin(tmp_path)
    tw.put(1)
    stale = tw.port.entry(1)
    (tw.port_root / "1.ctps").unlink()  # a racing compaction's unlink
    tw.port._index[1] = stale  # a reader still holding the entry
    for read in (lambda: tw.port.read_page(1, 0), lambda: tw.port.page_crcs(1),
                 lambda: tw.port.read_dah(1)):
        with pytest.raises(KeyError, match="evicted"):
            read()


# ---------------------------------------------------------------------- #
# the store cases of tests/test_powercut.py: disk faults and the
# read-only state machine, on both packages


def synth_put(s, h: int, k: int = 2):
    pc = jax_powercut if isinstance(s, jax_store.BlockStore) else powercut
    return s.put_eds(h, pc._synthetic_eds(k, h), k, dah_doc=pc._synthetic_dah(h, k))


def each(tmp_path, **kw):
    """(faults module, store) for each package."""
    tw = Twin(tmp_path, **kw)
    return tw, ((jax_faults, tw.jax), (faults, tw.port))


class TestDiskFaultKinds:
    def test_enospc_raises_oserror_with_real_errno(self, tmp_path):
        _tw, pairs = each(tmp_path)
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError) as ei:
                    synth_put(s, 1)
            assert ei.value.errno == errno.ENOSPC and isinstance(ei.value, flt.FaultError)

    def test_fsync_fail_raises_eio_and_aborts_durable_put(self, tmp_path):
        tw, pairs = each(tmp_path, durable=True)
        for flt, s in pairs:
            with flt.inject(flt.rule("store.fsync", "fsync_fail"), seed=SEED):
                with pytest.raises(OSError) as ei:
                    synth_put(s, 1)
            assert ei.value.errno == errno.EIO
            assert s.heights() == [] and not s.read_only
        assert not list(tmp_path.rglob("*.tmp"))
        assert tw.port.stats()["write_errors"] == tw.jax.stats()["write_errors"] == 1

    def test_short_write_truncates_and_fails_like_a_torn_write(self, tmp_path):
        tw, pairs = each(tmp_path)
        before = counters("store_put_aborted_total", reason="short_write")
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "short_write"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
            assert s.heights() == [] and not s.read_only
        assert moved(before, "store_put_aborted_total", reason="short_write") == (1.0, 1.0)
        assert not list(tmp_path.rglob("*.tmp"))
        assert tw.files() == ({}, {})


def _stats(s) -> dict:
    out = dict(s.stats())
    out.pop("root")
    return out


class TestEnospcDegradation:
    def test_enospc_enters_sticky_read_only(self, tmp_path):
        tw, pairs = each(tmp_path)
        ro = counters("store_read_only_total")
        ab = counters("store_put_aborted_total", reason="enospc")
        for flt, s in pairs:
            synth_put(s, 1)
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 2)
            assert s.read_only and s.read_only_reason == "enospc"
            s.read_dah(1)  # heights from before the degradation keep serving
            s.read_page(1, 0)
        assert moved(ro, "store_read_only_total") == (1.0, 1.0)
        assert moved(ab, "store_put_aborted_total", reason="enospc") == (1.0, 1.0)
        assert metrics.get_gauge("store_read_only") == 1.0
        assert _stats(tw.port) == _stats(tw.jax)
        assert not list(tmp_path.rglob("*.tmp"))

    def test_read_only_puts_skip_without_firing_write_site(self, tmp_path):
        _tw, pairs = each(tmp_path, reprobe_interval_s=3600.0)
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
        skip = counters("store_put_aborted_total", reason="read_only")
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "delay", delay_s=0.0), seed=SEED) as inj:
                assert synth_put(s, 2) is None
            assert not inj.schedule
        assert moved(skip, "store_put_aborted_total", reason="read_only") == (1.0, 1.0)

    def test_degradation_cleans_orphaned_tmp_files(self, tmp_path):
        tw, pairs = each(tmp_path)
        for flt, s in pairs:
            orphan = s.root / "999.ctps.tmp"
            orphan.write_bytes(b"abandoned by a previous crash")
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
            assert not orphan.exists()

    def test_reprobe_put_is_the_probe_and_recovers(self, tmp_path):
        tw, pairs = each(tmp_path, reprobe_interval_s=0.0)
        rec = counters("store_read_only_recovered_total")
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
            assert s.read_only
            synth_put(s, 2)  # space is back: the next put is the probe, and it lands
            assert not s.read_only and s.heights() == [2]
        assert moved(rec, "store_read_only_recovered_total") == (1.0, 1.0)
        assert metrics.get_gauge("store_read_only") == 0.0
        assert tw.files()[0] == tw.files()[1]

    def test_failed_reprobe_re_enters_and_pushes_the_clock(self, tmp_path):
        _tw, pairs = each(tmp_path, reprobe_interval_s=0.0)
        ro = counters("store_read_only_total")
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc", times=2), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
                with pytest.raises(OSError):
                    synth_put(s, 2)
            assert s.read_only
        assert moved(ro, "store_read_only_total") == (1.0, 1.0)

    def test_try_recover_probes_through_the_shim(self, tmp_path):
        tw, pairs = each(tmp_path)
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
            with flt.inject(flt.rule("store.fsync", "fsync_fail"), seed=SEED):
                assert not s.try_recover()
            assert s.read_only
            assert s.try_recover() and not s.read_only
            assert not (s.root / ".writable.probe").exists()
            synth_put(s, 2)
            assert 2 in s.heights()
        assert _stats(tw.port) == _stats(tw.jax)

    def test_operator_force_is_sticky_until_explicit_recover(self, tmp_path):
        _tw, pairs = each(tmp_path, reprobe_interval_s=0.0)
        for _flt, s in pairs:
            s.force_read_only("operator")
            assert s.read_only and s.read_only_reason == "operator"
            assert synth_put(s, 1) is None and s.read_only
            assert s.try_recover() and not s.read_only

    def test_stats_surface_the_degradation(self, tmp_path):
        tw, pairs = each(tmp_path)
        for flt, s in pairs:
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 1)
        ours = _stats(tw.port)
        assert ours == _stats(tw.jax)
        assert ours["read_only"] is True and ours["read_only_reason"] == "enospc"
        assert ours["put_aborts"] == 1 and ours["write_errors"] == 1

    def test_emergency_compact_on_degradation(self, tmp_path):
        tw, pairs = each(tmp_path, emergency_compact_bytes=1)
        for flt, s in pairs:
            for h in range(1, 20):
                synth_put(s, h)
            with flt.inject(flt.rule("store.write", "enospc"), seed=SEED):
                with pytest.raises(OSError):
                    synth_put(s, 20)
        assert tw.port.heights() == tw.jax.heights() == list(range(4, 20))
        assert _stats(tw.port) == _stats(tw.jax)


# ---------------------------------------------------------------------- #
# the store command of the CLI


def run_cli(main, argv, capsys) -> tuple[int, str, str]:
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = int(e.code or 0)
    out, err = capsys.readouterr()
    return code, out, err


def _grown_home(tmp_path):
    home = tmp_path / "home"
    s = store.BlockStore(home / "store")
    for h in range(1, 5):
        s.put_eds(h, eds_bytes(2, h), 2, dah_doc=dah_doc(2, h), levels=levels_of(2, h))
    return home, s


CLI_CASES = {
    "stat": (["store", "stat"], None),
    "verify_clean": (["store", "verify"], None),
    "verify_damaged": (["store", "verify"], "damage"),
    "stat_damaged": (["store", "stat"], "damage"),
    "compact_no_budget": (["store", "compact"], None),
    "compact_over_budget": (["store", "compact", "--byte-budget", "0", "--keep-recent", "2"], None),
    "compact_fits": (["store", "compact", "--byte-budget", "0", "--keep-recent", "0"], None),
    "no_store": (["store", "stat"], "missing"),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_store_equals_jax(tmp_path, capsys, case):
    argv, setup = CLI_CASES[case]
    results = []
    for main in (jax_cli.main, cli.main):
        shutil.rmtree(tmp_path / "home", ignore_errors=True)
        home, s = _grown_home(tmp_path)
        if setup == "damage":
            e = s.entry(3)
            with open(e.path, "r+b") as f:
                f.seek(e.page_offset(1) + store.RECORD_HEADER_SIZE + 7)
                f.write(b"\x00\x01\x02")
            (home / "store" / "9.ctps").write_bytes(b"garbage")
        elif setup == "missing":
            shutil.rmtree(home / "store")
        results.append(run_cli(main, ["--home", str(home), *argv], capsys))
    theirs, ours = results
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    if ours[1]:
        doc = json.loads(ours[1])
        assert doc["cmd"] == argv[1]
    want = {"stat": 0, "verify_clean": 0, "verify_damaged": 1, "stat_damaged": 0,
            "compact_no_budget": 2, "compact_over_budget": 1, "compact_fits": 0, "no_store": 1}
    assert ours[0] == want[case]


def test_cli_takes_home_after_the_command(tmp_path, capsys):
    home, _s = _grown_home(tmp_path)
    before = run_cli(cli.main, ["--home", str(home), "store", "verify"], capsys)
    after = run_cli(cli.main, ["store", "verify", "--home", str(home)], capsys)
    assert after == before and after[0] == 0
    assert json.loads(after[1])["heights"] == 4


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    home, _s = _grown_home(tmp_path)
    out = subprocess.run([sys.executable, "-m", "celestia_tpu_torch.cli", "store", "stat",
                          "--home", str(home)], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["heights"] == 4


def test_store_logs_like_jax(tmp_path):
    """The port's structured logger writes the JAX logger's JSON lines: the
    same level, module, message and fields for the same store events."""
    import io
    import logging

    from celestia_tpu import log as jax_log
    from celestia_tpu_torch import log

    streams = {"jax": io.StringIO(), "port": io.StringIO()}
    jax_log.configure("info", streams["jax"])
    log.configure("info", streams["port"])
    try:
        tw = Twin(tmp_path)
        tw.put(1)
        tw.both(lambda root: (root / "7.ctps").write_bytes(b"garbage"))
        tw.fresh()
    finally:
        for root in ("celestia_tpu", "celestia_tpu_torch"):
            lg = logging.getLogger(root)
            lg.handlers.clear()
            lg.addHandler(logging.NullHandler())
            lg.setLevel(logging.NOTSET)
            lg.propagate = True
    lines = {}
    for name, stream in streams.items():
        docs = [json.loads(line) for line in stream.getvalue().splitlines()]
        for d in docs:
            d.pop("ts")
            d.pop("root", None)
        lines[name] = docs
    assert lines["port"] == lines["jax"]
    assert [d["msg"] for d in lines["port"]] == ["store re-index skipped file", "store re-indexed"]
    assert lines["port"][0] == {"level": "warning", "module": "store",
                                "msg": "store re-index skipped file", "file": "7.ctps",
                                "reason": "bad_header"}
