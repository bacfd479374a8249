"""The port's powercut explorer (celestia_tpu_torch/store/powercut.py)
against the JAX package's.

One workload through each package's recording shim gives the same effect
trace, byte for byte: every open, write (with its bytes), fsync, rename,
dirsync, unlink and acknowledgement. The simulated page cache gives the
same crash states for every prefix and variant, and ``explore()`` gives
equal reports for the default sweep, the ``no_dirsync`` regression (the
acknowledged heights it loses) and each variant alone. The store cases of
tests/test_powercut.py's recovery properties run on the port's store over
directories the two packages damaged alike, with equal re-index reports.
"""

import os
import pathlib
import random

import pytest

from celestia_tpu.store import BlockStore as JaxBlockStore
from celestia_tpu.store import powercut as jax_powercut
from celestia_tpu_torch.store import SUFFIX, BlockStore
from celestia_tpu_torch.store import powercut

SEED = 1337


def report_of(rep) -> dict:
    return {"effects": rep.effects, "cuts": rep.cuts, "states": rep.states, "ok": rep.ok,
            "violations": [(v.cut, v.variant, v.kind, v.height) for v in rep.violations]}


def recorded(pc, store_cls, root: pathlib.Path, **kw):
    rec = pc.RecordingFs(**kw)
    s = store_cls(root, durable=True)
    s._fs = rec
    pc.default_workload(s, rec)
    return rec.trace


def effects(trace) -> list[tuple]:
    return [(e.kind, e.path, e.data, e.src, e.dst, e.ack) for e in trace]


@pytest.mark.parametrize("no_dirsync", [False, True])
def test_recorded_traces_are_identical(tmp_path, no_dirsync):
    ours = recorded(powercut, BlockStore, tmp_path / "port", no_dirsync=no_dirsync)
    theirs = recorded(jax_powercut, JaxBlockStore, tmp_path / "jax", no_dirsync=no_dirsync)
    assert effects(ours) == effects(theirs)
    kinds = {e.kind for e in ours}
    want = {"open", "write", "fsync", "rename", "unlink", "ack"}
    assert kinds == (want if no_dirsync else want | {"dirsync"})


@pytest.mark.parametrize("variant", powercut.VARIANTS)
def test_materialize_equals_jax_at_every_cut(tmp_path, variant):
    trace = recorded(powercut, BlockStore, tmp_path / "port")
    jtrace = recorded(jax_powercut, JaxBlockStore, tmp_path / "jax")
    for cut in range(len(trace) + 1):
        assert powercut.materialize(trace, cut, variant) == \
            jax_powercut.materialize(jtrace, cut, variant), cut


@pytest.mark.parametrize("kw", [{}, {"no_dirsync": True}, {"variants": ("torn",)},
                                {"variants": ("lost",), "no_dirsync": True},
                                {"k": 4, "heights": 3}],
                         ids=["default", "no_dirsync", "torn", "lost_no_dirsync", "k4"])
def test_explore_reports_equal_jax(kw):
    ours = powercut.explore(**kw)
    theirs = jax_powercut.explore(**kw)
    assert report_of(ours) == report_of(theirs)
    assert [v.detail for v in ours.violations] == [v.detail for v in theirs.violations]
    if kw.get("no_dirsync"):
        assert not ours.ok
        assert any(v.kind == "missing_height" and v.variant == "lost" for v in ours.violations)
    else:
        assert ours.ok and ours.effects > 0 and ours.states > ours.effects


def test_materialize_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        powercut.materialize([], 0, "half")


def test_unfsynced_write_is_volatile_in_the_model():
    trace = [powercut.Effect(kind="open", path="a"),
             powercut.Effect(kind="write", path="a", data=b"hello")]
    assert powercut.materialize(trace, 2, "lost") == {}
    trace += [powercut.Effect(kind="fsync", path="a"),
              powercut.Effect(kind="rename", src="a", dst="b")]
    assert powercut.materialize(trace, 4, "lost") == {}
    trace += [powercut.Effect(kind="dirsync", path=".")]
    assert powercut.materialize(trace, 5, "lost") == {"b": b"hello"}
    assert powercut.materialize(trace, 5, "applied") == {"b": b"hello"}


def test_torn_variant_never_tears_fsynced_writes():
    trace = [powercut.Effect(kind="open", path="a"),
             powercut.Effect(kind="write", path="a", data=b"abcdefgh"),
             powercut.Effect(kind="fsync", path="a")]
    assert powercut.materialize(trace, 3, "torn") == {"a": b"abcdefgh"}
    assert powercut.materialize(trace, 2, "torn") == {"a": b"abcd"}


def test_deeper_compact_workload_sweeps_clean_like_jax():
    def workload(pc):
        def run(store, rec, *, k=2, heights=5):
            for h in range(1, heights + 1):
                store.put_eds(h, pc._synthetic_eds(k, h), k, dah_doc=pc._synthetic_dah(h, k))
                rec.ack_put(h, store.root / f"{h}{SUFFIX}")
            store.compact(0, keep_recent=2)
            store.put_eds(heights + 1, pc._synthetic_eds(k, heights + 1), k,
                          dah_doc=pc._synthetic_dah(heights + 1, k))
            rec.ack_put(heights + 1, store.root / f"{heights + 1}{SUFFIX}")
            store.compact(0, keep_recent=1)
            store.reindex(deep=True)
        return run

    ours = powercut.explore(heights=5, workload=workload(powercut))
    theirs = jax_powercut.explore(heights=5, workload=workload(jax_powercut))
    assert report_of(ours) == report_of(theirs)
    assert ours.ok and ours.effects > 40


# ---------------------------------------------------------------------- #
# single-fault recovery as a property, the same damage in both packages


HEIGHTS = 12


@pytest.fixture()
def grown(tmp_path):
    roots = {}
    for name, cls, pc in (("port", BlockStore, powercut), ("jax", JaxBlockStore, jax_powercut)):
        s = cls(tmp_path / name)
        for h in range(1, HEIGHTS + 1):
            s.put_eds(h, pc._synthetic_eds(2, h), 2, dah_doc=pc._synthetic_dah(h, 2))
        roots[name] = tmp_path / name
    return roots


def recovers(roots) -> tuple[dict, BlockStore]:
    """Both directories re-adopted: equal reports, and every height the
    port's store indexes fully serves."""
    ours = BlockStore(roots["port"], durable=False)
    report = ours.reindex(deep=True)
    assert report == JaxBlockStore(roots["jax"], durable=False).reindex(deep=True)
    for h in ours.heights():
        entry = ours.entry(h)
        ours.read_dah(h)
        for i in range(entry.page_count):
            ours.read_page(h, i)
    return report, ours


def test_any_single_deletion_recovers(grown):
    for name in sorted(p.name for p in grown["port"].glob(f"*{SUFFIX}")):
        saved = {k: (r / name).read_bytes() for k, r in grown.items()}
        for r in grown.values():
            (r / name).unlink()
        _report, s = recovers(grown)
        assert len(s.heights()) == HEIGHTS - 1
        for k, r in grown.items():
            (r / name).write_bytes(saved[k])


def test_any_single_truncation_recovers(grown):
    rng = random.Random(SEED)
    names = sorted(p.name for p in grown["port"].glob(f"*{SUFFIX}"))
    for name in rng.sample(names, 4):
        saved = {k: (r / name).read_bytes() for k, r in grown.items()}
        for frac in (0.0, 0.1, 0.5, 0.999):
            for k, r in grown.items():
                (r / name).write_bytes(saved[k][: int(len(saved[k]) * frac)])
            _report, s = recovers(grown)
            assert len(s.heights()) >= HEIGHTS - 1
        for k, r in grown.items():
            (r / name).write_bytes(saved[k])
    _report, s = recovers(grown)
    assert len(s.heights()) == HEIGHTS


def test_garbage_prefix_is_skipped_not_crashed(grown):
    junk = random.Random(SEED).randbytes(512)
    victim = sorted(p.name for p in grown["port"].glob(f"*{SUFFIX}"))[0]
    for r in grown.values():
        (r / victim).write_bytes(junk)
    report, s = recovers(grown)
    assert len(s.heights()) == HEIGHTS - 1 and report["skipped"] == {"bad_header": 1}


def test_the_explorer_leaves_nothing_behind(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    powercut.explore(heights=2)
    assert not os.listdir(tmp_path)
