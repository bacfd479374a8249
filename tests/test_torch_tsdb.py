"""The port's longitudinal recorder (``celestia_tpu_torch/tools/tsdb.py``)
against the JAX package's, on the CPU.

The same expositions parse to the same samples; the same appends write
byte-identical ``.ctts`` files (the counter-reset rebasing and the budget's
downsampling rewrite included), and each package reads the other's file to
equal recordings. A torn tail is tolerated and a flipped byte refused by both.
``theil_sen``, ``drift_verdict``, ``analyze_drift``, the windowed quantiles,
``histogram_at`` and ``capture_at`` give equal values (floats compared exactly:
the two are the same arithmetic on the same inputs). ``RegistryScraper``
publishes the port's device ledger; its tests run over a ledger whose owners
the test sets and restores (``ledger`` fixture), so an owner another test left
registered cannot leak into their series, and one case registers a stray
owner first and finds it recorded.
"""

import math
import os

import pytest

from celestia_tpu.telemetry import Registry as JRegistry
from celestia_tpu.tools import tsdb as jtsdb
from celestia_tpu_torch import devledger, integrity
from celestia_tpu_torch.slo import SloEngine as PSloEngine
from celestia_tpu_torch.telemetry import Registry as PRegistry
from celestia_tpu_torch.tools import tsdb as ptsdb


def _text(registry_cls, step: int = 0) -> str:
    reg = registry_cls()
    reg.incr_counter("requests_total", 3.0 + step)
    reg.incr_counter("requests_total", 2.0, route="/sample", code="200")
    reg.set_gauge("rss_bytes", 123456.0 - step)
    reg.set_gauge("queue_depth", 7.0, shard='we"ird\nname\\x')
    reg.observe("serve", 0.004, exemplar="trace-abc")
    reg.observe("serve", 0.250 * (step + 1), route="/dah")
    return reg.prometheus_text()


def test_the_exposition_parses_like_jax():
    text = _text(PRegistry)
    assert text == _text(JRegistry)
    assert ptsdb.parse_exposition(text) == jtsdb.parse_exposition(text)
    extra = text + "# EXEMPLAR x\nbad line\nname{unterminated=\"x 1\n"
    assert ptsdb.parse_exposition(extra) == jtsdb.parse_exposition(extra)


@pytest.mark.parametrize("labels", [{}, {"a": "b"}, {"owner": 'quo"te'},
                                    {"owner": "back\\slash", "z": "1"},
                                    {"owner": "new\nline"}, {"le": "+Inf", "route": "/x"}])
def test_series_keys_round_trip_like_jax(labels):
    key = ptsdb.series_key("device_ledger_bytes", labels)
    assert key == jtsdb.series_key("device_ledger_bytes", labels)
    assert ptsdb.split_key(key) == jtsdb.split_key(key) == ("device_ledger_bytes", labels)


def _record(mod, path, texts, budget=ptsdb.DEFAULT_BUDGET_BYTES):
    s = mod.Scraper("http://unused.invalid/metrics", str(path), budget_bytes=budget,
                    meta={"scenario": "unit"})
    for t, text in enumerate(texts, start=1):
        s.scrape_once(t=float(t), text=text)
    s.stop(final_scrape=False)
    return s


def _restarting_texts(registry_cls):
    """Scrapes of a target that restarts twice: counters fall to zero."""
    reg = registry_cls()
    out = []
    for t in range(1, 13):
        if t in (5, 9):
            reg.reset()
        reg.incr_counter("req_total", float(t))
        reg.observe("serve", 0.001 * t)
        reg.set_gauge("g", float(100 - t))
        out.append(reg.prometheus_text())
    return out


CASES = {
    "plain": lambda cls: [_text(cls, step) for step in range(6)],
    "restarts": _restarting_texts,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_same_appends_write_the_jax_bytes(tmp_path, case):
    texts = CASES[case](PRegistry)
    ps = _record(ptsdb, tmp_path / "p.ctts", texts)
    js = _record(jtsdb, tmp_path / "j.ctts", texts)
    assert (tmp_path / "p.ctts").read_bytes() == (tmp_path / "j.ctts").read_bytes()
    assert ps.reset_counts == js.reset_counts
    if case == "restarts":
        assert ps.reset_counts["req_total"] == 2


def test_the_budget_downsamples_to_the_jax_bytes(tmp_path):
    reg = PRegistry()
    texts = []
    for t in range(1, 201):
        reg.incr_counter("a_total", 1.0)
        reg.set_gauge("g", float(t))
        texts.append(reg.prometheus_text())
    _record(ptsdb, tmp_path / "p.ctts", texts, budget=6_000)
    _record(jtsdb, tmp_path / "j.ctts", texts, budget=6_000)
    data = (tmp_path / "p.ctts").read_bytes()
    assert data == (tmp_path / "j.ctts").read_bytes() and len(data) <= 6_000
    ts = [t for t, _v in ptsdb.read(str(tmp_path / "p.ctts")).series("g")]
    assert ts[-1] == 200.0 and len(ts) < 200 and ts == sorted(ts)


def _view(rec):
    return (rec.meta, rec.names, rec.types, rec.samples, rec.resets)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    texts = _restarting_texts(PRegistry)
    path = tmp_path / "x.ctts"
    _record(jtsdb if writer == "jax" else ptsdb, path, texts)
    prec, jrec = ptsdb.read(str(path)), jtsdb.read(str(path))
    assert _view(prec) == _view(jrec)
    assert prec.series("req_total") == jrec.series("req_total")
    assert prec.series("req_total")[-1][1] == sum(range(1, 13))  # rebased, monotone
    assert (prec.t0, prec.t1) == (1.0, 12.0)


def test_a_torn_tail_is_tolerated_by_both(tmp_path):
    path = tmp_path / "t.ctts"
    _record(ptsdb, path, [_text(PRegistry, s) for s in range(4)])
    path.write_bytes(path.read_bytes()[:-7])
    prec, jrec = ptsdb.read(str(path)), jtsdb.read(str(path))
    assert _view(prec) == _view(jrec) and len(prec.samples) == 3


@pytest.mark.parametrize("where", ["header", "frame_header", "payload", "last_byte"])
def test_a_flipped_byte_is_refused_by_both(tmp_path, where):
    path = tmp_path / "c.ctts"
    _record(ptsdb, path, [_text(PRegistry, s) for s in range(3)])
    blob = bytearray(path.read_bytes())
    at = {"header": 2, "frame_header": ptsdb._HEADER.size + 1,
          "payload": ptsdb._HEADER.size + ptsdb._FRAME.size + 3, "last_byte": len(blob) - 1}[where]
    blob[at] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(integrity.IntegrityError):
        ptsdb.read(str(path))
    with pytest.raises(jtsdb.IntegrityError):
        jtsdb.read(str(path))


def _ramp(n, slope, base=100.0, noise=None):
    return [(float(i), base + slope * i + (noise[i % len(noise)] if noise else 0.0))
            for i in range(n)]


SERIES = {
    "outlier": [(float(i), 10_000.0 if i == 15 else 100.0 + i) for i in range(30)],
    "leak": _ramp(40, 5.0),
    "flat": _ramp(40, 0.0, noise=[0.5, -0.5, 0.1]),
    "sawtooth": [(float(i), 100.0 + (i % 10) * 20.0) for i in range(60)],
    "plateau": [(float(i), 10.0 * i) for i in range(10)] + [(float(i), 100.0)
                                                            for i in range(10, 60)],
    "few": _ramp(4, 5.0),
    "long": _ramp(300, 0.3, noise=[3.0, -2.0, 0.5, -1.5]),
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_theil_sen_and_the_drift_verdict_equal_jax(name):
    pts = SERIES[name]
    assert ptsdb.theil_sen(pts) == jtsdb.theil_sen(pts)
    if pts:
        assert ptsdb.drift_verdict(pts) == jtsdb.drift_verdict(pts)
        assert ptsdb.drift_verdict(pts, rel_growth=0.01, increase_frac=0.3) == \
            jtsdb.drift_verdict(pts, rel_growth=0.01, increase_frac=0.3)


def test_the_verdicts_read_the_series_as_jax_does():
    assert ptsdb.drift_verdict(SERIES["leak"])["drifting"] is True
    for name in ("flat", "sawtooth", "plateau", "few"):
        assert ptsdb.drift_verdict(SERIES[name])["drifting"] is False
    assert abs(ptsdb.theil_sen(SERIES["outlier"]) - 1.0) < 0.05


def _latency_texts(registry_cls):
    reg = registry_cls()
    out = []
    for t in range(1, 21):
        reg.set_gauge("leak_bytes", float(t) * 1000.0)
        for _ in range(10):
            reg.observe("serve", 0.001 * t)
        reg.incr_counter("probe_sample_total", 10.0)
        reg.incr_counter("probe_sample_verified_total", 10.0 if t != 7 else 9.0)
        out.append(reg.prometheus_text())
    return out


def test_the_queries_equal_jax(tmp_path):
    path = tmp_path / "q.ctts"
    _record(ptsdb, path, _latency_texts(PRegistry))
    prec, jrec = ptsdb.read(str(path)), jtsdb.read(str(path))
    specs = ("leak_bytes", "no_such_series", "serve:p99", "serve:pxx", "serve:p50")
    assert ptsdb.analyze_drift(prec, specs) == jtsdb.analyze_drift(jrec, specs)
    for q in (0.5, 0.99):
        assert ptsdb.windowed_quantile_series(prec, "serve", q) == \
            jtsdb.windowed_quantile_series(jrec, "serve", q)
    for t in (1.0, 7.5, 20.0):
        assert prec.histogram_at("serve", t) == jrec.histogram_at("serve", t)
        assert prec.value_at("probe_sample_total", t) == jrec.value_at("probe_sample_total", t)
    assert prec.window("leak_bytes", 3.0, 5.0) == [(3.0, 3000.0), (4.0, 4000.0), (5.0, 5000.0)]
    assert prec.family_keys("serve_seconds_count") == jrec.family_keys("serve_seconds_count")


def test_capture_at_judges_the_recording_like_the_live_engine(tmp_path):
    reg = PRegistry()
    engine = PSloEngine(registry=reg)
    path = str(tmp_path / "s.ctts")
    s = ptsdb.Scraper("unused", path)
    reg.incr_counter("probe_sample_total", 10.0)
    reg.incr_counter("probe_sample_verified_total", 10.0)
    s.scrape_once(t=1.0, text=reg.prometheus_text())
    cap0_live = engine.capture()
    reg.incr_counter("probe_sample_total", 90.0)
    reg.incr_counter("probe_sample_verified_total", 90.0)
    for _ in range(50):
        reg.observe("extend_block", 0.002)
    s.scrape_once(t=2.0, text=reg.prometheus_text())
    cap1_live = engine.capture()
    s.stop(final_scrape=False)
    rec = ptsdb.read(path)
    recorded = engine.evaluate_at((rec.capture_at(engine.objectives, rec.t0),
                                   rec.capture_at(engine.objectives, rec.t1)))
    live = engine.evaluate_at((cap0_live, cap1_live))
    assert recorded["ok"] == live["ok"]
    assert [o["ok"] for o in recorded["objectives"]] == [o["ok"] for o in live["objectives"]]
    jrec = jtsdb.read(path)
    assert rec.capture_at(engine.objectives, 2.0) == jrec.capture_at(engine.objectives, 2.0)
    cells, total, count, bounds = rec.histogram_at("extend_block", 2.0)
    assert count == 50 and sum(cells) == 50 and math.isclose(total, 0.1, rel_tol=1e-9)


@pytest.fixture()
def ledger():
    """The process-wide device ledger with no owners but those the test
    registers; the owners it had are restored after the test."""
    led = devledger.ledger
    with led._lock:
        saved, led._owners = led._owners, []
    try:
        yield led
    finally:
        with led._lock:
            led._owners = saved


NASTY = ("plain", 'quo"te', "back\\slash", "new\nline", 'all\\three\n"at once')


def _family(rec):
    return [k for k in rec.names if k.split("{", 1)[0] == "device_ledger_bytes"]


def test_an_owner_labeled_family_round_trips_to_disk(tmp_path, ledger):
    reg = PRegistry()
    path = str(tmp_path / "o.ctts")
    s = ptsdb.RegistryScraper(reg, path)
    for t in range(1, 5):
        for i, owner in enumerate(NASTY):
            reg.set_gauge("device_ledger_bytes", t * 1000.0 + i, owner=owner)
        s.scrape_once(t=float(t))
    s.stop(final_scrape=False)
    rec = ptsdb.read(path)
    fam = _family(rec)
    assert sorted(ptsdb.split_key(k)[1]["owner"] for k in fam) == sorted(NASTY)
    for key in fam:
        i = NASTY.index(ptsdb.split_key(key)[1]["owner"])
        assert rec.series(key) == [(float(t), t * 1000.0 + i) for t in range(1, 5)]
        assert rec.types[key] == "gauge"
    # the scrape pull-publishes the port's ledger: its series are recorded
    assert len(rec.series("device_busy_ratio")) == 4
    assert rec.series("device_ledger_unattributed_bytes")
    assert _view(jtsdb.read(path)) == _view(rec)


def test_a_stray_owner_is_recorded_beside_the_family(tmp_path, ledger):
    """An owner registered before the scrape (as another test's cache would
    be) is published into the family: the recording carries it, and the
    fixture's isolation is what keeps the case above exact."""
    ledger.register_owner("stray", lambda: 4096)
    reg = PRegistry()
    path = str(tmp_path / "s.ctts")
    s = ptsdb.RegistryScraper(reg, path)
    reg.set_gauge("device_ledger_bytes", 1.0, owner="plain")
    s.scrape_once(t=1.0)
    s.stop(final_scrape=False)
    rec = ptsdb.read(path)
    owners = {ptsdb.split_key(k)[1]["owner"]: rec.series(k) for k in _family(rec)}
    assert owners == {"plain": [(1.0, 1.0)], "stray": [(1.0, 4096.0)]}
    ledger.unregister_owner("stray")


def test_the_scraper_meta_and_counters(tmp_path):
    path = str(tmp_path / "m.ctts")
    s = ptsdb.Scraper(lambda: "http://127.0.0.1:9/metrics", path, cadence_s=0.5,
                      timeout=0.2, meta={"seed": 3})
    with pytest.raises(OSError):
        s.scrape_once(t=1.0)
    s.scrape_once(t=2.0, text="x_total 1\n")
    s.stop(final_scrape=True)  # the final scrape fails quietly: target down
    rec = ptsdb.read(path)
    assert rec.meta == {"source": "<dynamic>", "cadence_s": 0.5, "seed": 3}
    assert s.scrapes == 1 and rec.series("x_total") == [(2.0, 1.0)]
    assert os.path.getsize(path) > ptsdb._HEADER.size
