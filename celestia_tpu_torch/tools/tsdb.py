"""Longitudinal telemetry: scrape `/metrics` into a durable `.ctts`
time-series file and query it back (port of the JAX package's
tools/tsdb.py; the two packages write byte-identical files for the same
appends and read each other's).

Every observability surface before this one was point-in-time: one
`/metrics` exposition, one SLO snapshot deque, one storm samples/sec
number. This module is the third leg of the observability stack
(specs/observability.md §Longitudinal telemetry): a dependency-free
scraper polls a node/gateway/fleet's `/metrics` at a fixed cadence,
parses the Prometheus v0.0.4 text the repo renders, and appends the
samples into a CRC32C-framed `.ctts` recording — the same framing
discipline as the `.ctps` block store (ADR-021): a checksummed header,
per-frame `nbytes/crc` record headers, atomic rewrite, refusal on a
mid-file CRC mismatch, tolerance for a torn tail frame.

Three properties the format guarantees:

    counter-reset adjustment  fleet respawns restart counters at zero;
        recording the raw values would read as huge negative rates.
        Cumulative series (counters + histogram `_bucket`/`_sum`/
        `_count`) are re-based at append time: a decrease adds the
        previous raw value to a per-series offset, so the recorded
        series stays monotone and the reset itself is counted.
    fixed byte budget  tiered downsampling keeps the newest half of a
        recording at full resolution, thins the middle to every 2nd
        sample and the oldest quarter to every 4th (reset-carrying
        samples are never dropped), then drops the oldest tail —
        enforced by an atomic rewrite whenever the file would exceed
        the budget, so an hours-scale soak cannot eat the disk.
    windowed queries  the reader reconstructs per-series points,
        windowed histograms, derived quantile series, and — via
        ``Recording.capture_at`` — the exact capture dicts
        ``slo.SloEngine.evaluate_at`` judges, so an SLO verdict can be
        recomputed OFFLINE from a recording instead of live snapshots.

On top of the reader ride the robust drift detectors (Theil–Sen
slope — the median of pairwise slopes, immune to the odd outlier
sample) that judge the ``soak`` scenario: unbounded monotone growth in
RSS, resident pages, store bytes, pin counts, or a latency quantile
FAILS the run (specs/scenarios.md §soak).
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import time
import urllib.request

from celestia_tpu_torch.integrity import IntegrityError, crc32c
from celestia_tpu_torch.log import logger

log = logger("tsdb")

MAGIC = b"CTTS"
VERSION = 1

#: header: magic + version + crc32c(magic+version)
_HEADER = struct.Struct("<4sII")
#: per-frame record header, the `.ctps` discipline: payload nbytes,
#: crc32c(payload), then crc32c over those first 8 bytes — the header
#: self-check is what lets the reader tell a genuine torn tail
#: (intact header, truncated payload) from a corrupted length field
#: that merely CLAIMS to overrun the file
_FRAME = struct.Struct("<IIQ")
_FRAME_PREFIX = struct.Struct("<II")

#: a frame larger than this is corruption, not data (a recording's
#: biggest frame is one scrape of one registry — a few hundred KB)
MAX_FRAME_BYTES = 16 << 20

DEFAULT_BUDGET_BYTES = 4 << 20
DEFAULT_CADENCE_S = 0.25

#: Prometheus types whose series only ever increase within one process
#: lifetime — the reset adjuster re-bases exactly these
CUMULATIVE_TYPES = ("counter", "histogram")


# ---------------------------------------------------------------------- #
# Prometheus v0.0.4 text parsing (the renderer's exact dual)


def parse_exposition(text: str):
    """Parse one exposition into ``(samples, types)``.

    ``samples`` is a list of ``(key, family, labels, value)`` — ``key``
    is the canonical rendered-name+sorted-labels series key, ``family``
    the TYPE-line family the series belongs to (histogram ``_bucket``/
    ``_sum``/``_count`` series map back to their family), ``labels``
    the UNESCAPED label dict. ``types`` maps family -> type. `# HELP`
    and the repo's non-standard `# EXEMPLAR` comment lines are ignored,
    as any v0.0.4 scraper must."""
    samples: list[tuple[str, str, dict, float]] = []
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue  # HELP / EXEMPLAR / free comments
        parsed = _parse_sample_line(line)
        if parsed is None:
            continue
        name, labels, value = parsed
        key = series_key(name, labels)
        samples.append((key, _family_of(name, types), labels, value))
    return samples, types


def _parse_sample_line(line: str):
    """``name{k="v",...} value`` or ``name value`` -> (name, labels,
    float) with label values unescaped; None on a malformed line."""
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        name = line[:brace]
        labels, rest = _parse_labels(line, brace)
        if rest is None:
            return None
    else:
        if space == -1:
            return None
        name, rest = line[:space], line[space:]
        labels = {}
    try:
        return name, labels, float(rest.strip().split()[0])
    except (ValueError, IndexError):
        return None


def _parse_labels(line: str, brace: int):
    """Escape-aware scan of a ``{...}`` label block starting at
    ``brace``; returns (labels, remainder-after-closing-brace)."""
    labels: dict[str, str] = {}
    i = brace + 1
    n = len(line)
    while i < n:
        if line[i] == "}":
            return labels, line[i + 1:]
        if line[i] == ",":
            i += 1
            continue
        eq = line.find('="', i)
        if eq == -1:
            return labels, None
        lname = line[i:eq]
        i = eq + 2
        out: list[str] = []
        while i < n:
            ch = line[i]
            if ch == "\\" and i + 1 < n:
                nxt = line[i + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                i += 2
                continue
            if ch == '"':
                break
            out.append(ch)
            i += 1
        labels[lname] = "".join(out)
        i += 1  # past the closing quote
    return labels, None


def _family_of(name: str, types: dict[str, str]) -> str:
    if name in types:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base
    return name


def series_key(name: str, labels: dict) -> str:
    """The canonical series key — for the repo's identifier-shaped
    label values it matches telemetry.Registry._key, so a recorded
    counter is addressable by the same key the SLO objectives name
    (``probe_sample_total`` etc.). Values are exposition-escaped
    (telemetry._escape's scheme) so ``split_key`` is a true inverse
    even for values carrying backslash/quote/newline — the device
    ledger's ``owner`` label is an arbitrary registration string."""
    if not labels:
        return name
    inner = ",".join(
        '{}="{}"'.format(
            k,
            v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"))
        for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def split_key(key: str):
    """Inverse of ``series_key``: the label block is escape-aware, so
    values round-trip exactly."""
    brace = key.find("{")
    if brace == -1:
        return key, {}
    name = key[:brace]
    labels, _rest = _parse_labels(key, brace)
    return name, labels or {}


# ---------------------------------------------------------------------- #
# .ctts framing: writer


class TsdbWriter:
    """Append-only CRC32C-framed time-series file with a byte budget.

    Frames are JSON payloads behind `.ctps`-style record headers:
    a ``meta`` frame first, ``dict`` frames interning series names and
    types as they first appear, then ``sample`` frames holding
    ``{index: value}`` maps plus the indices of series that RESET at
    that scrape. Every append goes to disk immediately; exceeding the
    byte budget triggers a tiered-downsampling rewrite (atomic
    tmp+rename, like every store write in this repo)."""

    def __init__(self, path: str, *, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 meta: dict | None = None):
        self.path = path
        self.budget_bytes = int(budget_bytes)
        self.meta = dict(meta or {})
        self._names: dict[str, int] = {}
        self._types: dict[str, str] = {}
        # shadow of every live sample frame: (t, {idx: val}, resets,
        # frame_nbytes) — what the downsampling rewrite rebuilds from
        self._shadow: list[tuple[float, dict, tuple, int]] = []
        self._lock = threading.Lock()
        with self._lock:  # _write_frame is lock-guarded at every site
            self._f = open(path, "wb")
            self._f.write(_header_bytes())
            self._bytes = _HEADER.size
            self._write_frame({"k": "m", "meta": self.meta})
            self._f.flush()

    # -- framing ------------------------------------------------------- #

    def _write_frame(self, doc: dict) -> int:
        payload = json.dumps(doc, separators=(",", ":")).encode()
        prefix = _FRAME_PREFIX.pack(len(payload), crc32c(payload))
        self._f.write(prefix + struct.pack("<Q", crc32c(prefix)))
        self._f.write(payload)
        nbytes = _FRAME.size + len(payload)
        self._bytes += nbytes
        return nbytes

    def append(self, t: float, samples: dict[str, float],
               types: dict[str, str] | None = None,
               resets: tuple[str, ...] = ()) -> None:
        """Record one scrape: ``samples`` maps series key -> (already
        reset-adjusted) value; ``types`` carries family types for any
        new series; ``resets`` names series that reset at this scrape."""
        with self._lock:
            new = [k for k in samples if k not in self._names]
            if new:
                ntypes = []
                for k in new:
                    self._names[k] = len(self._names)
                    fam = _family_of(split_key(k)[0], types or {})
                    ftype = (types or {}).get(fam, "untyped")
                    self._types[k] = ftype
                    ntypes.append(ftype)
                self._write_frame({"k": "d", "names": new, "types": ntypes})
            vmap = {str(self._names[k]): v for k, v in samples.items()}
            ridx = tuple(self._names[k] for k in resets if k in self._names)
            doc: dict = {"k": "s", "t": t, "v": vmap}
            if ridx:
                doc["r"] = list(ridx)
            nbytes = self._write_frame(doc)
            self._f.flush()
            self._shadow.append((t, vmap, ridx, nbytes))
            if self._bytes > self.budget_bytes:
                self._compact_locked()

    # -- tiered downsampling ------------------------------------------- #

    def _compact_locked(self) -> None:
        """Thin the shadow by age tier and atomically rewrite the file:
        newest half full-resolution, next quarter every 2nd sample,
        oldest quarter every 4th; reset-carrying samples survive every
        tier; still over budget -> drop the oldest non-reset samples."""
        n = len(self._shadow)
        keep: list[tuple[float, dict, tuple, int]] = []
        for i, entry in enumerate(self._shadow):
            if entry[2]:  # a reset marker is history we must not lose
                keep.append(entry)
                continue
            if i >= n // 2:
                keep.append(entry)
            elif i >= n // 4:
                if i % 2 == 0:
                    keep.append(entry)
            elif i % 4 == 0:
                keep.append(entry)
        # frame sizes are known exactly — trim the oldest until the
        # rewrite is comfortably under budget
        fixed = _HEADER.size + 512  # header + meta/dict slack
        dict_bytes = sum(len(k) + 16 for k in self._names)
        while keep and (fixed + dict_bytes
                        + sum(e[3] for e in keep)) > 0.9 * self.budget_bytes:
            for i, e in enumerate(keep):
                if not e[2]:
                    del keep[i]
                    break
            else:
                break  # nothing but reset markers left
        tmp = self.path + ".tmp"
        self._f.close()
        with open(tmp, "wb") as f:
            self._f = f
            self._bytes = 0
            f.write(_header_bytes())
            self._bytes = _HEADER.size
            self._write_frame({"k": "m", "meta": self.meta})
            names = sorted(self._names, key=self._names.__getitem__)
            self._write_frame({"k": "d", "names": names,
                               "types": [self._types[k] for k in names]})
            rebuilt = []
            for t, vmap, ridx, _old in keep:
                doc = {"k": "s", "t": t, "v": vmap}
                if ridx:
                    doc["r"] = list(ridx)
                nbytes = self._write_frame(doc)
                rebuilt.append((t, vmap, ridx, nbytes))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._shadow = rebuilt
        self._f = open(self.path, "ab")
        log.info("tsdb downsampled", path=self.path, kept=len(rebuilt),
                 dropped=n - len(rebuilt), bytes=self._bytes)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                self._f.close()
            except OSError:
                pass


def _header_bytes() -> bytes:
    return _HEADER.pack(MAGIC, VERSION, crc32c(MAGIC + struct.pack(
        "<I", VERSION)))


# ---------------------------------------------------------------------- #
# .ctts reader


class Recording:
    """One parsed `.ctts` recording: windowed query surface."""

    def __init__(self, meta: dict, names: list[str], types: dict[str, str],
                 samples: list[tuple[float, dict[int, float]]],
                 resets: dict[str, int]):
        self.meta = meta
        self.names = names
        self.types = types
        self.samples = samples  # [(t, {series_index: value})]
        self.resets = resets  # series key -> reset count
        self._index = {k: i for i, k in enumerate(names)}

    @property
    def t0(self) -> float:
        return self.samples[0][0] if self.samples else 0.0

    @property
    def t1(self) -> float:
        return self.samples[-1][0] if self.samples else 0.0

    def series(self, key: str) -> list[tuple[float, float]]:
        idx = self._index.get(key)
        if idx is None:
            return []
        return [(t, v[idx]) for t, v in self.samples if idx in v]

    def window(self, key: str, t0: float,
               t1: float) -> list[tuple[float, float]]:
        return [(t, v) for t, v in self.series(key) if t0 <= t <= t1]

    def value_at(self, key: str, t: float, default: float = 0.0) -> float:
        """Newest recorded value at or before ``t`` (a counter that was
        not yet seen reads as its pre-existence value, 0)."""
        out = default
        for pt, v in self.series(key):
            if pt > t:
                break
            out = v
        return out

    # -- histogram reconstruction -------------------------------------- #

    def family_keys(self, prefix: str) -> list[str]:
        return [k for k in self.names if k == prefix
                or k.startswith(prefix + "{")]

    def histogram_at(self, family: str, t: float):
        """Rebuild one histogram family at time ``t`` in the exact
        shape ``slo.SloEngine.capture`` freezes: (per-bucket counts,
        sum, count, bounds) — label sets merged bucketwise, the
        cumulative exposition buckets diffed back into cells."""
        per_le: dict[float, float] = {}
        for key in self.family_keys(f"{family}_seconds_bucket"):
            _name, labels = split_key(key)
            le = labels.get("le")
            if le is None:
                continue
            bound = math.inf if le == "+Inf" else float(le)
            per_le[bound] = per_le.get(bound, 0.0) + self.value_at(key, t)
        if not per_le:
            return None
        bounds = sorted(b for b in per_le if b != math.inf)
        cum = [per_le[b] for b in bounds]
        cum.append(per_le.get(math.inf, cum[-1] if cum else 0.0))
        cells = [cum[0]] + [cum[i] - cum[i - 1] for i in range(1, len(cum))]
        total_sum = sum(self.value_at(k, t) for k in
                        self.family_keys(f"{family}_seconds_sum"))
        total_count = sum(self.value_at(k, t) for k in
                          self.family_keys(f"{family}_seconds_count"))
        return (tuple(int(c) for c in cells), total_sum,
                int(total_count), tuple(bounds))

    def capture_at(self, objectives, t: float) -> dict:
        """An ``SloEngine.capture()``-shaped dict reconstructed from
        the recording at time ``t`` — feed a pair of these to
        ``SloEngine.evaluate_at`` to re-judge any window of a run
        OFFLINE, from durable data instead of live snapshots."""
        counters: dict[str, float] = {}
        hists: dict[str, tuple] = {}
        for o in objectives:
            if o.kind == "ratio":
                for k in (o.good, o.total):
                    counters[k] = self.value_at(k, t)
            elif o.kind == "counter_max":
                counters[o.counter] = self.value_at(o.counter, t)
            elif o.kind == "quantile":
                h = self.histogram_at(o.metric, t)
                if h is not None:
                    hists[o.metric] = h
        return {"t": t, "counters": counters, "hists": hists}


def read(path: str) -> Recording:
    """Load a `.ctts` recording. A torn TAIL frame (crash mid-append)
    is tolerated — the recording simply ends one sample early. A CRC
    mismatch on any COMPLETE frame is refused with IntegrityError:
    rotted bytes must never be analyzed as data."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HEADER.size:
        raise IntegrityError(f"{path}: truncated header")
    magic, version, hcrc = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC or hcrc != crc32c(magic + struct.pack("<I", version)):
        _count_corrupt()
        raise IntegrityError(f"{path}: bad header (magic/crc)")
    if version != VERSION:
        raise IntegrityError(f"{path}: unsupported version {version}")
    meta: dict = {}
    names: list[str] = []
    types: dict[str, str] = {}
    samples: list[tuple[float, dict[int, float]]] = []
    resets: dict[str, int] = {}
    off = _HEADER.size
    while off < len(blob):
        if off + _FRAME.size > len(blob):
            break  # torn tail: header itself is partial
        nbytes, fcrc, hdr_crc = _FRAME.unpack_from(blob, off)
        if hdr_crc != crc32c(blob[off:off + _FRAME_PREFIX.size]):
            # the header self-check failed BEFORE we trust the length:
            # a flipped length byte must not masquerade as a torn tail
            _count_corrupt()
            raise IntegrityError(f"{path}: frame at {off} failed its "
                                 "header CRC — corrupt frame header")
        if nbytes > MAX_FRAME_BYTES:
            _count_corrupt()
            raise IntegrityError(f"{path}: frame at {off} claims "
                                 f"{nbytes} bytes (corrupt header)")
        start = off + _FRAME.size
        if start + nbytes > len(blob):
            break  # torn tail: payload truncated mid-write
        payload = blob[start:start + nbytes]
        if crc32c(payload) != fcrc:
            _count_corrupt()
            raise IntegrityError(
                f"{path}: frame at {off} failed its CRC — refusing to "
                "read a corrupt recording")
        try:
            doc = json.loads(payload)
        except ValueError as e:
            _count_corrupt()
            raise IntegrityError(
                f"{path}: frame at {off} passed CRC but is not JSON "
                f"({e}) — format corruption") from None
        kind = doc.get("k")
        if kind == "m":
            meta = doc.get("meta", {})
        elif kind == "d":
            new = doc.get("names", [])
            ntypes = doc.get("types", [])
            for i, name in enumerate(new):
                names.append(name)
                if i < len(ntypes):
                    types[name] = ntypes[i]
        elif kind == "s":
            vmap = {int(i): float(v) for i, v in doc.get("v", {}).items()}
            samples.append((float(doc["t"]), vmap))
            for idx in doc.get("r", ()):
                if 0 <= idx < len(names):
                    resets[names[idx]] = resets.get(names[idx], 0) + 1
        off = start + nbytes
    return Recording(meta, names, types, samples, resets)


def _count_corrupt() -> None:
    try:
        from celestia_tpu_torch.telemetry import metrics

        metrics.incr_counter("tsdb_read_corrupt_total")
    except Exception:  # noqa: BLE001 — accounting never blocks refusal
        pass


# ---------------------------------------------------------------------- #
# the scraper: /metrics -> .ctts at a fixed absolute-clock cadence


class Scraper:
    """Poll one `/metrics` URL at a fixed cadence into a `.ctts` file.

    Cadence is scheduled on an ABSOLUTE clock (the same fix
    node/prober.py carries): a slow scrape does not stretch the
    interval, it overruns its slot — ``self.overruns`` counts those —
    and the next scrape fires at the next grid point. Counter resets
    across target restarts are adjusted at append time so fleet
    respawns never read as negative rates."""

    def __init__(self, url, path: str, *,
                 cadence_s: float = DEFAULT_CADENCE_S,
                 timeout: float = 2.0,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 clock=None, meta: dict | None = None):
        self._url = url  # str, or a callable returning the current str
        self.path = path
        self.cadence_s = float(cadence_s)
        self.timeout = timeout
        self.clock = clock if clock is not None else time.monotonic
        # meta must be complete at construction — the writer's meta
        # frame is the FIRST frame of the file, so late mutation of
        # writer.meta would never reach disk
        full_meta = {"source": url if isinstance(url, str)
                     else "<dynamic>",
                     "cadence_s": cadence_s}
        full_meta.update(meta or {})
        self.writer = TsdbWriter(path, budget_bytes=budget_bytes,
                                 meta=full_meta)
        self.overruns = 0
        self.scrapes = 0
        self.scrape_errors = 0
        self._last_raw: dict[str, float] = {}
        self._offset: dict[str, float] = {}
        self.reset_counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return self._url() if callable(self._url) else self._url

    # -- one scrape ----------------------------------------------------- #

    def fetch_text(self) -> str:
        with urllib.request.urlopen(self.url,
                                    timeout=self.timeout) as resp:
            return resp.read().decode()

    def scrape_once(self, t: float | None = None,
                    text: str | None = None) -> int:
        """Fetch + parse + reset-adjust + append one sample. ``text``
        bypasses the fetch (tests, offline ingestion). Returns the
        number of series recorded; raises on transport failure."""
        t = self.clock() if t is None else t
        if text is None:
            text = self.fetch_text()
        samples, types = parse_exposition(text)
        out: dict[str, float] = {}
        resets: list[str] = []
        for key, family, _labels, value in samples:
            if types.get(family) in CUMULATIVE_TYPES:
                last = self._last_raw.get(key)
                if last is not None and value < last - 1e-9:
                    # the target restarted: re-base so the recorded
                    # series stays monotone instead of going negative
                    self._offset[key] = self._offset.get(key, 0.0) + last
                    self.reset_counts[key] = \
                        self.reset_counts.get(key, 0) + 1
                    resets.append(key)
                self._last_raw[key] = value
                out[key] = self._offset.get(key, 0.0) + value
            else:
                out[key] = value
        self.writer.append(t, out, types=types, resets=tuple(resets))
        self.scrapes += 1
        return len(out)

    # -- thread lifecycle ------------------------------------------------ #

    def start(self) -> "Scraper":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tsdb-scraper")
        self._thread.start()
        return self

    def _run(self) -> None:
        next_slot = self.clock()
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 — target mid-restart
                self.scrape_errors += 1
                log.debug("scrape failed", url=self.url, error=str(e))
            next_slot += self.cadence_s
            now = self.clock()
            if now >= next_slot:
                self.overruns += 1
                while next_slot <= now:
                    next_slot += self.cadence_s
            self._stop.wait(max(0.0, next_slot - now))

    def stop(self, final_scrape: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 2.0)
            self._thread = None
        if final_scrape:
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — target already down
                pass
        self.writer.close()


class RegistryScraper(Scraper):
    """Scraper over an in-process telemetry Registry instead of a URL —
    the scenario engine's hook when a run carries its own isolated
    registry (tests) and the HTTP /metrics route would render the wrong
    one. Same parse/reset/append path: the registry is rendered to
    exposition text and re-parsed, so the recording exercises the exact
    wire format a remote scrape would."""

    def __init__(self, registry, path: str, **kw):
        super().__init__("registry://in-process", path, **kw)
        self._registry = registry

    def fetch_text(self) -> str:
        from celestia_tpu_torch import devledger
        from celestia_tpu_torch.telemetry import refresh_process_gauges

        refresh_process_gauges(self._registry)
        # the device runtime ledger is pull-driven like the process
        # gauges: each scrape runs one owner audit, so recordings carry
        # device_ledger_* / device_busy_ratio series for the drift judge
        devledger.publish(self._registry)
        return self._registry.prometheus_text()


# ---------------------------------------------------------------------- #
# derived series + robust drift detection


def windowed_quantile_series(rec: Recording, family: str,
                             q: float = 0.99) -> list[tuple[float, float]]:
    """Per-interval quantile of one histogram family: consecutive
    recorded states diffed bucketwise (only the observations that
    landed between two scrapes), the PromQL-style interpolated quantile
    of each diff — the latency-drift input for the soak verdict."""
    from celestia_tpu_torch.telemetry import Histogram

    points: list[tuple[float, float]] = []
    prev = None
    for t, _v in rec.samples:
        cur = rec.histogram_at(family, t)
        if cur is None:
            continue
        if prev is not None and cur[2] > prev[2]:
            diff = Histogram(list(cur[3]))
            diff.counts = [c - p for c, p in zip(cur[0], prev[0])]
            diff.sum = cur[1] - prev[1]
            diff.count = cur[2] - prev[2]
            points.append((t, diff.quantile(q)))
        prev = cur
    return points


def theil_sen(points: list[tuple[float, float]]) -> float:
    """Theil–Sen slope estimator: the MEDIAN of all pairwise slopes.
    One garbage sample (a scrape racing a restart, an allocator spike)
    moves a least-squares fit arbitrarily; it moves a median of
    O(n²) pairwise slopes not at all. Points are evenly subsampled
    above 120 samples to bound the pair count."""
    if len(points) < 2:
        return 0.0
    if len(points) > 120:
        stride = len(points) / 120.0
        points = [points[int(i * stride)] for i in range(120)]
    slopes = []
    for i in range(len(points)):
        t_i, v_i = points[i]
        for j in range(i + 1, len(points)):
            t_j, v_j = points[j]
            if t_j > t_i:
                slopes.append((v_j - v_i) / (t_j - t_i))
    if not slopes:
        return 0.0
    slopes.sort()
    n = len(slopes)
    mid = n // 2
    return slopes[mid] if n % 2 else (slopes[mid - 1] + slopes[mid]) / 2.0


#: drift rule defaults (specs/scenarios.md §soak): projected growth
#: over the analyzed window must exceed 20% of the series level AND a
#: clear majority of consecutive steps must be increases — a plateau
#: after warmup fails the second test, a sawtooth (compaction) the
#: first, an unbounded leak passes both
DRIFT_MIN_POINTS = 8
DRIFT_WARMUP_FRAC = 0.25
DRIFT_REL_GROWTH = 0.20
DRIFT_INCREASE_FRAC = 0.65


def drift_verdict(points: list[tuple[float, float]], *,
                  min_points: int = DRIFT_MIN_POINTS,
                  warmup_frac: float = DRIFT_WARMUP_FRAC,
                  rel_growth: float = DRIFT_REL_GROWTH,
                  increase_frac: float = DRIFT_INCREASE_FRAC) -> dict:
    """Judge one series for unbounded monotone growth.

    The first ``warmup_frac`` of samples is dropped (every process
    ramps: build caches fill, arenas grow to steady state). Over the
    rest: Theil–Sen slope, projected relative growth across the
    window, and the fraction of increasing consecutive steps. Drifting
    = growing AND consistently so."""
    n_raw = len(points)
    points = points[int(n_raw * warmup_frac):]
    if len(points) < min_points:
        return {"points": n_raw, "analyzed": len(points),
                "drifting": False, "note": "too few samples"}
    slope = theil_sen(points)
    span_s = points[-1][0] - points[0][0]
    values = sorted(v for _t, v in points)
    level = abs(values[len(values) // 2])
    growth = slope * span_s
    rel = growth / level if level > 1e-12 else (
        math.inf if growth > 1e-9 else 0.0)
    ups = sum(1 for (_, a), (_, b) in zip(points, points[1:]) if b > a)
    steps = max(1, len(points) - 1)
    frac = ups / steps
    drifting = bool(rel > rel_growth and frac > increase_frac
                    and slope > 0)
    return {"points": n_raw, "analyzed": len(points),
            "slope_per_s": slope, "span_s": span_s, "level": level,
            "rel_growth": rel, "increase_frac": frac,
            "drifting": drifting}


def analyze_drift(rec: Recording, specs: tuple[str, ...], **kw) -> list[dict]:
    """Drift-judge a set of series specs against one recording. A spec
    is a plain series key (``process_rss_bytes``, ``store_bytes``) or
    ``family:pNN`` for a derived windowed-quantile series
    (``probe_sample:p99``). Absent series report as not-drifting with a
    note — a CPU-only world has no paged-cache gauges to leak."""
    out = []
    for spec in specs:
        if ":p" in spec:
            family, qs = spec.rsplit(":p", 1)
            try:
                q = float(qs) / 100.0
            except ValueError:
                out.append({"series": spec, "points": 0, "drifting": False,
                            "note": f"bad quantile spec {spec!r}"})
                continue
            points = windowed_quantile_series(rec, family, q)
        else:
            points = rec.series(spec)
        if not points:
            out.append({"series": spec, "points": 0, "drifting": False,
                        "note": "series absent from recording"})
            continue
        verdict = drift_verdict(points, **kw)
        verdict["series"] = spec
        out.append(verdict)
    return out
