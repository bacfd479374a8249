"""Powercut explorer: exhaustive crash-point replay over the durable tier
(port of the JAX package's store/powercut.py).

The durability promise of the ``.ctps`` store (``specs/store.md``,
"Durability contract") can only be tested against *power loss*, not clean
kills: a killed process still leaves the kernel to flush the page cache, so
a crash test that merely kills the process assumes an fsync discipline it
never checks. This module checks it.

How it works:

    1. RECORD: a ``RecordingFs`` is swapped onto a real ``BlockStore`` (the
       ``FsShim`` interposition point, store/__init__.py), so a scripted
       put/compact/reindex workload produces the ordered EFFECT TRACE of
       every syscall-boundary operation: file opens, data writes (with
       their bytes), fsyncs, renames, dirsyncs, unlinks, and an ``ack``
       marker at each point the store RETURNED from a put (the moment the
       caller believes the height durable).

    2. SIMULATE: for every prefix of the trace ("the power failed right
       after effect i") a simulated page cache computes what the disk may
       hold:

         * data bytes not fsynced are VOLATILE: a file's durable content
           is its content as of its last fsync;
         * directory metadata (create/rename/unlink) is volatile until a
           ``dirsync`` of the parent: a rename not dirsynced can revert;
         * the kernel may also have flushed on its own, so the "everything
           issued landed" state is possible too, as is a torn final write.

       Three deterministic corner variants a cut bound that space:
       ``lost`` (only synced state survives), ``applied`` (everything
       issued survives), ``torn`` (everything applied but the final write
       half-landed).

    3. REPLAY: each crash state is written into a fresh directory, adopted
       with ``BlockStore.reindex(deep=True)``, and held to the recovery
       invariants:

         (a) every height acknowledged durable at or before the cut (and
             not evicted since) recovers BYTE-IDENTICAL;
         (b) heights not acknowledged recover absent or quarantined, never
             half-indexed;
         (c) recovery never serves torn bytes: every indexed height must
             fully serve (DAH, levels, every page);
         (d) ``compact`` never loses a retained height at any crash point
             (a height leaves the must-recover set only once its unlink
             was issued).

Without the parent-directory fsync after ``os.replace``, the ``lost``
variant of any cut at or after a put's ack reverts the rename, and the
explorer reports ``missing_height``. ``no_dirsync=True`` re-creates that
world (the shim swallows dirsyncs), so a test can prove the harness still
catches the fault it was built to find.

The workload persists synthetic share bytes and a synthetic DAH document:
nothing here touches the card or the proof stack.
"""

from __future__ import annotations

import dataclasses
import pathlib
import shutil
import tempfile

from celestia_tpu_torch.log import logger
from celestia_tpu_torch.store import SUFFIX, BlockStore, FsShim

log = logger("powercut")

VARIANTS = ("lost", "applied", "torn")


@dataclasses.dataclass(frozen=True)
class Effect:
    """One recorded syscall-boundary effect (paths are basenames —
    the store is a flat directory)."""

    kind: str               # open|write|fsync|rename|dirsync|unlink|ack
    path: str | None = None
    data: bytes | None = None     # write payload
    src: str | None = None        # rename source
    dst: str | None = None        # rename destination
    ack: tuple | None = None      # ("put", height, expected_bytes)


class _RecFile:
    """File wrapper recording every write's bytes into the trace."""

    def __init__(self, rec: "RecordingFs", path: pathlib.Path):
        self._rec = rec
        self._path = path
        self._f = open(path, "wb")
        rec._append(Effect(kind="open", path=path.name))

    def write(self, data) -> int:
        self._rec._append(Effect(kind="write", path=self._path.name,
                                 data=bytes(data)))
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def fileno(self) -> int:
        return self._f.fileno()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RecordingFs(FsShim):
    """FsShim that performs the real operation AND records it.

    ``no_dirsync=True`` swallows dirsyncs entirely — the pre-fix write
    path, kept as a harness self-test (the explorer MUST flag it)."""

    def __init__(self, *, no_dirsync: bool = False):
        self.trace: list[Effect] = []
        self.no_dirsync = no_dirsync

    def _append(self, eff: Effect) -> None:
        self.trace.append(eff)

    def open_w(self, path, **ctx):
        return _RecFile(self, pathlib.Path(path))

    def fsync(self, f, *, path, **ctx) -> None:
        FsShim.fsync(self, f, path=path, **ctx)
        self._append(Effect(kind="fsync", path=pathlib.Path(path).name))

    def replace(self, src, dst, **ctx) -> None:
        FsShim.replace(self, src, dst, **ctx)
        self._append(Effect(kind="rename", src=pathlib.Path(src).name,
                            dst=pathlib.Path(dst).name))

    def dirsync(self, dirpath, **ctx) -> None:
        if self.no_dirsync:
            return  # the reverted bug: rename durability never lands
        FsShim.dirsync(self, dirpath, **ctx)
        self._append(Effect(kind="dirsync", path="."))

    def unlink(self, path, *, missing_ok: bool = True, **ctx) -> None:
        FsShim.unlink(self, path, missing_ok=missing_ok, **ctx)
        self._append(Effect(kind="unlink", path=pathlib.Path(path).name))

    def ack_put(self, height: int, final_path: pathlib.Path) -> None:
        """Mark the put-returned point: from here on the caller is
        entitled to byte-identical recovery of ``final_path``."""
        self._append(Effect(kind="ack",
                            ack=("put", height, final_path.read_bytes())))


# ---------------------------------------------------------------------- #
# the simulated page cache


class _Inode:
    __slots__ = ("cache", "synced")

    def __init__(self):
        self.cache = bytearray()   # content as issued (page-cache view)
        self.synced: bytes | None = None  # content as of last fsync


def materialize(trace: list[Effect], cut: int, variant: str) -> dict:
    """The modeled on-disk byte state after a power cut right after
    ``trace[:cut]`` under one corner ``variant`` — a mapping of
    basename -> bytes."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    prefix = trace[:cut]
    if variant == "torn":
        # the final issued write half-landed — but ONLY if no later
        # fsync of that file is in the prefix (a returned fsync
        # guarantees the bytes; tearing them would model a broken
        # kernel, not a power cut)
        for i in range(len(prefix) - 1, -1, -1):
            if prefix[i].kind == "write" and prefix[i].data:
                e = prefix[i]
                synced_after = any(
                    later.kind == "fsync" and later.path == e.path
                    for later in prefix[i + 1:])
                if not synced_after:
                    prefix = list(prefix)
                    prefix[i] = dataclasses.replace(
                        e, data=e.data[: len(e.data) // 2])
                break

    cache_dir: dict[str, _Inode] = {}   # the in-flight view
    durable_dir: dict[str, _Inode] = {}  # metadata as of last dirsync
    pending: list[tuple] = []            # metadata ops awaiting dirsync

    for e in prefix:
        if e.kind == "open":
            ino = _Inode()
            cache_dir[e.path] = ino
            pending.append(("create", e.path, ino))
        elif e.kind == "write":
            ino = cache_dir.get(e.path)
            if ino is not None:
                ino.cache += e.data
        elif e.kind == "fsync":
            ino = cache_dir.get(e.path)
            if ino is not None:
                ino.synced = bytes(ino.cache)
        elif e.kind == "rename":
            ino = cache_dir.pop(e.src, None)
            if ino is not None:
                cache_dir[e.dst] = ino
            pending.append(("rename", e.src, e.dst))
        elif e.kind == "unlink":
            cache_dir.pop(e.path, None)
            pending.append(("unlink", e.path, None))
        elif e.kind == "dirsync":
            for op in pending:
                if op[0] == "create":
                    durable_dir[op[1]] = op[2]
                elif op[0] == "rename":
                    ino = durable_dir.pop(op[1], None)
                    if ino is not None:
                        durable_dir[op[2]] = ino
                elif op[0] == "unlink":
                    durable_dir.pop(op[1], None)
            pending = []

    if variant == "lost":
        # only explicitly synced state: durable dir entries, synced data
        return {name: (ino.synced if ino.synced is not None else b"")
                for name, ino in durable_dir.items()}
    # applied / torn: everything issued landed opportunistically
    return {name: bytes(ino.cache) for name, ino in cache_dir.items()}


# ---------------------------------------------------------------------- #
# the explorer


@dataclasses.dataclass(frozen=True)
class Violation:
    cut: int
    variant: str
    kind: str     # recovery_crash|missing_height|byte_mismatch|torn_serve
    height: int | None
    detail: str


@dataclasses.dataclass
class ExploreReport:
    effects: int = 0
    cuts: int = 0
    states: int = 0
    violations: list[Violation] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _synthetic_eds(k: int, height: int, share_size: int = 64):
    import numpy as np

    rng = np.random.default_rng(1000 + height)
    return rng.integers(0, 256, size=(2 * k, 2 * k, share_size),
                        dtype=np.uint8)


def _synthetic_dah(height: int, k: int) -> dict:
    return {"height": height,
            "row_roots": [f"{height:04x}{i:04x}" for i in range(2 * k)],
            "col_roots": [f"{height:04x}{i:04x}ff" for i in range(2 * k)]}


def default_workload(store: BlockStore, rec: RecordingFs, *,
                     k: int = 2, heights: int = 4,
                     compact_keep: int = 1) -> None:
    """The canonical put/compact/re-put/reindex sequence the explorer
    sweeps: enough shape to cover every effect kind while keeping the
    trace (and so the cut count) small."""
    import numpy as np

    for h in range(1, heights + 1):
        levels = ([np.full((1, 2, 90), h, dtype=np.uint8)]
                  if h == 1 else None)
        store.put_eds(h, _synthetic_eds(k, h), k,
                      dah_doc=_synthetic_dah(h, k), levels=levels)
        rec.ack_put(h, store.root / f"{h}{SUFFIX}")
    # evict the cold tail (budget 0 forces every unprotected height out)
    store.compact(0, keep_recent=compact_keep)
    # re-put the newest height with IDENTICAL content (the deterministic
    # chain re-persists the same bytes): exercises rename-over-existing
    h = heights
    store.put_eds(h, _synthetic_eds(k, h), k,
                  dah_doc=_synthetic_dah(h, k))
    rec.ack_put(h, store.root / f"{h}{SUFFIX}")
    store.reindex(deep=True)


def _expected_world(trace: list[Effect], cut: int) -> dict[int, bytes]:
    """Heights that MUST fully recover at this cut: acknowledged at-or-
    before it, minus any whose final-file unlink was already issued
    (eviction in flight — absence is then legitimate)."""
    world: dict[int, bytes] = {}
    for e in trace[:cut]:
        if e.kind == "ack" and e.ack[0] == "put":
            world[e.ack[1]] = e.ack[2]
        elif e.kind == "unlink" and e.path.endswith(SUFFIX):
            try:
                world.pop(int(e.path[: -len(SUFFIX)]), None)
            except ValueError:
                pass
    return world


def _check_state(root: pathlib.Path, state: dict,
                 expected: dict[int, bytes], cut: int,
                 variant: str) -> list[Violation]:
    """Materialize one crash state, re-adopt it, gate the invariants."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for name, data in state.items():
        (root / name).write_bytes(data)
    out: list[Violation] = []
    store = BlockStore(root, durable=False)
    try:
        store.reindex(deep=True)
    except Exception as e:  # noqa: BLE001 — any crash IS the finding
        return [Violation(cut, variant, "recovery_crash", None,
                          f"reindex raised {type(e).__name__}: {e}")]
    indexed = set(store.heights())
    for h, want in sorted(expected.items()):
        if h not in indexed:
            out.append(Violation(
                cut, variant, "missing_height", h,
                f"acknowledged-durable height {h} absent after "
                f"recovery (cut={cut}, variant={variant})"))
            continue
        got = (root / f"{h}{SUFFIX}").read_bytes()
        if got != want:
            out.append(Violation(
                cut, variant, "byte_mismatch", h,
                f"height {h} recovered {len(got)}B != acknowledged "
                f"{len(want)}B"))
    # (b)+(c): whatever reindex adopted — acked or not — must FULLY
    # serve; a half-indexed or torn height is the failure mode
    for h in sorted(indexed):
        entry = store.entry(h)
        try:
            store.read_dah(h)
            store.read_levels(h)
            for i in range(entry.page_count):
                store.read_page(h, i)
        except Exception as e:  # noqa: BLE001
            out.append(Violation(
                cut, variant, "torn_serve", h,
                f"indexed height {h} failed to serve after recovery: "
                f"{type(e).__name__}: {e}"))
    return out


def explore(*, k: int = 2, heights: int = 4, no_dirsync: bool = False,
            variants: tuple[str, ...] = VARIANTS,
            workload=None, max_violations: int = 32) -> ExploreReport:
    """Record one workload's effect trace, then replay a power cut at
    every prefix under every page-cache variant. Returns the report;
    ``report.ok`` is the gate."""
    report = ExploreReport()
    with tempfile.TemporaryDirectory(prefix="powercut-") as td:
        live = pathlib.Path(td) / "live"
        crash = pathlib.Path(td) / "crash"
        rec = RecordingFs(no_dirsync=no_dirsync)
        store = BlockStore(live, durable=True)
        store._fs = rec
        (workload or default_workload)(store, rec, k=k, heights=heights)
        trace = rec.trace
        report.effects = len(trace)
        for cut in range(len(trace) + 1):
            report.cuts += 1
            expected = _expected_world(trace, cut)
            for variant in variants:
                report.states += 1
                state = materialize(trace, cut, variant)
                report.violations.extend(
                    _check_state(crash, state, expected, cut, variant))
                if len(report.violations) >= max_violations:
                    log.warn("powercut explorer stopping early",
                             violations=len(report.violations))
                    return report
    return report
