"""ctypes bindings for the port's native (C++) host runtime,
``celestia_tpu_torch/csrc/host/{leopard,nmt}.cc`` (port of the JAX package's
native.py).

The App's ``native`` backend, and the backend its device path degrades to.
The library is compiled on first use with ``g++ -O3 -march=native`` from the
port's own copy of the sources, into
``celestia_tpu_torch/_build/native-<source hash>/`` (gitignored): a changed
source builds a new directory, and a directory appears only once its library
is complete, so concurrent processes never load half a build. The build is
an instrumented builder of the device ledger (entry ``native.library``,
keyed on the source hash; a library already on disk is a build-cache hit).
Callers check
``available()`` and use the plain host path (``da.extend_shares(...,
device="cpu")``) when the toolchain is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from celestia_tpu_torch import devledger
from celestia_tpu_torch.appconsts import SHARE_SIZE

_SRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc" / "host"
_SOURCES = ("leopard.cc", "nmt.cc")
_BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
_LIB_NAME = "libcelestia_native.so"
_CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_load_error: str | None = None
_lock = threading.Lock()

NMT_NODE_SIZE = 90


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _path_for(source_hash: str) -> pathlib.Path:
    return _BUILD_ROOT / f"native-{source_hash}" / _LIB_NAME


def lib_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    return _path_for(_source_hash())


def _build(out_dir: pathlib.Path) -> None:
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="native-build-", dir=_BUILD_ROOT))
    cmd = ["g++", *_CXX_FLAGS, "-o", str(tmp / _LIB_NAME),
           *(str(_SRC_DIR / name) for name in _SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


@devledger.instrument_builder("native.library")
def _library_for(source_hash: str) -> ctypes.CDLL:
    path = _path_for(source_hash)
    if path.exists():
        devledger.note_cache_hit()
    else:
        _build(path.parent)
    lib = ctypes.CDLL(str(path))
    for fn in ("leo_encode", "eds_extend", "leo_decode"):
        getattr(lib, fn).argtypes = [
            ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p]
    lib.eds_nmt_roots.argtypes = [
        ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.merkle_root.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.eds_repair.argtypes = [
        ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.eds_repair.restype = ctypes.c_int
    return lib


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            _lib = _library_for(_source_hash())
        except Exception as e:  # noqa: BLE001 — the toolchain may be absent
            _load_error = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def leo_encode(data: np.ndarray) -> np.ndarray:
    """(k, shard_size) uint8 -> (k, shard_size) parity."""
    lib = _load()
    k, size = data.shape
    if k & (k - 1):
        raise ValueError("k must be a power of two")
    out = ctypes.create_string_buffer(k * size)
    lib.leo_encode(k, size, np.ascontiguousarray(data).tobytes(), out)
    return np.frombuffer(out.raw, dtype=np.uint8).reshape(k, size).copy()


def eds_extend(q0: np.ndarray) -> np.ndarray:
    """(k, k, 512) uint8 -> (2k, 2k, 512) EDS."""
    lib = _load()
    k = q0.shape[0]
    w = 2 * k
    out = ctypes.create_string_buffer(w * w * SHARE_SIZE)
    lib.eds_extend(k, SHARE_SIZE, np.ascontiguousarray(q0).tobytes(), out)
    return np.frombuffer(out.raw, dtype=np.uint8).reshape(w, w, SHARE_SIZE).copy()


def eds_nmt_roots(eds: np.ndarray) -> tuple[list[bytes], list[bytes]]:
    """(2k, 2k, 512) EDS -> (row_roots, col_roots), 90-byte NMT roots."""
    lib = _load()
    w = eds.shape[0]
    k = w // 2
    rows = ctypes.create_string_buffer(w * NMT_NODE_SIZE)
    cols = ctypes.create_string_buffer(w * NMT_NODE_SIZE)
    lib.eds_nmt_roots(k, SHARE_SIZE, np.ascontiguousarray(eds).tobytes(), rows, cols)
    row_roots = [rows.raw[i * NMT_NODE_SIZE: (i + 1) * NMT_NODE_SIZE] for i in range(w)]
    col_roots = [cols.raw[i * NMT_NODE_SIZE: (i + 1) * NMT_NODE_SIZE] for i in range(w)]
    return row_roots, col_roots


def merkle_root(items: list[bytes]) -> bytes:
    lib = _load()
    if items:
        sizes = {len(i) for i in items}
        if len(sizes) != 1:
            raise ValueError("merkle_root requires equal-size items")
        item_size = sizes.pop()
    else:
        item_size = 0
    out = ctypes.create_string_buffer(32)
    lib.merkle_root(b"".join(items), len(items), item_size, out)
    return out.raw


def leo_decode(cells: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Single-axis Leopard erasure decode: (2k, B) cells + (2k,) bool
    presence -> repaired (2k, B)."""
    lib = _load()
    n, size = cells.shape
    k = n // 2
    if int(np.count_nonzero(present)) < k:
        raise ValueError("not enough shards to decode")
    buf = ctypes.create_string_buffer(np.ascontiguousarray(cells).tobytes(), n * size)
    lib.leo_decode(k, size, buf, np.ascontiguousarray(present, dtype=np.uint8).tobytes())
    return np.frombuffer(buf.raw, dtype=np.uint8).reshape(n, size).copy()


def eds_repair(eds: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Repair a (2k, 2k, B) EDS given a (2k, 2k) bool presence mask. Raises
    da.repair.UnrepairableError when the pattern is not decodable (the
    contract of the host and device repairs)."""
    lib = _load()
    w = eds.shape[0]
    size = eds.shape[2]
    buf = ctypes.create_string_buffer(np.ascontiguousarray(eds).tobytes(), w * w * size)
    mask = ctypes.create_string_buffer(
        np.ascontiguousarray(present, dtype=np.uint8).tobytes(), w * w)
    rc = lib.eds_repair(w // 2, size, buf, mask)
    if rc != 0:
        from celestia_tpu_torch.da.repair import UnrepairableError

        raise UnrepairableError("impossible to recover: erasure pattern not decodable")
    return np.frombuffer(buf.raw, dtype=np.uint8).reshape(w, w, size).copy()


def extend_and_root_native(shares: np.ndarray):
    """Full native ExtendBlock: (k, k, 512) -> (eds, row_roots, col_roots, dah)."""
    eds = eds_extend(shares)
    rows, cols = eds_nmt_roots(eds)
    dah = merkle_root(rows + cols)
    return eds, rows, cols, dah
