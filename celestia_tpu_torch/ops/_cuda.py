"""Build, load and count the port's CUDA kernels.

The sources in ``celestia_tpu_torch/csrc/`` are compiled with nvcc for
``sm_90a`` into one shared library with a plain C interface, bound with
ctypes. The build happens at first use (never at import: a host without
nvcc must still import every module), one nvcc per ``.cu`` file, all
started together, into ``celestia_tpu_torch/_build/<source hash>/``.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0. There is no
fallback: a build or launch failure is an error.

``LAUNCHES`` counts kernel launches by wrapper name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.
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

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("sha256.cuh", "rs_hash.cu", "sha256_words.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libcelestia_kernels.so"

LAUNCHES: dict[str, int] = {
    "encode2d_hash": 0, "leaf_digests2d": 0, "sha256_words": 0,
}

_V = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every int as c_int
_SIGNATURES = {
    # (x, m2_packed, parity, digests, k, n, device, stream)
    "celestia_encode2d_hash": (_V, _V, _V, _V, _I, _I, _I, _V),
    # (x, ns_pad, digests, rows, n, device, stream)
    "celestia_leaf_digests2d": (_V, _V, _V, _I, _I, _I, _V),
    # (words, out, n_blocks, batch, device, stream)
    "celestia_sha256_words": (_V, _V, _I, _I, _I, _V),
}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of celestia_tpu_torch cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: pathlib.Path) -> None:
    """Compile every .cu in parallel, then link the shared library; the
    directory appears only once the library is complete."""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    objs, procs = [], []
    for name in SOURCES:
        if not name.endswith(".cu"):
            continue
        obj = tmp / (name[:-3] + ".o")
        log = open(tmp / (name[:-3] + ".log"), "w")
        procs.append((name, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
        objs.append(str(obj))
    failed = []
    for name, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
    if failed:
        logs = "\n".join((tmp / (n[:-3] + ".log")).read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", str(tmp / LIB_NAME)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)


def build_log() -> str:
    """The ptxas report (registers, shared memory, spills) of the build."""
    d = BUILD_ROOT / _source_hash()
    return "".join(p.read_text() for p in sorted(d.glob("*.log")))


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and cached by source hash."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _source_hash()
        if not (out_dir / LIB_NAME).exists():
            _build(out_dir)
        lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...], device: torch.device) -> None:
    """The wrapper-side checks every kernel input passes before its
    pointer is handed to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
