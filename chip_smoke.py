#!/usr/bin/env python3
"""On-card smoke test of celestia_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order (any failed check raises, so the script exits non-zero and
prints no result; it also exits non-zero when no CUDA device is present):

1. Environment: versions, the card's name and power limit, the kernel build
   (nvcc for sm_90a, from celestia_tpu_torch/csrc/) and its seconds.
2. Each kernel against its plain PyTorch version on the card, byte for byte:
   K3 on messages of every length 0..600 (and against hashlib) and at the
   NMT level shapes; K1 and K2 at k = 1, 16, 64 and 128.
3. The reference DAH hashes (MIN k = 1, TYPICAL k = 2, MAX k = 128) through
   da.extend_shares -> new_data_availability_header(...).hash(), and the DAH
   computed on the device by extend_and_root_device equal to the host's.
4. Realistic squares (sorted v0 namespaces over random bytes, and a variant
   with a TAIL_PADDING tail) at k = 64 and k = 128. The launch counts are
   set to 0 just before the main path runs on the k = 128 square (extend ->
   DAH -> row levels, as a block producer runs it) and read just after. The
   kernel route equals the plain route for EDS, roots, row levels and DAH,
   and at k = 64 the roots equal the host oracle (gf256 + nmt_host).
5. Timing, after warm-up: each kernel at its main-path shapes, as its own
   device time per launch (torch.profiler's CUDA records, mean of 10
   launches) and as CUDA-event time per launch (median of 10 samples of 10
   back-to-back launches), beside its plain version (CUDA events, median of
   10 calls); the host-clock median of 10 calls of roots_device,
   extend_roots_device_resident and eds_row_levels_device end to end (host
   clock, H2D and D2H included) at k = 64 and k = 128; and a torch.profiler
   trace of one k = 128 roots_device call (device time by op, idle share).

Every measurement is one JSON line carrying the card's name and power limit.
Then come the ``kernels`` line, the card as nvidia-smi reports it, and the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and int8
# tensor-core rate. The int32 ALU rate is an estimate from the SM layout
# (64 INT32 lanes x 132 SMs x 1.98 GHz); one SHA-256 block is ~2.2k int32
# operations.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SHA_BLOCK_OPS = 2200
LEAF_BLOCKS = 9  # 542-byte NMT leaf message
NODE_BLOCKS = 3  # 181-byte NMT node message

# pkg/da/data_availability_header_test.go:28, :44, :50
MIN_DAH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
TYPICAL_DAH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
MAX_DAH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"

SEED = 20261017
REPS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card() -> tuple[str, str, str]:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.split(",", 1))
    return line, name, limit


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from celestia_tpu_torch import da
    from celestia_tpu_torch import namespace as ns
    from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_tpu_torch.ops import _cuda, extend, gf256, nmt_host, rs, rs_cuda
    from celestia_tpu_torch.ops import sha256, sha256_cuda

    # the plain RS contraction is a float32 matmul: state full fp32 (its
    # 0/1 operands make every partial sum exact in TF32 as well)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    smi_line, card_name, power_limit = card()
    tag = {"card": card_name, "power_limit": power_limit}

    def emit(**kw) -> None:
        print(json.dumps({**kw, **tag}), flush=True)

    def as_i64(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.uint32:
            return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return t.to(torch.int64)

    max_err = {"encode2d_hash": 0, "leaf_digests2d": 0, "sha256_words": 0}

    def same(name: str, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
        err = int((as_i64(a) - as_i64(b)).abs().max()) if a.numel() else 0
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{what}: kernel differs from its plain version (max abs err {err})")

    def dev_bytes(shape) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    # ---- phase 1: environment and build
    emit(phase="environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    _cuda.library()
    emit(phase="build", seconds=time.perf_counter() - t0)
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip(), file=sys.stderr)

    # ---- phase 2: each kernel against its plain version on the card
    for nb in range(1, sha256.padded_length(600) // 64 + 1):
        lengths = [n for n in range(601) if sha256.padded_length(n) == 64 * nb]
        msgs = [rng.integers(0, 256, size=(4, n), dtype=np.uint8) for n in lengths]
        words = torch.cat([sha256_cuda.message_words(torch.from_numpy(m).to(dev))
                           for m in msgs], dim=1)
        got = sha256_cuda.sha256_words(words)
        same("sha256_words", got, sha256_cuda.sha_core_reference(words), f"K3 nb={nb}")
        digests = sha256.words_to_bytes(got.view(torch.int32).T).cpu().numpy()
        flat = [row for m in msgs for row in m]
        check(all(d.tobytes() == hashlib.sha256(m.tobytes()).digest()
                  for d, m in zip(digests, flat)), f"K3 nb={nb} differs from hashlib")
        for m in msgs:  # the byte-level entry, one length at a time
            d = sha256.sha256_fixed(torch.from_numpy(m).to(dev)).cpu().numpy()
            check(all(d[i].tobytes() == hashlib.sha256(m[i].tobytes()).digest()
                      for i in range(len(m))), f"sha256_fixed len={m.shape[1]}")
    for nb, batch in ((NODE_BLOCKS, 65536), (NODE_BLOCKS, 4096), (2, 512), (2, 1)):
        words = dev_bytes((16 * nb, batch * 4)).view(torch.int32).view(torch.uint32)
        words = words.reshape(16 * nb, batch)
        same("sha256_words", sha256_cuda.sha256_words(words),
             sha256_cuda.sha_core_reference(words), f"K3 ({16 * nb}, {batch})")
    emit(phase="kernel_vs_plain", kernel="sha256_words", lengths="0..600",
         tolerance=0, max_abs_err=max_err["sha256_words"])

    for k in (1, 16, 64, 128):
        x2 = dev_bytes((k, k * SHARE_SIZE))
        m2 = rs.encode_matrix(k, dev)
        parity, digests = rs_cuda.encode2d_hash(x2, m2)
        ref_parity, ref_digests = rs_cuda.encode2d_hash_reference(x2, m2)
        same("encode2d_hash", parity, ref_parity, f"K1 parity k={k}")
        same("encode2d_hash", digests, ref_digests, f"K1 digests k={k}")
        ns_pad = dev_bytes((k, k, rs_cuda.NS_PAD))
        same("leaf_digests2d", rs_cuda.leaf_digests2d(x2, ns_pad),
             rs_cuda.leaf_digests2d_reference(x2, ns_pad), f"K2 k={k}")
        emit(phase="kernel_vs_plain", k=k, kernel="encode2d_hash+leaf_digests2d",
             tolerance=0, max_abs_err=max(max_err["encode2d_hash"], max_err["leaf_digests2d"]))
    x_eds, ns_eds = dev_bytes((256, 256 * SHARE_SIZE)), dev_bytes((256, 256, rs_cuda.NS_PAD))
    same("leaf_digests2d", rs_cuda.leaf_digests2d(x_eds, ns_eds),
         rs_cuda.leaf_digests2d_reference(x_eds, ns_eds), "K2 on a k=128 EDS")
    del x_eds, ns_eds
    torch.cuda.synchronize()

    # ---- phase 3: the reference DAH hashes through the port's main path
    def oracle_square(count: int) -> np.ndarray:
        ns1 = ns.new_v0(b"\x01" * ns.NAMESPACE_VERSION_ZERO_ID_SIZE)
        share = ns1.bytes + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)
        return np.frombuffer(share * count, np.uint8).reshape(count, SHARE_SIZE)

    def host_dah(rows: np.ndarray, cols: np.ndarray) -> bytes:
        return da.DataAvailabilityHeader([r.tobytes() for r in rows],
                                         [c.tobytes() for c in cols]).hash()

    oracles = [
        ("MIN", 1, da.tail_padding_share(), MIN_DAH),
        ("TYPICAL", 2, None, TYPICAL_DAH),
        ("MAX", 128, None, MAX_DAH),
    ]
    for label, k, share, expect in oracles:
        flat = (np.frombuffer(share, np.uint8)[None] if share is not None
                else oracle_square(k * k))
        if label == "MIN":
            got = da.min_data_availability_header(dev).hash().hex()
        else:
            got = da.new_data_availability_header(da.extend_shares(flat, dev)).hash().hex()
        check(got == expect, f"{label} DAH {got} != {expect}")
        _eds, rows, cols, dah = extend.extend_and_root_device(
            flat.reshape(k, k, SHARE_SIZE), dev)
        check(dah.tobytes().hex() == expect == host_dah(rows, cols).hex(),
              f"{label} device DAH differs from the host DAH")
        emit(phase="oracle", name=label, k=k, dah=got)

    # ---- phase 4: realistic squares, the main path, kernel route vs plain route
    def realistic(k: int, pad_tail: int) -> np.ndarray:
        flat = rng.integers(0, 256, size=(k * k, SHARE_SIZE), dtype=np.uint8)
        body = k * k - pad_tail
        subs = sorted(rng.integers(0, 200, size=(body, 10), dtype=np.uint8).tolist())
        for i, sub in enumerate(subs):
            flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
        tail = np.frombuffer(ns.TAIL_PADDING_NAMESPACE.bytes, np.uint8)
        flat[body:, :NAMESPACE_SIZE] = tail
        return flat.reshape(k, k, SHARE_SIZE)

    def host_oracle_roots(q0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        k = q0.shape[0]
        eds = np.zeros((2 * k, 2 * k, SHARE_SIZE), np.uint8)
        eds[:k, :k] = q0
        for i in range(k):
            eds[i, k:] = gf256.leopard_encode(q0[i])
            eds[k:, i] = gf256.leopard_encode(q0[:, i])
        for i in range(k, 2 * k):
            eds[i, k:] = gf256.leopard_encode(eds[i, :k])
        parity = ns.PARITY_SHARES_NAMESPACE.bytes

        def root(cells, axis):
            return nmt_host.nmt_root([
                (c[:NAMESPACE_SIZE].tobytes() if axis < k and j < k else parity) + c.tobytes()
                for j, c in enumerate(cells)])
        rows = np.stack([np.frombuffer(root(eds[i], i), np.uint8) for i in range(2 * k)])
        cols = np.stack([np.frombuffer(root(eds[:, j], j), np.uint8) for j in range(2 * k)])
        return rows, cols

    main_sq = realistic(128, 0)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    main_eds = da.extend_shares(main_sq.reshape(-1, SHARE_SIZE), dev)
    main_dah = da.new_data_availability_header(main_eds)
    main_levels = extend.eds_row_levels_device(main_eds.device_data, dev)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    emit(phase="main_path", k=main_sq.shape[0], entry="da.extend_shares+new_data_availability_header"
         "+eds_row_levels_device", launches=launches, dah=main_dah.hash().hex())
    for kname, n in launches.items():
        check(n > 0, f"the main path launched {kname} no time")

    squares = [("realistic", 64, realistic(64, 0)), ("tail_padding", 64, realistic(64, 700)),
               ("realistic", 128, main_sq), ("tail_padding", 128, realistic(128, 3000))]
    for label, k, sq in squares:
        got = extend.extend_and_root_device(sq, dev)
        plain = extend.extend_and_root_device(sq, dev, kernels=extend.PLAIN)
        for part, a, b in zip(("eds", "rows", "cols", "dah"), got, plain):
            check(np.array_equal(a, b), f"{label} k={k}: kernel route {part} != plain route")
        check(got[3].tobytes() == host_dah(got[1], got[2]), f"{label} k={k}: device DAH != host DAH")
        levels = extend.eds_row_levels_device(got[0], dev)
        plain_levels = extend.eds_row_levels_device(got[0], dev, kernels=extend.PLAIN)
        check(len(levels) == len(plain_levels) == int(np.log2(2 * k)) + 1, "level count")
        for a, b in zip(levels, plain_levels):
            check(np.array_equal(a, b), f"{label} k={k}: row levels differ from plain")
        check(np.array_equal(levels[-1][:, 0], got[1]), f"{label} k={k}: levels' roots")
        rows, cols = extend.roots_device(sq, dev)
        check(np.array_equal(rows, got[1]) and np.array_equal(cols, got[2]), "roots_device")
        e_rows, e_cols = extend.eds_roots_device(got[0], dev)
        check(np.array_equal(e_rows, got[1]) and np.array_equal(e_cols, got[2]),
              "eds_roots_device")
        if k == 64:
            h_rows, h_cols = host_oracle_roots(sq)
            check(np.array_equal(rows, h_rows) and np.array_equal(cols, h_cols),
                  f"{label} k=64: roots differ from the host oracle")
        if sq is main_sq:
            check(np.array_equal(main_eds.data, got[0]), "main path EDS")
            check(main_dah.hash() == got[3].tobytes(), "main path DAH")
            for a, b in zip(main_levels, levels):
                check(np.array_equal(a, b), "main path row levels")
        emit(phase="route_vs_plain", square=label, k=k, dah=got[3].tobytes().hex(),
             host_oracle=(k == 64))

    # ---- phase 5: timing
    def cuda_ms(fn, inner: int = 1, reps: int = REPS) -> float:
        """Median over `reps` samples of the CUDA-event time of `inner`
        back-to-back calls, per call. A call's host work (wrapper checks,
        allocation, launch) overlaps the device only across calls, so a
        kernel shorter than its launch path reads as the launch path."""
        fn()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def host_ms(fn, reps: int = REPS) -> float:
        fn()
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()  # ends in a D2H copy of the roots, so the device is done
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def bound(ops_s: float, nbytes: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(ops_s, t_bytes) * 1e3, ("operations" if ops_s >= t_bytes else "bytes")

    k = 128
    n = k * SHARE_SIZE
    nc = n // SHARE_SIZE
    x2 = torch.from_numpy(main_sq.reshape(k, n)).to(dev)
    m2 = rs.encode_matrix(k, dev)
    ns_pad = rs_cuda.pad_namespaces(torch.from_numpy(main_sq[..., :NAMESPACE_SIZE]).to(dev))
    sha_ops = LEAF_BLOCKS * k * nc * SHA_BLOCK_OPS / INT32_OPS_PER_S
    k1_bound = bound(max(2 * (8 * k) ** 2 * n / INT8_OPS_PER_S, sha_ops),
                     2 * k * n + m2.packed.numel() * 4 + k * nc * 32)
    k2_bound = bound(sha_ops, k * n + 2 * k * nc * 32)
    eds_dev = main_eds.device_data
    ns_eds = rs_cuda.pad_namespaces(extend._leaf_namespaces(
        eds_dev[:k, :k, :NAMESPACE_SIZE], k).contiguous())
    x_eds = eds_dev.reshape(2 * k, 2 * n)
    calls = {
        "encode2d_hash": lambda: rs_cuda.encode2d_hash(x2, m2),
        "leaf_digests2d": lambda: rs_cuda.leaf_digests2d(x2, ns_pad),
        "leaf_digests2d_eds": lambda: rs_cuda.leaf_digests2d(x_eds, ns_eds),
    }
    # K3 at the shapes of one extend's NMT levels (both tree families
    # stacked): the sum over the 8 levels is one extend's K3 work
    k3_shapes = []
    batch = 2 * (2 * k) * (2 * k) // 2
    while batch >= 2 * (2 * k):
        words = dev_bytes((16 * NODE_BLOCKS, batch * 4)).view(torch.int32)
        words = words.view(torch.uint32).reshape(16 * NODE_BLOCKS, batch)
        k3_shapes.append((batch, words))
        calls[f"sha256_words_{batch}"] = (lambda w=words: sha256_cuda.sha256_words(w))
        batch //= 2
    event_ms = {name: cuda_ms(fn, inner=10) for name, fn in calls.items()}
    plain_ms = {
        "encode2d_hash": cuda_ms(lambda: rs_cuda.encode2d_hash_reference(x2, m2)),
        "leaf_digests2d": cuda_ms(lambda: rs_cuda.leaf_digests2d_reference(x2, ns_pad)),
    }
    for batch, words in k3_shapes:
        plain_ms[f"sha256_words_{batch}"] = cuda_ms(
            lambda w=words: sha256_cuda.sha_core_reference(w))

    roots_ms = {}
    for kk in (64, 128):
        sq = main_sq if kk == 128 else realistic(64, 0)
        eds_kk = extend.extend_roots_device_resident(sq, dev)[0]
        roots_ms[kk] = host_ms(lambda: extend.roots_device(sq, dev))
        emit(phase="end_to_end", k=kk, entry="roots_device", ms=roots_ms[kk])
        emit(phase="end_to_end", k=kk, entry="extend_roots_device_resident",
             ms=host_ms(lambda: extend.extend_roots_device_resident(sq, dev)))
        emit(phase="end_to_end", k=kk, entry="eds_row_levels_device",
             ms=host_ms(lambda: extend.eds_row_levels_device(eds_kk, dev)))

    # ONE profiler session (separate sessions in one process lost their
    # records on the card): REPS launches of each timed kernel, in order,
    # then one k = 128 roots_device call. Each kernel's device time per
    # launch comes from its CUDA activity records, split by launch order
    # (every timed call launches exactly one of the port's kernels); the
    # device records after the last timed launch are the roots_device
    # breakdown. The profiler slows the host, so the idle share is taken
    # against the unprofiled median above.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    extend.roots_device(main_sq, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(REPS):
                fn()
        torch.cuda.synchronize()
        extend.roots_device(main_sq, dev)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"), key=lambda e: e.time_range.start)
    timed = [e for e in evs if "celestia::" in e.name][:REPS * len(calls)]
    check(len(timed) == REPS * len(calls),
          f"the profiler recorded {len(timed)} of {REPS * len(calls)} timed kernel launches")
    dev_ms = {name: sum(e.time_range.elapsed_us() for e in timed[i * REPS:(i + 1) * REPS])
              / 1e3 / REPS for i, name in enumerate(calls)}
    by_op: dict[str, list] = {}
    for e in evs:
        if e.time_range.start >= timed[-1].time_range.end:
            entry = by_op.setdefault(e.name[:90], [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(v[0] for v in by_op.values())
    check(busy_ms > 0, "the profiler recorded no device time for roots_device")

    results = {}
    for kname in ("encode2d_hash", "leaf_digests2d"):
        results[kname] = (dev_ms[kname], event_ms[kname], plain_ms[kname],
                          k1_bound if kname == "encode2d_hash" else k2_bound)
    k3_dev = k3_event = k3_plain = k3_ops = k3_bytes = 0.0
    for batch, _words in k3_shapes:
        name = f"sha256_words_{batch}"
        emit(phase="timing", kernel="sha256_words", shape=[16 * NODE_BLOCKS, batch],
             device_ms=dev_ms[name], event_ms=event_ms[name], plain_ms=plain_ms[name])
        k3_dev += dev_ms[name]
        k3_event += event_ms[name]
        k3_plain += plain_ms[name]
        k3_ops += NODE_BLOCKS * batch * SHA_BLOCK_OPS / INT32_OPS_PER_S
        k3_bytes += 16 * NODE_BLOCKS * batch * 4 + 8 * batch * 4
    results["sha256_words"] = (k3_dev, k3_event, k3_plain, bound(k3_ops, k3_bytes))
    for kname, (t_d, t_e, t_p, (b_ms, b_by)) in results.items():
        emit(phase="timing", kernel=kname, k=k, device_ms=t_d, event_ms=t_e, plain_ms=t_p,
             bound_ms=b_ms, bound_by=b_by)
    emit(phase="timing", kernel="leaf_digests2d", shape=[2 * k, 2 * n],
         device_ms=dev_ms["leaf_digests2d_eds"], event_ms=event_ms["leaf_digests2d_eds"],
         bound_ms=bound(4 * sha_ops, 4 * (k * n + 2 * k * nc * 32))[0])
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    emit(phase="profile", k=main_sq.shape[0], entry="roots_device",
         device_busy_ms=busy_ms, roots_device_ms=roots_ms[128],
         device_idle_share=1 - busy_ms / roots_ms[128], device_ops=len(by_op),
         launches=sum(v[1] for v in by_op.values()),
         top=[{"op": name, "ms": v[0], "count": v[1]} for name, v in top[:12]])

    sources = {
        "encode2d_hash": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:276"),
        "leaf_digests2d": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:295"),
        "sha256_words": ("celestia_tpu_torch/csrc/sha256_words.cu",
                         "celestia_tpu/ops/sha256_pallas.py:129"),
    }
    kernels = []
    for kname, (t_d, _t_e, t_p, (b_ms, b_by)) in results.items():
        src, replaces = sources[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": t_d, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
