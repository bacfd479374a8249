"""Device-side square assembly (ops/assemble, ops/assemble_cuda,
ops/extend.assembled_roots, app/proposal) on the CPU against the JAX
package, byte for byte.

- The plain version equals the JAX graph ``extend_tpu._assemble_square``
  on every input family of chip_smoke.py (one blob, many blobs of odd
  lengths, host cells over blob cells, cells nothing covers, no blob, blobs
  past the arena's end, every shift between a share's arena bytes and its
  cell) at k = 1..16, and a numpy emulation of the CUDA kernel
  (csrc/assemble_square.cu: its narrowed windows, realigned word loads,
  masks and byte path) equals the plain version.
- ``assembled_roots`` on the CPU equals the JAX ``assembled_roots`` and the
  port's ``roots_device(device="cpu")`` of the host-built square, for
  squares built from blob txs: one and many blobs, multi-share and odd
  sizes, partial residency, tail padding, and an arena that has flipped.
- ``assembled_proposal_dah`` returns the host DAH, and None exactly where
  the JAX App's ``_assembled_proposal_dah`` declines.
"""

import gc
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu import blob as j_blob
from celestia_tpu import da as j_da
from celestia_tpu import namespace as j_ns
from celestia_tpu import square as j_square
from celestia_tpu.app import App
from celestia_tpu.crypto import PrivateKey
from celestia_tpu.ops import extend_tpu
from celestia_tpu.shares import to_bytes as j_to_bytes
from celestia_tpu.tx import Fee, sign_tx
from celestia_tpu.x.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_tpu_torch import square
from celestia_tpu_torch.app import proposal
from celestia_tpu_torch.ops import _cuda, assemble, assemble_cuda, extend
from celestia_tpu_torch.ops.blob_pool import DeviceBlobArena
from celestia_tpu_torch.shares import to_bytes

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

@pytest.fixture(autouse=True, scope="module")
def _collect_jax_arenas():
    """The JAX package's arenas and Apps enrol in its device ledger until
    they are collected: collect them before the next module, so none of
    this module's outlives it."""
    yield
    gc.collect()


FAMILIES = chip_smoke.ASSEMBLY_FAMILIES
KS = [1, 2, 4, 8, 16]
META = ("blob_start", "blob_nshares", "blob_off", "blob_len")


def tensors(case: dict) -> tuple:
    """A case as the kernel's CPU tensors (the layout assembled_roots stages)."""
    meta = np.stack([case[f] for f in META]).astype(np.int32)
    sparse = np.stack([case["host_pos"], case["host_row"]]).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        case["arena"], case["host_shares"], meta, case["ns_table"], sparse))


def jax_assemble(case: dict, k: int) -> np.ndarray:
    """The JAX graph on the case, fed as the JAX entry pads and stages it
    (extend_tpu._assembled_roots_traced)."""
    s = k * k
    n_b, n_h, n_hc = len(case["ns_table"]), len(case["host_shares"]), len(case["host_pos"])
    h_pad = extend_tpu._pow2_at_least(max(n_h, 1), 16)
    b_pad = extend_tpu._pow2_at_least(max(n_b, 1), 8)
    hc_pad = extend_tpu._pow2_at_least(max(n_hc, 1), 16)
    hs = np.zeros((h_pad, 512), np.uint8)
    hs[:n_h] = case["host_shares"]
    nslen = np.zeros((b_pad, 33), np.uint8)
    nslen[:n_b, :29] = case["ns_table"]
    nslen[:n_b, 29:] = np.asarray(case["blob_len"], ">u4").view(np.uint8).reshape(n_b, 4)
    bm = np.zeros((4, b_pad), np.int32)
    bm[0, :] = s
    for i, f in enumerate(META):
        bm[i, :n_b] = case[f]
    hsp = np.full((2, hc_pad), s, np.int32)
    hsp[0, :n_hc] = case["host_pos"]
    hsp[1, :n_hc] = case["host_row"]
    out = extend_tpu._assemble_square(jnp.asarray(case["arena"]), jnp.asarray(hs),
                                      jnp.asarray(bm), jnp.asarray(hsp), jnp.asarray(nslen), k)
    return np.asarray(out)


WARPS, CELLS = 4, 2  # csrc/assemble_square.cu: kWarps, kCells
TILE, WIN = WARPS * CELLS, 64  # kTile, kWin
NARROW_TO = WIN - TILE - 1  # kNarrowTo
LANES = np.arange(32)


def narrow(a: np.ndarray, v: int, strict: bool) -> int:
    """The kernel's ``narrow``: each step the 32 lanes test the last entry
    of 32 equal segments and the ballot's popcount keeps one segment."""
    lo, hi = 0, len(a)
    while hi - lo > NARROW_TO:
        w = (hi - lo + 31) >> 5
        q = lo + (LANES + 1) * w - 1
        x = a[np.minimum(q, len(a) - 1)]
        c = int(((q < hi) & ((x < v) if strict else (x <= v))).sum())
        hi = min(lo + (c + 1) * w - 1, hi)
        lo += c * w
    return lo


def window(a: np.ndarray, wb: int, below: int, above: int) -> np.ndarray:
    """Entries wb .. wb + 63 of a, padded as the kernel pads them."""
    i = wb + np.arange(WIN)
    return np.where(i < 0, below, np.where(i < len(a), a[np.clip(i, 0, len(a) - 1)], above))


def funnel(lo: np.ndarray, hi: np.ndarray, s: int) -> np.ndarray:
    """__funnelshift_r on uint32 words held as int64."""
    return ((hi << 32 | lo) >> s) & 0xFFFFFFFF


def realign(x: np.ndarray, y: np.ndarray, r: int) -> np.ndarray:
    """The kernel's ``realign``, one case a value of r / 4: (32, 4) words
    of x ‖ y shifted by r bytes."""
    xy = np.concatenate([x, y], axis=1)  # (32, 8)
    q, s = r >> 2, 8 * (r & 3)
    return np.stack([funnel(xy[:, q + i], xy[:, q + i + 1], s) for i in range(4)], axis=1)


def lane_mask(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The kernel's ``lane_mask``: (32,) lanes' bytes [lo, hi) of their 16
    as a 16-bit mask, each nibble spread to a word's bytes by a multiply."""
    lo, hi = np.clip(lo, 0, 16), np.clip(hi, 0, 16)
    m = ((1 << hi) - 1) & ~((1 << lo) - 1)
    nib = (m[:, None] >> (4 * np.arange(4))) & 15
    return (((nib * 0x00204081) & 0x01010101) * 0xFF) & 0xFFFFFFFF


def words(b: np.ndarray) -> np.ndarray:
    """(..., 16) bytes -> (..., 4) little-endian words as int64."""
    return b.astype(np.int64).reshape(*b.shape[:-1], 4, 4) @ (1 << (8 * np.arange(4)))


def emulate_kernel(case: dict, k: int) -> np.ndarray:
    """csrc/assemble_square.cu in numpy (its arena 16-byte aligned): per
    tile of 8 cells the blob and host windows the ballot-narrowed searches
    leave; per cell, its window lookups and then, per lane, the aligned
    vector it loads (lane 0: V_32), the neighbour's, the funnel shift by
    r, the tail mask and the prefix merged into lanes 0-2; the byte path,
    with its clamping, whenever a vector would leave the arena. Asserts
    that no vector load leaves it."""
    s = k * k
    starts = case["blob_start"].astype(np.int64)
    nsh, off, ln = (case[f].astype(np.int64) for f in META[1:])
    pos, rows = case["host_pos"].astype(np.int64), case["host_row"].astype(np.int64)
    arena, host, ns = case["arena"], case["host_shares"], case["ns_table"]
    n_arena, nb = len(arena), len(starts)
    vecs = np.zeros((n_arena + 15) // 16 * 16, np.uint8)
    vecs[:n_arena] = arena
    vecs = words(vecs.reshape(-1, 16))  # (vectors, 4)
    out = np.zeros((s, 32, 4), np.int64)
    for c0 in range(0, s, TILE):
        if nb:
            bwb = narrow(starts, c0, strict=False) - 1
            w_start = window(starts, bwb, -(1 << 31), (1 << 31) - 1)
            w_nsh, w_off, w_len = (window(a, bwb, 0, 0) for a in (nsh, off, ln))
        if len(pos):
            hwb = narrow(pos, c0, strict=True) - 1
            w_hpos, w_hrow = window(pos, hwb, -1, -1), window(rows, hwb, 0, 0)
        for c in range(c0, min(c0 + TILE, s)):
            if len(pos) and (w_hpos == c).any():
                h = int(np.flatnonzero(w_hpos == c)[0])
                out[c] = words(host[min(max(int(w_hrow[h]), 0), len(host) - 1)].reshape(32, 16))
                continue
            first, data_start, data_len, cb, blen = False, 0, 0, 0, 0
            if nb:
                cnt = int((w_start <= c).sum())
                slot = min(max(max(bwb + cnt - 1, 0) - bwb, 0), WIN - 1)
                j = c - int(w_start[slot])
                if 0 <= j < w_nsh[slot]:
                    first = j == 0
                    doff = 0 if first else 478 + (j - 1) * 482
                    data_start = int(w_off[slot]) + doff
                    data_len = min(478 if first else 482, int(w_len[slot]) - doff)
                    cb, blen = bwb + slot, int(w_len[slot]) & 0xFFFFFFFF
            pre = 34 if first else 30
            end = pre + max(data_len, 0)
            d = np.zeros((32, 4), np.int64)
            if data_len > 0:
                v_lo, v_hi = data_start >> 4, (data_start + data_len + 15) >> 4
                if v_lo >= 0 and v_hi * 16 <= n_arena:  # the word path
                    a_cell = data_start - pre
                    r = a_cell & 15
                    vm = (a_cell >> 4) + np.where(LANES == 0, 32, LANES)
                    need = (vm >= v_lo) & (vm < v_hi)
                    assert (vm[need] >= 0).all() and (vm[need] * 16 + 16 <= n_arena).all()
                    x = np.where(need[:, None], vecs[np.where(need, vm, 0)], 0)
                    d = realign(x, np.roll(x, -1, axis=0), r)
                else:  # the byte path
                    p = np.arange(512) - pre
                    idx = np.clip(data_start + p, 0, n_arena - 1)
                    d = words(np.where((p >= 0) & (p < data_len), arena[idx], 0)
                              .astype(np.uint8).reshape(32, 16))
            d &= lane_mask(pre - 16 * LANES, end - 16 * LANES)
            prefix = np.zeros(48, np.uint8)  # the warp's shared-memory prefix
            if nb:
                prefix[:29] = ns[cb]
            prefix[29] = 1 if first else 0
            if first:
                prefix[30:34] = np.frombuffer(blen.to_bytes(4, "big"), np.uint8)
            d[:3] |= words(prefix.reshape(3, 16))
            out[c] = d
    cells = out.astype("<u4").view(np.uint8)
    return cells.reshape(k, k, 512)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k", KS)
def test_plain_equals_jax_graph_and_kernel_emulation(k, family):
    case = chip_smoke.assembly_case(k, 1000 + k, family)
    got = assemble.assemble_square_reference(*tensors(case), k).numpy()
    assert np.array_equal(got, jax_assemble(case, k))
    assert np.array_equal(got, emulate_kernel(case, k))


@pytest.mark.parametrize("strict", [False, True])
def test_narrowed_window_holds_every_cell_of_a_tile(strict):
    """The kernel's window (64 entries from one before the narrowed range)
    holds, for every cell of a tile, the entry that cell names,
    over strictly ascending arrays of up to k² entries: blob starts
    (count <= c, strict=False) and host positions (count < c)."""
    rng = np.random.default_rng(17)
    arrays = [np.sort(rng.choice(s, size=n, replace=False)).astype(np.int64) for s, n in (
        (16384, 16384), (16384, 8192), (16384, 1537), (16384, 1444), (4096, 60), (256, 48),
        (64, 47), (16384, 1))]
    # dense runs, where every tile holds 16 entries: the narrowed range's
    # end meets a full tile for some c0
    arrays += [np.arange(n, dtype=np.int64) + 3 for n in (1537, 1600, 3000)]
    for a in arrays:
        s = int(a[-1]) + 2
        for c0 in range(0, s, TILE):
            wb = narrow(a, c0, strict) - 1
            for c in range(c0, c0 + TILE):
                count = int(np.searchsorted(a, c, "left" if strict else "right"))
                assert wb <= count - 1 and count < wb + WIN, (len(a), c0, c)


def test_cell_covered_by_nothing_is_blob0_namespace_then_zeros():
    """JAX writes blob 0's namespace ‖ 0x00 ‖ zeros on a cell no blob or host
    row covers, and all zeros with no blob: checked against JAX, not assumed."""
    case = chip_smoke.assembly_case(4, 7, "uncovered")
    got = assemble.assemble_square_reference(*tensors(case), 4).reshape(16, 512).numpy()
    covered = np.zeros(16, bool)
    for st, n in zip(case["blob_start"], case["blob_nshares"]):
        covered[st: st + n] = True
    free = np.flatnonzero(~covered)
    assert len(free)
    for c in free:
        assert got[c, :29].tobytes() == case["ns_table"][0].tobytes()
        assert not got[c, 29:].any()
    assert np.array_equal(got, jax_assemble(case, 4).reshape(16, 512))
    empty = chip_smoke.assembly_case(2, 3, "no_blobs")
    empty["host_pos"] = empty["host_pos"][:0]
    empty["host_row"] = empty["host_row"][:0]
    zeros = assemble.assemble_square_reference(*tensors(empty), 2).numpy()
    assert not zeros.any() and np.array_equal(zeros, jax_assemble(empty, 2))


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    case = chip_smoke.assembly_case(8, 5, "many_blobs")
    before = _cuda.LAUNCHES["assemble_square"]
    got = assemble_cuda.assemble_square(*tensors(case), 8)
    assert torch.equal(got, assemble.assemble_square_reference(*tensors(case), 8))
    assert _cuda.LAUNCHES["assemble_square"] == before  # no kernel on the CPU
    assert extend.PLAIN.assemble_square is assemble.assemble_square_reference
    assert extend.KERNELS.assemble_square is assemble_cuda.assemble_square


@pytest.mark.parametrize("bad", ["dtype", "ns_shape", "host_missing", "k"])
def test_wrapper_checks_its_inputs(bad):
    arena, host, meta, ns, sparse = tensors(chip_smoke.assembly_case(4, 9, "host_over_blob"))
    assert sparse.shape[1] > 0
    k = 4
    if bad == "dtype":
        meta = meta.to(torch.int64)
    elif bad == "ns_shape":
        ns = ns[:, :28]
    elif bad == "host_missing":
        host = host[:0]
    else:
        k = 256
    with pytest.raises(ValueError):
        assemble_cuda.assemble_square(arena, host, meta, ns, sparse, k)


def test_assembled_roots_checks_the_order_jax_checks():
    case = chip_smoke.assembly_case(4, 11, "many_blobs")
    arena = torch.from_numpy(case["arena"])
    args = {f: case[f] for f in ("host_shares", "host_pos", "host_row", *META, "ns_table")}
    if len(case["blob_start"]) > 1:
        args["blob_start"] = case["blob_start"][::-1].copy()
        with pytest.raises(ValueError, match="strictly ascending"):
            extend.assembled_roots(arena, **args, k=4)
        with pytest.raises(ValueError, match="strictly ascending"):
            extend_tpu.assembled_roots(jnp.asarray(case["arena"]), **args, k=4)
    args = {f: case[f] for f in ("host_shares", "host_pos", "host_row", *META, "ns_table")}
    args["host_row"] = args["host_row"] + len(args["host_shares"])
    with pytest.raises(ValueError, match="host_pos"):
        extend.assembled_roots(arena, **args, k=4)


@pytest.mark.parametrize("family", FAMILIES)
def test_assembled_roots_equal_jax(family):
    k = 8
    case = chip_smoke.assembly_case(k, 2000 + len(family), family)
    args = {f: case[f] for f in ("host_shares", "host_pos", "host_row", *META, "ns_table")}
    rows, cols = extend.assembled_roots(torch.from_numpy(case["arena"]), **args, k=k)
    j_rows, j_cols = extend_tpu.assembled_roots(jnp.asarray(case["arena"]), **args, k=k)
    assert np.array_equal(rows, j_rows) and np.array_equal(cols, j_cols)


# ---------------------------------------------------------------------- #
# the proposer's path from blob txs

SIGNER = PrivateKey.from_secret(b"pool-signer")


def blob_txs(n: int, size: int, seed: int = 0) -> list[bytes]:
    """Signed blob txs as tests/test_blob_pool.py makes them (the JAX
    package signs; both packages get the same bytes)."""
    addr = SIGNER.bech32_address()
    rng = np.random.default_rng(seed)
    txs = []
    for i in range(n):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        b = j_blob.new_blob(j_ns.new_v0(b"pool" + i.to_bytes(4, "big")), data, 0)
        gas = estimate_gas([size])
        tx = sign_tx(SIGNER, [new_msg_pay_for_blobs(addr, b)], "pool-1", 0, i,
                     Fee(amount=gas, gas_limit=gas))
        txs.append(j_blob.marshal_blob_tx(tx.marshal(), [b]))
    return txs


def odd_sizes() -> list[bytes]:
    txs = []
    for sz in (1, 477, 478, 479, 478 + 482, 478 + 482 + 1, 10_000):
        txs += blob_txs(1, sz, seed=sz)
    return txs


def compact_and_blob_txs() -> list[bytes]:
    """Normal txs before the blob txs: more compact shares as host cells."""
    rng = np.random.default_rng(8)
    return [rng.integers(0, 256, 900, dtype=np.uint8).tobytes() for _ in range(3)] + \
        blob_txs(4, 2500, seed=8)


CASES = {
    "one_blob": (lambda: blob_txs(1, 3000), (), 8 << 20),
    "many_blobs": (lambda: blob_txs(6, 3000), (), 8 << 20),
    "odd_sizes": (odd_sizes, (), 8 << 20),
    "partial": (lambda: blob_txs(6, 3000), (2,), 8 << 20),
    "mostly_missing": (lambda: blob_txs(6, 3000), (0, 1, 2, 3), 8 << 20),
    "compact_txs": (compact_and_blob_txs, (), 8 << 20),
    # a 96 KiB arena holds 2 padded 20 KB blobs a half: staging five flips
    # it twice; 4 padded 9 KB blobs a half: ten flip it twice and evict the
    # first half
    "flipped": (lambda: blob_txs(5, 20_000, seed=21), (), 96 * 1024),
    "flipped_twice": (lambda: blob_txs(10, 9_000, seed=600), (), 96 * 1024),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_assembled_proposal_dah_equal_jax(name):
    make, skip, capacity = CASES[name]
    txs = make()
    sq, kept, builder = square.build_ex(txs, 1, 128)
    j_sq, j_kept, j_builder = j_square.build_ex(txs, 1, 128)
    assert to_bytes(sq) == j_to_bytes(j_sq) and kept == j_kept
    k = square.square_size(len(sq))
    assert k <= 16
    arena = DeviceBlobArena(capacity, device="cpu")
    app = App(extend_backend="tpu")
    j_arena = app.enable_blob_pool(capacity_bytes=capacity)
    for i, (_s, b) in enumerate(builder.blob_layout()):
        if i not in skip:
            arena.put(b.data)
    for i, (_s, b) in enumerate(j_builder.blob_layout()):
        if i not in skip:
            j_arena.put(b.data)
    assert arena._offsets == j_arena._offsets
    if capacity < 1 << 20:  # the small arenas flipped and evicted
        assert arena.resident_bytes() < sum(len(b.data) for _s, b in builder.blob_layout())
    dah = proposal.assembled_proposal_dah(arena, sq, builder, k, device="cpu")
    j_dah = app._assembled_proposal_dah(j_sq, j_builder, k)
    assert (dah is None) == (j_dah is None)
    if dah is None:
        return
    assert dah.row_roots == j_dah.row_roots and dah.column_roots == j_dah.column_roots
    host = np.frombuffer(b"".join(to_bytes(sq)), np.uint8).reshape(k, k, 512)
    rows, cols = extend.roots_device(host, device="cpu")
    assert dah.row_roots == [r.tobytes() for r in rows]
    assert dah.column_roots == [c.tobytes() for c in cols]
    j_host = j_da.new_data_availability_header(j_da.extend_shares(j_to_bytes(j_sq)))
    assert dah.hash() == j_host.hash()


def test_no_blobs_declines_as_jax_does():
    rng = np.random.default_rng(4)
    txs = [rng.integers(0, 256, 400, dtype=np.uint8).tobytes() for _ in range(3)]
    sq, _kept, builder = square.build_ex(txs, 1, 128)
    j_sq, _jk, j_builder = j_square.build_ex(txs, 1, 128)
    app = App(extend_backend="tpu")
    app.enable_blob_pool(capacity_bytes=1 << 20)
    k = square.square_size(len(sq))
    assert app._assembled_proposal_dah(j_sq, j_builder, k) is None
    arena = DeviceBlobArena(1 << 20, device="cpu")
    assert proposal.assembled_proposal_dah(arena, sq, builder, k, device="cpu") is None


def test_proposal_inputs_stage_tens_of_kb():
    """The metadata of a blob-heavy square is its host table (unique shares)
    and per-blob rows, not the square: here under a tenth of it."""
    txs = blob_txs(6, 3000)
    sq, _kept, builder = square.build_ex(txs, 1, 128)
    k = square.square_size(len(sq))
    arena = DeviceBlobArena(8 << 20, device="cpu")
    arena.put_many([b.data for _s, b in builder.blob_layout()])
    inputs = proposal.proposal_inputs(arena, sq, builder, k)
    nbytes = sum(np.asarray(v).nbytes for v in inputs.values())
    assert len(inputs["host_shares"]) < len(inputs["host_pos"])
    assert nbytes < k * k * 512 // 4


def test_arena_on_another_device_is_refused():
    arena = DeviceBlobArena(8192, device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        proposal.assembled_proposal_dah(arena, [], None, 1, device="cuda")
