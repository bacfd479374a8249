"""EDS repair in the port, byte for byte against the JAX package.

The decode half of gf256, ``plan_sweeps``, the host ``repair``,
``repair_device``, ``repair_resident_verified`` and ``repair_eds`` are held
against ``celestia_tpu`` (its device sweeps run as its own tests run them
on the CPU, through XLA) and against the truth on the same squares, masks
and seeds as ``tests/test_repair.py``. The outputs are code words: every
comparison is exact equality.

``_kernel_sweep`` is a numpy emulation of what ``csrc/rs_decode.cu`` runs
on the card. It reads only the operands the wrapper sends
(``rs.decode_operands``: the one multiply table of half rows and
high-bit products, and the twiddles' multiply entries; the plan's scale, unscale
and write bytes; the axis and cell strides of the square), builds each
work item's staged constants as the kernel does,
holds 4 positions of one lane per state word, multiplies with the
kernel's byte permutes (the sign-replicating ones included), maps
codeword positions to cells with the kernel's address arithmetic, runs the
derivative in the kernel's order and stores only the marked cells. It is
held against ``celestia_tpu.ops.gf256.leopard_decode_batch`` and against
every sweep of the JAX package's ``repair_tpu._sweep_device``. On the
card, ``chip_smoke.py`` holds the kernel itself against its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu import da as jax_da
from celestia_tpu.da import repair as jax_da_repair
from celestia_tpu.ops import extend_tpu, repair_tpu
from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu_torch import da
from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.da import repair as da_repair
from celestia_tpu_torch.da.repair import UnrepairableError
from celestia_tpu_torch.ops import extend, gf256, repair, repair_cuda, rs
from tests.test_torch_extend import square

SMALL_K = [1, 2, 4, 8, 16]
CPU = torch.device("cpu")
TABLE = 256 * rs.HALF_ROW  # bytes of the half rows H before the high-bit products
BRANCH_DIST = 8  # groups this wide branch over a zero twiddle (kBranchDist)
LANES = SHARE_SIZE  # two blocks of 256 threads per axis, one byte lane a thread
U32 = np.uint32


def jax_eds(k: int, seed: int) -> np.ndarray:
    """The JAX package's EDS of ``square(k, seed)`` (the bytes of
    ``tests/test_repair.py``'s ``make_eds(k, seed)``)."""
    return np.asarray(jax_da.extend_shares(square(k, seed)).data)


def patterns(k: int, rng) -> list[np.ndarray]:
    """``tests/test_repair.py``'s ``_patterns``: two random masks (20% and
    35% erased) and the multi-sweep mask (a full row, a full column and a
    corner); k = 1 has two masks of its own."""
    width = 2 * k
    if k == 1:
        return [np.array([[False, True], [True, True]]),
                np.array([[True, False], [False, True]])]
    out = []
    for frac in (0.2, 0.35):
        p = np.ones((width, width), dtype=bool)
        flat = rng.choice(width * width, size=int(frac * width * width), replace=False)
        p.reshape(-1)[flat] = False
        out.append(p)
    p = np.ones((width, width), dtype=bool)
    p[1, :] = False
    p[:, 2] = False
    p[0, 0] = False
    out.append(p)
    return out


def axis_masks(k: int, axes: int, rng) -> np.ndarray:
    """(axes, 2k) masks with k to 2k - 1 present positions each."""
    present = np.zeros((axes, 2 * k), dtype=bool)
    for a in range(axes):
        keep = rng.choice(2 * k, size=k + int(rng.integers(0, k)), replace=False)
        present[a, keep] = True
    return present


# ---------------------------------------------------------------------- #
# the decode half of gf256


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_decode_core_matrix_matches_jax(n):
    assert np.array_equal(gf256.decode_core_matrix(n), jax_gf256.decode_core_matrix(n))
    for dist in (1, n // 2):
        assert np.array_equal(gf256._level_logs(n, dist, 0), jax_gf256._level_logs(n, dist, 0))


def test_locator_matrix_and_error_locator_match_jax():
    assert np.array_equal(gf256._locator_matrix(), jax_gf256._locator_matrix())
    rng = np.random.default_rng(11)
    for n in (2, 8, 32, 256):
        erased = rng.integers(0, 2, size=(7, n)).astype(np.int64)
        assert np.array_equal(gf256._error_locator_logs_batch(erased),
                              jax_gf256._error_locator_logs_batch(erased))


@pytest.mark.parametrize("k", SMALL_K)
def test_leopard_decode_batch_matches_jax_and_truth(k):
    rng = np.random.default_rng(100 + k)
    data = rng.integers(0, 256, size=(6, k, 40), dtype=np.uint8)
    cells = np.stack([np.concatenate([d, gf256.leopard_encode(d)]) for d in data])
    present = axis_masks(k, 6, rng)
    src = np.where(present[..., None], cells, 0xCD).astype(np.uint8)
    got = gf256.leopard_decode_batch(src, present, k)
    assert np.array_equal(got, jax_gf256.leopard_decode_batch(src, present, k))
    assert np.array_equal(got, cells)
    assert np.array_equal(gf256.leopard_decode(src[0], present[0], k), cells[0])


def test_leopard_decode_refuses_too_few_shards_like_jax():
    k = 4
    present = np.zeros(2 * k, dtype=bool)
    present[: k - 1] = True
    cells = np.zeros((2 * k, 8), dtype=np.uint8)
    for mod in (gf256, jax_gf256):
        with pytest.raises(ValueError, match="not enough"):
            mod.leopard_decode(cells, present, k)


def test_gf_matmul_and_inverse_match_jax():
    rng = np.random.default_rng(1)
    for n in (1, 4, 16):
        while True:
            a = rng.integers(0, 256, size=(n, n), dtype=np.uint8)
            try:
                inv = gf256.gf_inverse(a)
                break
            except ValueError:
                continue
        assert np.array_equal(inv, jax_gf256.gf_inverse(a))
        assert np.array_equal(gf256.gf_matmul(a, inv), np.eye(n, dtype=np.uint8))
        b = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
        assert np.array_equal(gf256.gf_matmul(a, b), jax_gf256.gf_matmul(a, b))
    with pytest.raises(ValueError, match="singular"):
        gf256.gf_inverse(np.zeros((3, 3), dtype=np.uint8))


# ---------------------------------------------------------------------- #
# the decode operands and the plan


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_decode_program_shape(n):
    consts = rs.decode_program(n)
    assert consts.dtype == np.uint8 and consts.shape == (2 * (n - 1),)
    # both transforms take skew[r + dist - 1], offset 0: twiddle by twiddle
    skew = gf256.fft_skew()
    logs = []
    for dist in [1 << i for i in range(n.bit_length() - 1)]:
        logs += [int(skew[r + dist - 1]) for r in range(0, n, 2 * dist)]
    for dist in [n >> (i + 1) for i in range(n.bit_length() - 1)]:
        logs += [int(skew[r + dist - 1]) for r in range(0, n, 2 * dist)]
    assert consts.tolist() == [0 if lg == gf256.K_MODULUS else int(gf256.exp_table()[lg])
                               for lg in logs]
    if n == 256:
        assert len(set(consts.tolist()) - {0}) == 127  # distinct nonzero twiddles


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256])
def test_decode_program_is_the_twiddles_of_decode_core(n):
    """The group table's entries are the twiddle constants the JAX
    package's ``_decode_core`` multiplies by, level by level (its
    ``_level_logs``, offset 0), in the kernel's group order."""
    want = []
    levels = [1 << i for i in range(n.bit_length() - 1)]
    for dist in levels + levels[::-1]:
        logs = jax_gf256._level_logs(n, dist, 0)
        want += [0 if lg == gf256.K_MODULUS else int(gf256.exp_table()[lg]) for lg in logs]
    assert rs.decode_program(n).tolist() == want


def test_decode_table_multiplies_every_pair():
    """H equals GF(256) multiplication on every half row, and
    c·y = H[c][y & 0x7F] ^ [y >= 128]·c·0x80 for all 256 × 256 pairs."""
    table = rs.decode_table()
    assert table.shape == (256 * rs.HALF_ROW + 256,) and table.dtype == np.uint8
    mul = jax_gf256.mul_table()
    h = table[:TABLE].reshape(256, rs.HALF_ROW)
    hi = table[TABLE:]
    assert np.array_equal(h, mul[:, :rs.HALF_ROW])
    assert np.array_equal(hi, mul[:, 0x80])
    c = np.arange(256)[:, None]
    y = np.arange(256)[None, :]
    assert np.array_equal(h[c, y & 0x7F] ^ np.where(y >= 128, hi[c], 0), mul)


def test_emulated_multiplies_match_gf256_for_every_pair():
    """The kernel's word multiplies, emulated on all 256 × 256 (constant,
    byte) pairs in every byte position: gf_mac4 (with and without an
    accumulator), the dist 2 and dist 1 forms, and the per-position form."""
    table = rs.decode_table()
    hi = table[TABLE:]
    mul = gf256.mul_table().astype(U32)
    y = np.arange(256, dtype=U32)
    for c in range(256):
        tw = _twiddle(c, hi)
        want = mul[c]
        words = y * U32(0x01010101)
        zero = np.zeros_like(words)
        assert np.array_equal(_gf_mac4(zero, words, tw, table), want * U32(0x01010101))
        assert np.array_equal(_gf_mac4(words, words, tw, table),
                              words ^ (want * U32(0x01010101)))
        assert np.array_equal(_gf_mac_hi(zero, words, tw, table), want * U32(0x0101))
        assert np.array_equal(_gf_mac_odd(zero, words, tw, tw, table), want * U32(0x010001))
        col = np.full((256, 1), c, dtype=U32)
        base, cw = _stage_item(np.repeat(col, 4, axis=1), hi, 4)
        assert np.array_equal(_gf_mul_pos(words[:, None], 0, 4, base[0], cw[0], table)[:, 0],
                              want * U32(0x01010101))


def test_decode_bit_matrix_and_bitmul_match_jax():
    for n in (2, 8, 32):
        assert np.array_equal(rs.decode_bit_matrix(n), repair_tpu.decode_bit_matrix(n))
    assert np.array_equal(rs.bitmul_table(), repair_tpu._bitmul_table())


def test_decode_operands_built_once_per_n_and_device():
    a = rs.decode_operands(32, CPU)
    assert rs.decode_operands(32, torch.device("cpu")) is a
    assert a.n == 32 and rs.decode_operands(64, CPU).n == 64
    assert rs.decode_operands(64, CPU).table is a.table  # one table for every n
    assert np.array_equal(a.table.numpy(), rs.decode_table())
    assert a.twiddles is rs.decode_twiddles(32)


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_decode_twiddles_are_the_entries_of_the_program_constants(n):
    """Each group's kernel parameter is its twiddle constant's row-pair
    offset, bit 0 and high-bit product (the emulation's ``_twiddle``)."""
    entries = rs.decode_twiddles(n)
    assert entries.dtype == np.uint32 and entries.shape == (2 * (n - 1), 3)
    hi = rs.decode_table()[TABLE:]
    want = [_twiddle(int(c), hi) for c in rs.decode_program(n)]
    assert [tuple(e) for e in entries.tolist()] == [tuple(int(v) for v in w) for w in want]
    assert rs.decode_bits(8, CPU) is rs.decode_bits(8, torch.device("cpu"))


def _plan_fields(plan):
    return plan.transpose, plan.scale_bytes, plan.unscale_bytes, plan.write


@pytest.mark.parametrize("k", SMALL_K)
def test_plan_sweeps_matches_jax_field_by_field(k):
    masks = patterns(k, np.random.default_rng(30 + k))
    for present in masks:
        ours = repair.plan_sweeps(present, k)
        theirs = repair_tpu.plan_sweeps(present, k)
        assert len(ours) == len(theirs) >= 1
        for a, b in zip(ours, theirs):
            for x, y in zip(_plan_fields(a), _plan_fields(b)):
                assert np.array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype
    if k >= 2:  # the multi-sweep mask plans a row and a column sweep
        assert [p.transpose for p in repair.plan_sweeps(masks[2], k)] == [False, True]


def test_plan_sweeps_refuses_an_unrepairable_mask():
    present = np.zeros((4, 4), dtype=bool)
    present[0, 0] = True
    with pytest.raises(UnrepairableError, match="impossible to recover"):
        repair.plan_sweeps(present, 2)
    with pytest.raises(jax_da_repair.UnrepairableError):
        repair_tpu.plan_sweeps(present, 2)


# ---------------------------------------------------------------------- #
# the kernel's program, emulated


def _prmt(a, b, sel: int):
    """PTX ``prmt.b32`` (default mode) on uint32 arrays: result byte i is
    byte ``(sel >> 4i) & 7`` of b‖a (bytes 0-3 from a, 4-7 from b), or,
    where bit 3 of that nibble is set, that byte's bit 7 replicated."""
    a, b = np.broadcast_arrays(np.asarray(a, dtype=U32), np.asarray(b, dtype=U32))
    src = [(a >> U32(8 * j)) & U32(0xFF) for j in range(4)]
    src += [(b >> U32(8 * j)) & U32(0xFF) for j in range(4)]
    out = np.zeros(a.shape, dtype=U32)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        v = src[nib & 7]
        if nib & 8:
            v = np.where(v & U32(0x80), U32(0xFF), U32(0))
        out |= v << U32(8 * i)
    return out


def _twiddle(c: int, hi: np.ndarray) -> tuple:
    """The kernel's entry of a multiply by c: the row pair's offset, bit 0
    of c in bit 7 of every byte, c·0x80 in every byte."""
    return U32((c >> 1) << 8), U32(0x80808080 if c & 1 else 0), U32(int(hi[c]) * 0x01010101)


def _low7(y, cbits):
    return (y & U32(0x7F7F7F7F)) | cbits


def _gf_mac4(x, y, tw, smem):
    """x ^ c·y, one constant for the 4 bytes of y."""
    base, cbits, hi = tw
    m = _low7(y, cbits)
    p = [smem[_prmt(m, base, sel)].astype(U32) for sel in (0x7650, 0x7651, 0x7652, 0x7653)]
    acc = x ^ _prmt(p[0], p[1], 0x1140) ^ _prmt(p[2], p[3], 0x4011)
    return acc ^ (_prmt(y, 0, 0xBA98) & hi)


def _gf_mac_hi(x, y, tw, smem):
    """x ^ c·(bytes 2, 3 of y), the product in bytes 0, 1."""
    base, cbits, hi = tw
    m = _low7(y, cbits)
    p2 = smem[_prmt(m, base, 0x7652)].astype(U32)
    p3 = smem[_prmt(m, base, 0x7653)].astype(U32)
    return (x ^ _prmt(p2, p3, 0x1140)) ^ (_prmt(y, 0, 0x44BA) & hi)


def _gf_mac_odd(x, y, ta, tb, smem):
    """x ^ (a·byte 1 of y in byte 0, b·byte 3 in byte 2)."""
    p1 = smem[_prmt(_low7(y, ta[1]), ta[0], 0x7651)].astype(U32)
    p3 = smem[_prmt(_low7(y, tb[1]), tb[0], 0x7653)].astype(U32)
    hi = (ta[2] & U32(0x0000FFFF)) | (tb[2] & U32(0xFFFF0000))
    return (x ^ _prmt(p1, p3, 0x5410)) ^ (_prmt(y, 0, 0x4B49) & hi)


def _gf_mul_pos(y, j: int, n: int, base4, cw, smem):
    """The scale or unscale multiply of word j: byte b times position
    4j + b's constant (per axis: base4 and cw are (A, 1) columns)."""
    m = _low7(y, cw[0])
    p = [smem[_prmt(m, base4[i], 0x7650 + i)].astype(U32) if 4 * j + i < n
         else np.zeros(y.shape, dtype=U32) for i in range(4)]
    return _prmt(p[0], p[1], 0x1140) ^ _prmt(p[2], p[3], 0x4011) ^ (_prmt(y, 0, 0xBA98) & cw[1])


def _derivative(w, lo: int, m: int) -> None:
    """The kernel's recursion: the first half's steps, step lo + m/2,
    then the second half's (steps in ascending order)."""
    if m < 2:
        return
    _derivative(w, lo, m // 2)
    if m == 2:  # byte lo % 4 ^= byte lo % 4 + 1
        w[lo // 4] ^= (w[lo // 4] >> U32(8)) & U32(0x00FF0000 if lo % 4 else 0x000000FF)
    elif m == 4:  # bytes 0, 1 ^= bytes 2, 3
        w[lo // 4] ^= w[lo // 4] >> U32(16)
    else:
        for i in range(m // 8):
            w[lo // 4 + i] ^= w[(lo + m // 2) // 4 + i]
    _derivative(w, lo + m // 2, m // 2)


def _stage_item(c: np.ndarray, hi: np.ndarray, n: int):
    """A work item's staged constants of one (A, n) constant plane: each
    position's row offset (padded to whole words) and each word's bit-7
    bits and high-bit products, as (A, 1) columns."""
    words = max(n // 4, 1)
    pad = np.zeros((c.shape[0], 4 * words), dtype=U32)
    pad[:, :n] = c
    base = (pad >> U32(1)) << U32(8)
    cbits = np.zeros((c.shape[0], words), dtype=U32)
    his = np.zeros((c.shape[0], words), dtype=U32)
    for p in range(n):
        cbits[:, p // 4] |= (pad[:, p] & U32(1)) << U32(8 * (p % 4) + 7)
        his[:, p // 4] |= hi[pad[:, p]].astype(U32) << U32(8 * (p % 4))
    return ([[base[:, 4 * j + i, None] for i in range(4)] for j in range(words)],
            [(cbits[:, j, None], his[:, j, None]) for j in range(words)])


def _kernel_sweep(buf: np.ndarray, axis_stride: int, cell_stride: int, consts: np.ndarray,
                  ops: rs.DecodeOperands) -> None:
    """One decode sweep as the kernel runs it, in place in the flat byte
    buffer ``buf``: axis a, cell c, lane l at a·axis_stride + c·cell_stride
    + l. Every axis with a marked cell is two work items of 256 threads,
    one byte lane a thread; the axes and the 512 lanes are the vector axes.
    Byte b of state word j is position 4j + b."""
    n = ops.n
    k = n // 2
    smem = ops.table.numpy()  # H, then the high-bit products
    hi = smem[TABLE:]
    grp = [tuple(U32(v) for v in e) for e in ops.twiddles]  # the kernel's parameters
    blocks = np.flatnonzero(consts[2].any(axis=1))  # the others load nothing
    if not len(blocks):
        return
    lane = (blocks[:, None] * axis_stride + np.arange(LANES)[None, :]).astype(np.int64)
    sbase, sword = _stage_item(consts[0, blocks].astype(U32), hi, n)
    ubase, uword = _stage_item(consts[1, blocks].astype(U32), hi, n)
    words = max(n // 4, 1)
    wflag = np.zeros((len(blocks), words), dtype=U32)
    for p in range(n):  # the write flags in position order
        wflag[:, p // 4] |= (consts[2, blocks, (p + k) % n] != 0).astype(U32) << U32(8 * (p % 4))

    def cell(p: int) -> int:
        return (p + k) % n

    def pack(b):
        return _prmt(_prmt(b[0], b[1], 0x0040), _prmt(b[2], b[3], 0x0040), 0x5410)

    def positions(j: int) -> range:
        return range(4 * j, min(4 * j + 4, n))

    zeros = np.zeros(lane.shape, dtype=U32)
    w = []
    for j in range(words):
        b = [zeros] * 4
        for p in positions(j):
            b[p - 4 * j] = buf[lane + cell(p) * cell_stride].astype(U32)
        w.append(pack(b))
    w = [_gf_mul_pos(w[j], j, n, sbase[j], sword[j], smem) for j in range(words)]

    zero_tw = (U32(0), U32(0), U32(0))

    def odd_twiddle(g: int):
        return zero_tw if n < 4 else grp[g]

    g = 0
    dist = 1
    while dist < n:  # IFFT: y ^= x, then x ^= c * y
        if dist == 1:
            for j in range(words):
                w[j] ^= (w[j] << U32(8)) & U32(0xFF00FF00)
                w[j] = _gf_mac_odd(w[j], w[j], grp[g + 2 * j], odd_twiddle(g + 2 * j + 1), smem)
            g += n // 2
        elif dist == 2:
            for j in range(words):
                w[j] ^= w[j] << U32(16)
                w[j] = _gf_mac_hi(w[j], w[j], grp[g + j], smem)
            g += n // 4
        else:
            half = dist // 4
            for j in range(n // (2 * dist)):
                r, tw = 2 * half * j, grp[g]
                g += 1
                for i in range(half):
                    w[r + half + i] ^= w[r + i]
                if dist < BRANCH_DIST or tw[2] != 0:
                    for i in range(half):
                        w[r + i] = _gf_mac4(w[r + i], w[r + half + i], tw, smem)
        dist *= 2
    _derivative(w, 0, n)
    dist = n >> 1
    while dist >= 1:  # FFT: x ^= c * y, then y ^= x
        if dist == 1:
            for j in range(words):
                w[j] = _gf_mac_odd(w[j], w[j], grp[g + 2 * j], odd_twiddle(g + 2 * j + 1), smem)
                w[j] ^= (w[j] << U32(8)) & U32(0xFF00FF00)
            g += n // 2
        elif dist == 2:
            for j in range(words):
                w[j] = _gf_mac_hi(w[j], w[j], grp[g + j], smem)
                w[j] ^= w[j] << U32(16)
            g += n // 4
        else:
            half = dist // 4
            for j in range(n // (2 * dist)):
                r, tw = 2 * half * j, grp[g]
                g += 1
                if dist < BRANCH_DIST or tw[2] != 0:
                    for i in range(half):
                        w[r + i] = _gf_mac4(w[r + i], w[r + half + i], tw, smem)
                for i in range(half):
                    w[r + half + i] ^= w[r + i]
        dist >>= 1
    assert g == len(grp)
    for j in range(words):
        u = _gf_mul_pos(w[j], j, n, ubase[j], uword[j], smem)
        for p in positions(j):
            i = p - 4 * j
            marked = ((wflag[:, j] >> U32(8 * i)) & U32(0xFF)) != 0
            if marked.any():
                v = (u[marked] >> U32(8 * i)) & U32(0xFF)
                buf[lane[marked] + cell(p) * cell_stride] = v.astype(np.uint8)


def _emulated_sweep(eds: np.ndarray, plan: repair.SweepPlan) -> np.ndarray:
    """The kernel's sweep on a copy of a (2k, 2k, 512) square, with the
    strides the wrapper passes (rows: (2k·512, 512); columns the other
    way round) on the square's own bytes: no transposed copy."""
    w = eds.shape[0]
    consts = np.stack([plan.scale_bytes, plan.unscale_bytes, plan.write.astype(np.uint8)])
    strides = (SHARE_SIZE, w * SHARE_SIZE) if plan.transpose else (w * SHARE_SIZE, SHARE_SIZE)
    buf = eds.copy().reshape(-1)
    _kernel_sweep(buf, *strides, consts, rs.decode_operands(w, CPU))
    return buf.reshape(eds.shape)


def _jax_sweeps(cleared: np.ndarray, plans, k: int) -> list[np.ndarray]:
    """Every sweep of the JAX package's device repair, one at a time."""
    t2, bitmul = repair_tpu._resident_constants(2 * k)
    step = repair_tpu._jitted_sweep(k, SHARE_SIZE, 1)
    out, outs = jnp.asarray(cleared), []
    for p in plans:
        out = step(out, jnp.asarray(p.scale_bytes), jnp.asarray(p.unscale_bytes),
                   jnp.asarray(p.write), t2, bitmul, transpose=p.transpose)
        outs.append(np.asarray(out))
    return outs


@pytest.mark.parametrize("k", SMALL_K)
def test_emulated_kernel_matches_every_jax_sweep(k):
    eds = jax_eds(k, 20 + k)
    for present in patterns(k, np.random.default_rng(30 + k)):
        plans = repair.plan_sweeps(present, k)
        state = np.where(present[..., None], eds, 0).astype(np.uint8)
        for plan, want in zip(plans, _jax_sweeps(state, plans, k)):
            state = _emulated_sweep(state, plan)
            assert np.array_equal(state, want), (k, plan.transpose)
        assert np.array_equal(state, eds)


@pytest.mark.parametrize("k", SMALL_K)
@pytest.mark.parametrize("transpose", [False, True])
def test_emulated_kernel_matches_leopard_decode_batch(k, transpose):
    """Every row decodable: one row sweep equals JAX's batched Leopard
    decode of the rows, garbage in the erased cells included. The column
    form runs the same plan as a column sweep on the transposed square,
    through the column strides."""
    eds = jax_eds(k, 40 + k)
    rng = np.random.default_rng(50 + k)
    present = axis_masks(k, 2 * k, rng)
    present[0] = True  # a fully present axis: the kernel skips it
    src = np.where(present[..., None], eds, 0xCD).astype(np.uint8)
    plan = repair.plan_sweeps(present, k)[0]
    assert not plan.transpose
    want = jax_gf256.leopard_decode_batch(src[1:], present[1:], k)
    if transpose:
        plan = repair.SweepPlan(True, plan.scale_bytes, plan.unscale_bytes, plan.write)
        got = _emulated_sweep(np.ascontiguousarray(src.transpose(1, 0, 2)), plan)
        got = got.transpose(1, 0, 2)
    else:
        got = _emulated_sweep(src, plan)
    assert np.array_equal(got[1:], want)
    assert np.array_equal(got, eds)


def test_emulated_kernel_leaves_unmarked_cells_alone():
    k = 4
    eds = jax_eds(k, 7)
    present = np.ones((8, 8), dtype=bool)
    present[2, :] = False  # row 2 is not decodable in the row sweep
    present[5, 1] = False
    src = np.where(present[..., None], eds, 0xAB).astype(np.uint8)
    plan = repair.plan_sweeps(present, k)[0]
    got = _emulated_sweep(src, plan)
    assert np.array_equal(got[2], src[2])  # garbage stays where nothing is written
    assert np.array_equal(got[5], eds[5])
    assert np.array_equal(np.delete(got, [2, 5], axis=0), np.delete(src, [2, 5], axis=0))


# ---------------------------------------------------------------------- #
# the wrapper and its plain version


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sweep_on_a_cpu_tensor_is_the_plain_version_and_the_jax_sweep(k):
    eds = jax_eds(k, 60 + k)
    present = patterns(k, np.random.default_rng(70 + k))[-1]
    plans = repair.plan_sweeps(present, k)
    cleared = np.where(present[..., None], eds, 0).astype(np.uint8)
    state = torch.from_numpy(cleared.copy())
    plain = torch.from_numpy(cleared.copy())
    for plan, want in zip(repair._stage_plans(plans, CPU), _jax_sweeps(cleared, plans, k)):
        repair_cuda.sweep(state, plan)
        repair_cuda.sweep_reference(plain, plan, chunks=2)
        assert np.array_equal(state.numpy(), want)
        assert np.array_equal(plain.numpy(), want)


def test_sweep_refuses_a_plan_of_another_size():
    eds = torch.zeros((8, 8, SHARE_SIZE), dtype=torch.uint8)
    bad = repair_cuda.StagedSweep(False, torch.zeros((3, 4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="consts"):
        repair_cuda.sweep(eds, bad)
    with pytest.raises(ValueError, match="eds"):
        repair_cuda.sweep(torch.zeros((8, 4, SHARE_SIZE), dtype=torch.uint8), bad)


# ---------------------------------------------------------------------- #
# the entries


@pytest.mark.parametrize("fill", [0, 0xCD])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_repair_device_matches_jax_repair_tpu_and_truth(k, fill):
    """``tests/test_repair.py``'s squares, masks and seeds; the erased
    cells hold zeros or garbage."""
    eds = jax_eds(k, 20 + k)
    for present in patterns(k, np.random.default_rng(30 + k)):
        src = np.where(present[..., None], eds, fill).astype(np.uint8)
        got = repair.repair_device(src, present, device="cpu")
        assert np.array_equal(got, repair_tpu.repair_tpu(src, present))
        assert np.array_equal(got, eds)
        host = da_repair.repair(src, present.copy(), device="cpu")
        assert np.array_equal(host, jax_da_repair.repair(src, present.copy()))
        assert np.array_equal(host, eds)


def test_repair_device_ignores_erased_garbage_like_jax():
    eds = jax_eds(4, 41)
    present = np.ones((8, 8), dtype=bool)
    present[0, :5] = False
    present[3, 2] = False
    corrupted = eds.copy()
    corrupted[~present] = 0xCD
    got = repair.repair_device(corrupted, present, device="cpu")
    assert np.array_equal(got, repair_tpu.repair_tpu(corrupted, present))
    assert np.array_equal(got, eds)
    assert np.array_equal(da_repair.repair(corrupted, present.copy(), device="cpu"), eds)


def test_unrepairable_in_every_entry():
    eds = jax_eds(2, 3)
    present = np.zeros((4, 4), dtype=bool)
    present[0, 0] = True
    with pytest.raises(UnrepairableError):
        repair.repair_device(eds, present, device="cpu")
    with pytest.raises(UnrepairableError):
        da_repair.repair(eds, present.copy(), device="cpu")
    with pytest.raises(jax_da_repair.UnrepairableError):
        repair_tpu.repair_tpu(eds, present)


def oracle_repair(shares, present, k):
    """``tests/test_repair.py``'s oracle on the port: the same sweep
    discipline as ``repair``, every axis solved by ``_solve_axis_dense``."""
    width = 2 * k
    eds = np.array(shares, dtype=np.uint8, copy=True)
    eds[~present] = 0
    present = present.copy()
    while not present.all():
        progress = False
        for transpose in (False, True):
            view = eds.transpose(1, 0, 2) if transpose else eds
            mask = present.T if transpose else present
            for i in range(width):
                if mask[i].all() or mask[i].sum() < k:
                    continue
                view[i] = da_repair._solve_axis_dense(view[i], mask[i], k)
                mask[i] = True
                progress = True
        if not progress:
            raise UnrepairableError("oracle: no axis can make progress")
    return eds


def _verdict(fn):
    try:
        return fn()
    except (UnrepairableError, jax_da_repair.UnrepairableError):
        return None


@pytest.mark.parametrize("k", [2, 4])
def test_boundary_fuzz_agrees_with_the_dense_oracle_and_jax(k):
    """``tests/test_repair.py``'s fuzz at the decodability boundary, same
    seeds: the host repair and repair_device against the dense oracle and
    the JAX package's verdicts; both verdicts occur."""
    eds = jax_eds(k, 80 + k)
    rng = np.random.default_rng(90 + k)
    width = 2 * k
    agreed_ok = agreed_fail = 0
    for trial in range(40):
        n_erase = int(rng.integers(k * k, 3 * k * k + 1))
        present = np.ones((width, width), dtype=bool)
        if trial % 2:
            flat = rng.choice(width * width, size=n_erase, replace=False)
            present.reshape(-1)[flat] = False
        else:
            rows = rng.choice(width, size=min(width, k + 1), replace=False)
            cols = rng.choice(width, size=min(width, k + 1), replace=False)
            for r in rows:
                present[r, rng.choice(width, size=k, replace=False)] = False
            for c in cols:
                present[rng.choice(width, size=k, replace=False), c] = False
        src = np.where(present[..., None], eds, 0).astype(np.uint8)
        want = _verdict(lambda: oracle_repair(src, present, k))
        results = [
            _verdict(lambda: da_repair.repair(src, present.copy(), device="cpu")),
            _verdict(lambda: repair.repair_device(src, present, device="cpu")),
            _verdict(lambda: jax_da_repair.repair(src, present.copy())),
        ]
        if want is None:
            assert all(r is None for r in results), trial
            agreed_fail += 1
        else:
            assert all(r is not None and np.array_equal(r, want) for r in results), trial
            assert np.array_equal(want, eds)
            agreed_ok += 1
    assert agreed_ok > 0 and agreed_fail > 0, (agreed_ok, agreed_fail)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_resident_repair_verified_matches_jax_on_the_extended_square(k):
    """The slice as a whole: the port's resident EDS from
    extend_roots_device_resident, erased under a mask, repaired and
    verified against its DAH roots; the JAX package on the same square."""
    sq = square(k, seed=110 + k)
    eds_t, rows, cols = extend.extend_roots_device_resident(sq, device="cpu")
    before = eds_t.clone()
    row_roots = [r.tobytes() for r in rows]
    col_roots = [c.tobytes() for c in cols]
    for present in patterns(k, np.random.default_rng(120 + k)):
        fixed = repair.repair_resident_verified(eds_t, present, row_roots, col_roots,
                                                device="cpu")
        assert torch.equal(fixed, eds_t) and fixed.data_ptr() != eds_t.data_ptr()
        j_eds, _jr, _jc = extend_tpu.extend_roots_device_resident(sq)
        theirs = repair_tpu.repair_resident_verified(j_eds, present, row_roots, col_roots)
        assert np.array_equal(fixed.numpy(), np.asarray(theirs))
        bad_rows = [bytes(90)] + row_roots[1:]
        for mod, source in ((repair, eds_t), (repair_tpu, j_eds)):
            kw = {"device": "cpu"} if mod is repair else {}
            with pytest.raises(ValueError, match="repaired row roots do not match DAH"):
                mod.repair_resident_verified(source, present, bad_rows, None, **kw)
            with pytest.raises(ValueError, match="repaired column roots do not match DAH"):
                mod.repair_resident_verified(source, present, None, bad_rows, **kw)
    assert torch.equal(eds_t, before)  # the caller's square is never written


def test_run_is_reinvocable_and_leaves_the_caller_alone():
    k = 4
    eds_t, _rows, _cols = extend.extend_roots_device_resident(square(k, seed=3), device="cpu")
    before = eds_t.clone()
    present = patterns(k, np.random.default_rng(5))[2]  # row and column sweeps
    run, n_sweeps = repair.stage_resident_repair(eds_t, present, device="cpu")
    first = run().clone()
    second = run()
    assert n_sweeps == 2
    assert torch.equal(first, second) and torch.equal(first, before)
    assert torch.equal(eds_t, before)


def test_repair_eds_on_device_and_host_backed_squares():
    k = 4
    sq = square(k, seed=9)
    resident = da.extend_shares(sq.reshape(-1, SHARE_SIZE), device="cpu")
    dah = da.new_data_availability_header(resident)
    truth = resident.data.copy()
    present = patterns(k, np.random.default_rng(13))[0]
    damaged = da.ExtendedDataSquare.from_device(
        torch.from_numpy(np.where(present[..., None], truth, 0).astype(np.uint8)), k)
    fixed = da_repair.repair_eds(damaged, present, dah.row_roots, dah.column_roots,
                                 device="cpu")
    assert fixed.device_data is not None and fixed._data is None
    assert np.array_equal(fixed.data, truth)
    host = da.ExtendedDataSquare(np.where(present[..., None], truth, 0).astype(np.uint8), k,
                                 device="cpu")
    fixed_host = da_repair.repair_eds(host, present, dah.row_roots, dah.column_roots,
                                      device="cpu")
    assert fixed_host.device_data is None and np.array_equal(fixed_host.data, truth)
    jax_fixed = jax_da_repair.repair_eds(jax_da.ExtendedDataSquare(host.data, k), present,
                                         dah.row_roots, dah.column_roots)
    assert np.array_equal(np.asarray(jax_fixed.data), truth)
    with pytest.raises(ValueError, match="row roots"):
        da_repair.repair_eds(host, present, [bytes(90)] * 8, None, device="cpu")
