"""The layout K5 and K6 run (``xor_cuda.XorLayout``), emulated in numpy.

``emulate`` runs ``csrc/xor_schedule.cu``'s steps over the layout that
``operands_from_schedule`` builds: the same slots, 32-bit words and bit
swaps, each group's program (its node entries level by level, its row
warps' 16-bit slot vectors, its row-thread words), the zero-plane padding,
the row buffer and the pack. Its parity must be byte-equal to the JAX
package's Pallas kernel in interpret mode, and its quarter-fed leaf hash
(``leaf_digest_quarter``'s message blocks as K5's hash warp builds them from
the ring, compressed by the plain SHA) to the JAX package's fused
reference. Along the way it asserts the layout's
promise: every eight threads that share a wavefront (a quarter of a warp's
16-byte accesses) touch eight different bank groups at every step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import rs_pallas, rs_tpu
from celestia_tpu.ops import xor_schedule as jax_xs
from celestia_tpu_torch.ops import sha256_cuda, xor_cuda
from celestia_tpu_torch.ops import xor_schedule as xs

CHUNK = 128  # lanes a chunk: one 16-byte slot a plane
R = xor_cuda.RESIDUES
H = xor_cuda.HEADER
ENC = xor_cuda.ENC_THREADS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def bit_slice(w: np.ndarray) -> np.ndarray:
    """The kernel's bit_slice on (..., 8) uint32 words: three rounds of
    swaps between word pairs, its own inverse."""
    w = w.copy()
    for d, m, pairs in ((1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7))),
                        (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
                        (4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7)))):
        for a, b in pairs:
            t = ((w[..., a] >> d) ^ w[..., b]) & np.uint32(m)
            w[..., b] ^= t
            w[..., a] ^= t << np.uint32(d)
    return w


def assert_quarters_distinct(slots: np.ndarray, what: str) -> None:
    """slots (threads, ...) read or written together: each eight
    consecutive threads hit eight residues."""
    res = (slots.reshape(-1, R, *slots.shape[1:]) % R)
    assert (np.sort(res, axis=1) == np.arange(R).reshape(1, R, *([1] * (res.ndim - 2)))).all(), what


def _row_program(lay: xor_cuda.XorLayout, g: int):
    """(slots (threads, steps), steps per thread, rowbuf slot per thread):
    group g's row program, pairs unpacked."""
    pairs, words = lay.row_program(g)
    pairs, words = pairs.T.astype(np.int64), words.astype(np.int64)
    slots = np.stack([pairs & 0xFFFF, pairs >> 16], axis=2).reshape(ENC, -1)
    return slots, 2 * (words >> 16), words & 0xFFFF


def emulate(x2: np.ndarray, lay: xor_cuda.XorLayout) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' parity of x2 (k, N), and each chunk's parity as K5's
    hash warp reads it from the ring: (k, N/128, 32) little-endian words."""
    k, n = x2.shape
    spc = lay.shards_per_group
    chunks = n // CHUNK
    # the bit-slice: thread (s, w) turns 32 bytes of shard s into word w of
    # its 8 planes; all chunks side by side (word 4c + w of a slot)
    words = np.ascontiguousarray(x2).view("<u4").reshape(k, chunks, 4, 8)
    sliced = bit_slice(words)  # [s, c, w, b]
    parity = np.zeros((k, n), np.uint8)
    for g in range(lay.groups):
        prog = lay.prog[g]
        planes = np.zeros((lay.n_slots, 4 * chunks), np.uint32)
        for s in range(k):
            for b in range(8):
                planes[8 * s + ((b + s) & 7)] = sliced[s, :, :, b].reshape(-1)
        for lv in range(lay.n_levels):
            count, off = prog[H + lv], prog[H + lay.n_levels + lv]
            e = prog[off: off + 2 * count].reshape(-1, 2).astype(np.int64)
            a, b, dest = e[:, 0] & 0xFFFF, e[:, 0] >> 16, e[:, 1]
            assert count % R == 0 and off + 2 * count <= prog[4]
            for what, sl in (("node a", a), ("node b", b), ("node result", dest)):
                assert_quarters_distinct(sl, f"k={k} group {g} level {lv}: {what}")
            assert (dest >= 8 * k + R).all()
            planes[dest] = planes[a] ^ planes[b]
        slots, steps, dest = _row_program(lay, g)
        assert steps.max() <= 2 * xor_cuda.MAX_PAIRS
        for w0 in range(0, ENC, 32):
            n_steps = steps[w0]
            assert (steps[w0: w0 + 32] == n_steps).all() and n_steps % 8 == 0  # one count a warp
            assert_quarters_distinct(dest[w0: w0 + 32], f"k={k} group {g}: rowbuf stores")
            if n_steps:
                assert_quarters_distinct(slots[w0: w0 + 32, :n_steps],
                                         f"k={k} group {g} warp {w0 // 32}")
        rowbuf = np.zeros((lay.rowbuf_slots, 4 * chunks), np.uint32)
        for t in range(ENC):
            rowbuf[dest[t]] = np.bitwise_xor.reduce(planes[slots[t, : steps[t]]], axis=0) \
                if steps[t] else 0
        # pack: thread (s, w) XORs the segments of its shard's 8 rows
        rows = np.zeros((spc, 8, 4 * chunks), np.uint32)
        for s in range(spc):
            for b in range(8):
                for seg in range(lay.segs):
                    rows[s, b] ^= rowbuf[seg * 8 * spc + 8 * s + ((b + s) & 7)]
        out = bit_slice(rows.reshape(spc, 8, chunks, 4).transpose(0, 2, 3, 1))  # [s, c, w, j]
        parity[g * spc: (g + 1) * spc] = out.reshape(spc, -1).view(np.uint8).reshape(spc, n)
    return parity, parity.view("<u4").reshape(k, chunks, 32)


def byte_perm(x: int, y: int, sel: int) -> int:
    src = x | (y << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def cell_word(lo: int, hi: int) -> int:
    return byte_perm(lo, hi, 0x2345)


def quarter_blocks(cw: list[int], carry: list[int], q: int) -> list[list[int]]:
    """The message blocks ``leaf_digest_quarter`` compresses for quarter q
    (cw: its 32 little-endian words; carry: words 24..31 of quarter q - 1)."""
    pre = [0x00FFFFFF] + [0xFFFFFFFF] * 6 + [0xFFFF0000]
    blocks = []
    for blk in range(3 if q == 3 else 2):
        if blk == 1:
            w = [cell_word(cw[8 + j], cw[9 + j]) for j in range(16)]
        elif blk == 2:
            w = [cell_word(cw[24 + j], cw[25 + j]) for j in range(7)]
            w += [cell_word(cw[31], 0x80)] + [0] * 7 + [542 * 8]
        elif q == 0:
            w = pre[:7] + [pre[7] | byte_perm(cw[0], 0, 0x4401)]
            w += [cell_word(cw[j], cw[j + 1]) for j in range(8)]
        else:
            w = [cell_word(carry[j], carry[j + 1]) for j in range(7)]
            w += [cell_word(carry[7], cw[0])] + [cell_word(cw[j], cw[j + 1]) for j in range(8)]
        blocks.append(w)
    return blocks


def emulate_digests(ring: np.ndarray) -> np.ndarray:
    """The hash warp: each cell (four chunks of a 512-lane column) fed a
    quarter at a time; (k, N/512, 8) digests by the plain compression."""
    k, chunks, _ = ring.shape
    msgs = []
    for s in range(k):
        for col in range(chunks // 4):
            carry, words = [0] * 8, []
            for q in range(4):
                cw = [int(v) for v in ring[s, 4 * col + q]]
                for blk in quarter_blocks(cw, carry, q):
                    words += blk
                carry = cw[24:]
            msgs.append(words)
    words = torch.from_numpy(np.array(msgs, np.int64).T.astype(np.uint32).view(np.int32))
    digests = sha256_cuda.sha_core_reference(words.view(torch.uint32))  # (8, cells)
    return digests.T.numpy().reshape(k, chunks // 4, 8)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_layout_emulation_matches_pallas_interpret(k):
    x2 = _bytes((k, k * 512), seed=700 + k)
    ops = xor_cuda.schedule_operands(k, "cpu")
    parity, ring = emulate(x2, ops.layout)
    if k == 1:  # no node: the Pallas XOR kernel has a (1, 0) block, which
        # interpret mode refuses; k = 1 parity is a copy, as the dense kernel says
        expect = rs_pallas.encode2d(jnp.asarray(x2), jnp.asarray(rs_tpu.encode_bit_matrix(k)),
                                    interpret=True)
    else:
        expect = jax_xs.encode2d_xor(jnp.asarray(x2), interpret=True)
    assert np.array_equal(parity, np.asarray(expect))
    ref_parity, ref_digests = jax_xs.encode2d_xor_hash_reference(x2, tile=k * 512)
    assert np.array_equal(parity, np.asarray(ref_parity))
    assert np.array_equal(emulate_digests(ring), np.asarray(ref_digests))


def test_layout_emulation_k64_matches_apply_planes():
    k = 64
    sched = xs.compile_schedule(k)
    lay = xor_cuda.schedule_operands(k, "cpu").layout
    assert lay.groups == 2 and lay.segs == 2
    x2 = _bytes((k, 4 * CHUNK), seed=764)  # four chunks: one cell column
    parity, _ring = emulate(x2, lay)
    bits = np.unpackbits(x2[:, None, :], axis=1, bitorder="little").reshape(8 * k, -1)
    expect = np.packbits(xs.apply_planes_np(bits, sched).reshape(k, 8, -1), axis=1,
                         bitorder="little").reshape(k, -1)
    assert np.array_equal(parity, expect)


def test_bit_slice_is_its_own_inverse_and_maps_lanes():
    """Word b, bit 8m + j of the sliced words is bit b of lane 4j + m."""
    lanes = _bytes((5, 32), seed=3)
    words = lanes.view("<u4").reshape(5, 8)
    planes = bit_slice(words)
    for b in range(8):
        for j in range(8):
            for m in range(4):
                assert np.array_equal((planes[:, b] >> (8 * m + j)) & 1,
                                      (lanes[:, 4 * j + m] >> b) & 1)
    assert np.array_equal(bit_slice(planes), words)


@pytest.mark.parametrize("k", [4, 16, 64])
def test_layout_reports_its_padding(k):
    """reads counts every real operand read once (two a node, a row's
    operands); padded_reads adds the zero-plane reads the conflict-free
    order needs, and they are what the programs hold."""
    sched = xs.compile_schedule(k)
    lay = xor_cuda.schedule_operands(k, "cpu").layout
    real = padded = 0
    for g in range(lay.groups):
        prog = lay.prog[g]
        real += 2 * int((lay.plane_slot[g][sched.n_in + 1:] >= 0).sum())
        padded += 2 * int(sum(prog[H + lv] for lv in range(lay.n_levels)))
        _slots, steps, _dest = _row_program(lay, g)
        padded += int(steps.sum())
    assert lay.reads == real + int((sched.row_idx != sched.zero).sum())
    assert lay.padded_reads == padded
    assert lay.reads <= lay.padded_reads
