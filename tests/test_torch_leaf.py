"""Kernel K2 (NMT leaf digests of existing cells), byte for byte against the
JAX package and hashlib.

The plain K2 (what ``rs_cuda.leaf_digests2d`` runs on a CPU tensor) is held
against ``rs_pallas.leaf_digests2d_reference`` at the shapes the main path
gives it on an EDS, (2k, 2k·512), with the extend's leaf-namespace rule and
with arbitrary namespaces, and at row counts that are no multiple of the
kernel's 64-thread block.

``_kernel_digests`` is a numpy emulation of what ``csrc/rs_hash.cu``
``leaf_digests2d_kernel`` runs on the card: one thread per cell of the flat
cell-major grid, the cell read as 32 16-byte loads in the kernel's program
order (block b + 1's loads written before block b's compression, clamped to
the last load), each big-endian message word put together with the kernel's
byte permutes, and the 9 compressions. It reads only the operands the
wrapper sends and is held against hashlib. Outputs are hashes: the
tolerance is exact equality.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import extend_tpu, rs_pallas
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.ops import extend, rs_cuda

CELL_VECS = SHARE_SIZE // 16  # 16-byte loads per cell (kCellVecs)
M32 = 0xFFFFFFFF
K256 = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2], dtype=np.uint64)
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _plain(x2: np.ndarray, ns_pad: np.ndarray) -> np.ndarray:
    out = rs_cuda.leaf_digests2d(torch.from_numpy(x2), torch.from_numpy(ns_pad))
    assert out.dtype == torch.uint32
    return out.numpy()


def _pallas(x2: np.ndarray, ns_pad: np.ndarray) -> np.ndarray:
    return np.asarray(rs_pallas.leaf_digests2d_reference(x2, ns_pad, tile=x2.shape[1]))


def _hashlib(x2: np.ndarray, ns_pad: np.ndarray) -> np.ndarray:
    """(R, N/512, 8) big-endian digest words of SHA-256(0x00 ‖ ns ‖ cell)."""
    r, n = x2.shape
    cells = x2.reshape(-1, SHARE_SIZE)
    ns = ns_pad.reshape(-1, rs_cuda.NS_PAD)[:, :NAMESPACE_SIZE]
    words = [np.frombuffer(hashlib.sha256(b"\x00" + a.tobytes() + c.tobytes()).digest(), ">u4")
             for a, c in zip(ns, cells)]
    return np.stack(words).astype(np.uint32).reshape(r, n // SHARE_SIZE, 8)


# ---- the kernel's own spelling, in numpy


def _prmt(a, b, sel: int):
    """CUDA's ``__byte_perm(a, b, sel)`` on uint32 arrays: result byte i is
    byte ``(sel >> 4i) & 7`` of b‖a (bytes 0-3 from a, 4-7 from b)."""
    a = np.asarray(a, dtype=np.uint32)
    b = np.broadcast_to(np.asarray(b, dtype=np.uint32), a.shape)
    src = [(a >> np.uint32(8 * j)) & 0xFF for j in range(4)]
    src += [(b >> np.uint32(8 * j)) & 0xFF for j in range(4)]
    out = np.zeros(a.shape, dtype=np.uint32)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _rotr(x, n: int):
    return ((x >> np.uint64(n)) | (x << np.uint64(32 - n))) & M32


def _compress(st: list, w: list) -> list:
    """One SHA-256 compression of 16 big-endian words per lane (uint64
    arrays holding 32-bit values)."""
    w = [np.asarray(x, dtype=np.uint64) for x in w]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> np.uint64(3))
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> np.uint64(10))
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & M32 & g)
        t1 = (h + s1 + ch + K256[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def _words(vecs) -> list:
    """The little-endian cell words of a list of 16-byte loads."""
    return [v[:, i] for v in vecs for i in range(4)]


def _kernel_digests(x2: np.ndarray, ns_pad: np.ndarray, loaded: list) -> np.ndarray:
    """(R, N/512, 8) digests as leaf_digests2d_kernel computes them; the
    16-byte load indices, in issue order, are appended to ``loaded``."""
    r, n = x2.shape
    cells = r * (n // SHARE_SIZE)  # the flat cell-major grid
    vec = np.ascontiguousarray(x2).view("<u4").reshape(cells, CELL_VECS, 4).astype(np.uint32)
    nsw = np.ascontiguousarray(ns_pad).view("<u4").reshape(cells, 8).astype(np.uint32)

    def ldg(q: int):
        assert 0 <= q < CELL_VECS, f"load {q} is outside the cell"
        loaded.append(q)
        return vec[:, q, :]

    def msg(words):
        return [np.asarray(x, dtype=np.uint32).astype(np.uint64) for x in words]

    v0, v1, carry = ldg(0), ldg(1), ldg(2)
    nxt = [ldg(3 + i) for i in range(4)]
    st = [np.full(cells, h, dtype=np.uint64) for h in H0]
    # block 0: leaf_prefix_from_ns, then cell words 0..8
    w, prev = [], np.zeros(cells, dtype=np.uint32)
    for j in range(8):
        w.append(_prmt(prev, nsw[:, j], 0x3456))
        prev = nsw[:, j]
    w[7] = (w[7] & np.uint32(0xFFFF0000)) | _prmt(v0[:, 0], 0, 0x4401)
    c = _words([v0, v1]) + [carry[:, 0]]
    w += [_prmt(c[j], c[j + 1], 0x2345) for j in range(8)]
    st = _compress(st, msg(w))
    for b in range(1, 8):
        win = [carry] + nxt
        nxt = [ldg(min(4 * b + 3 + i, CELL_VECS - 1)) for i in range(4)]
        carry = win[4]
        c = _words(win)
        st = _compress(st, msg(_prmt(c[j], c[j + 1], 0x2345) for j in range(16)))
    c = _words([carry, nxt[0]]) + [np.full(cells, 0x80, dtype=np.uint32)]
    w = [_prmt(c[j], c[j + 1], 0x2345) for j in range(8)]
    w += [np.zeros(cells, dtype=np.uint32)] * 7 + [np.full(cells, 542 * 8, dtype=np.uint32)]
    st = _compress(st, msg(w))
    return np.stack(st, axis=-1).astype(np.uint32).reshape(r, n // SHARE_SIZE, 8)


# ---- the tests


@pytest.mark.parametrize("ns_rule", ["extend", "arbitrary"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_leaf_digests2d_eds_plain_matches_pallas_reference(k, ns_rule):
    w = 2 * k
    eds = _bytes((w, w, SHARE_SIZE), seed=400 + k)
    if ns_rule == "extend":  # Q0's own namespaces, parity everywhere else
        q0_ns = eds[:k, :k, :NAMESPACE_SIZE]
        leaf_ns = extend._leaf_namespaces(torch.from_numpy(q0_ns), k).numpy()
        assert np.array_equal(leaf_ns, np.asarray(extend_tpu._leaf_namespaces(
            jnp.asarray(q0_ns), k)))
        ns_pad = rs_cuda.pad_namespaces(torch.from_numpy(leaf_ns)).numpy()
    else:
        ns_pad = _bytes((w, w, rs_cuda.NS_PAD), seed=500 + k)
    x2 = eds.reshape(w, w * SHARE_SIZE)
    ours = _plain(x2, ns_pad)
    assert ours.shape == (w, w, 8)
    assert np.array_equal(ours, _pallas(x2, ns_pad))


@pytest.mark.parametrize("rows", [1, 3, 65])
def test_leaf_digests2d_ragged_rows_plain_matches_pallas_reference(rows):
    x2 = _bytes((rows, 2 * SHARE_SIZE), seed=600 + rows)
    ns_pad = _bytes((rows, 2, rs_cuda.NS_PAD), seed=700 + rows)
    ours = _plain(x2, ns_pad)
    assert ours.shape == (rows, 2, 8)
    assert np.array_equal(ours, _pallas(x2, ns_pad))
    assert np.array_equal(ours, _hashlib(x2, ns_pad))


@pytest.mark.parametrize("rows,n", [(1, SHARE_SIZE), (3, 2 * SHARE_SIZE), (8, 8 * SHARE_SIZE)])
def test_kernel_word_stream_matches_hashlib(rows, n):
    x2 = _bytes((rows, n), seed=800 + rows)
    ns_pad = _bytes((rows, n // SHARE_SIZE, rs_cuda.NS_PAD), seed=900 + rows)
    loaded: list[int] = []
    got = _kernel_digests(x2, ns_pad, loaded)
    assert np.array_equal(got, _hashlib(x2, ns_pad))
    assert np.array_equal(got, _plain(x2, ns_pad))
    # every 16-byte piece of the cell is loaded, in order, and each block's
    # loads are written one block ahead: 7 up front, then 4 per block 1..7
    assert sorted(set(loaded)) == list(range(CELL_VECS))
    assert len(loaded) == 7 + 4 * 7 and loaded == sorted(loaded)


def test_kernel_word_stream_eds_namespace_rule():
    k = 4
    eds = _bytes((2 * k, 2 * k, SHARE_SIZE), seed=1000)
    leaf_ns = extend._leaf_namespaces(torch.from_numpy(eds[:k, :k, :NAMESPACE_SIZE]), k)
    ns_pad = rs_cuda.pad_namespaces(leaf_ns).numpy()
    x2 = eds.reshape(2 * k, 2 * k * SHARE_SIZE)
    got = _kernel_digests(x2, ns_pad, [])
    assert np.array_equal(got, _hashlib(x2, ns_pad))
    assert np.array_equal(got, _pallas(x2, ns_pad))


def test_leaf_digests2d_rejects_mismatched_namespaces():
    x2 = torch.zeros((3, 2 * SHARE_SIZE), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.leaf_digests2d(x2, torch.zeros((3, 1, rs_cuda.NS_PAD), dtype=torch.uint8))
