"""K3's merkle form (``ops/merkle_cuda.py``, ``csrc/dah_merkle.cu``) on the
CPU, byte for byte against the JAX package and hashlib.

The plain version is held against the JAX package's ``merkle_root_pow2``
and a hashlib tree. ``_kernel_merkle`` is a numpy emulation of what the
kernel runs on the card: the roots staged in shared memory as they lie
(one pad word before them), one thread a leaf building its padded 2-block
message with the kernel's byte permutes, the node messages from the
children's digest words with its funnel shifts, level by level with the
kernel's thread-to-node map, and the upper levels through its
helper split (schedules expanded apart, then the rounds alone). Every
message, digest and root is compared with hashlib. On the card,
``chip_smoke.py`` holds the kernel itself against its plain version.
"""

import dataclasses
import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch.ops import extend, merkle_cuda, rs, sha256
from tests.test_torch_extend import jax_extend_and_root, square
from tests.test_torch_fft import _prmt

U32 = np.uint32
SMALL_K = [1, 2, 4, 8, 16]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _roots(b: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(b, n, 90), dtype=np.uint8)


def _hashlib_root(items: np.ndarray) -> bytes:
    nodes = [hashlib.sha256(b"\x00" + it.tobytes()).digest() for it in items]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(b"\x01" + nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


# ---------------------------------------------------------------------- #
# the plain version


@functools.lru_cache(maxsize=None)
def _jax_case(k: int) -> tuple[np.ndarray, np.ndarray]:
    """Three DAHs' roots at k and the JAX package's merkle roots of them
    (its merkle is per DAH, so the first b of them are the case B = b)."""
    roots = _roots(3, 4 * k, 10 * k)
    return roots, np.asarray(extend_tpu.merkle_root_pow2(jnp.asarray(roots)))


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("k", SMALL_K)
def test_plain_version_matches_jax_and_hashlib(k, b):
    roots, theirs = _jax_case(k)
    roots = roots[:b]
    ours = merkle_cuda.dah_merkle(torch.from_numpy(roots)).numpy()
    assert ours.shape == (b, 32) and ours.dtype == np.uint8
    assert np.array_equal(ours, theirs[:b])
    for i in range(b):
        assert ours[i].tobytes() == _hashlib_root(roots[i])


# ---------------------------------------------------------------------- #
# the kernel, emulated


def _rotr(x, n: int):
    return (x >> U32(n)) | (x << U32(32 - n))


def _expand_kw(w: list) -> list:
    """sha256.cuh expand_kw: K[t] + W[t] for t = 0..63."""
    w = list(w)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> U32(3))
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> U32(10))
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    return [wt + U32(sha256.K[t]) for t, wt in enumerate(w)]


def _compress_kw(st: list, kw: list) -> list:
    """sha256.cuh compress_kw: the 64 rounds over K + W."""
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + kw[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + s0 + maj, a, b, c, d + t1, e, f, g
    return [x + y for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def _init(count: int) -> list:
    return [np.full(count, h, dtype=U32) for h in sha256.H0]


def _funnel8(lo, hi):
    """``__funnelshift_r(lo, hi, 8)``: (hi:lo) >> 8, the low word."""
    return (hi << U32(24)) | (lo >> U32(8))


def _leaf_blocks(area: np.ndarray, n: int) -> list[list]:
    """Both padded blocks of every leaf message, as thread t builds leaf t:
    message byte 0 at area byte 90t + 3, one byte permute a word."""
    t = np.arange(n)
    o = 90 * t + 3
    a = o >> 2
    words = []
    for j in range(23):
        w3 = _prmt(area[a + j], area[a + j + 1], 0x3456)
        w1 = _prmt(area[a + j], area[a + j + 1], 0x1234)
        words.append(np.where((o & 3) == 3, w3, w1).astype(U32))
    words[0] &= U32(0x00FFFFFF)  # the 0x00 leaf prefix
    words[22] = (words[22] & U32(0xFFFFFF00)) | U32(0x80)  # then the padding
    zeros = np.zeros(n, dtype=U32)
    tail = [zeros] * 8 + [np.full(n, 91 * 8, dtype=U32)]
    return [words[:16], words[16:] + tail]


def _node_blocks(l: list, r: list) -> list[list]:
    """Both padded blocks of the node messages 0x01 ‖ l ‖ r (digest words)."""
    count = len(l[0])
    b0 = [U32(0x01000000) | (l[0] >> U32(8))]
    b0 += [_funnel8(l[j], l[j - 1]) for j in range(1, 8)]
    b0 += [_funnel8(r[0], l[7])] + [_funnel8(r[j - 8], r[j - 9]) for j in range(9, 16)]
    zeros = np.zeros(count, dtype=U32)
    b1 = [(r[7] << U32(24)) | U32(0x00800000)] + [zeros] * 14 + [np.full(count, 65 * 8,
                                                                          dtype=U32)]
    return [b0, b1]


def _bytes(words: list) -> list[bytes]:
    """Big-endian bytes of each thread's words."""
    arr = np.stack(words, axis=1).astype(">u4")
    return [row.tobytes() for row in arr]


def _hash_level(blocks: list) -> list:
    """One level's digests: each thread's two blocks, schedule then rounds
    (the helped levels' split; unhelped, the same arithmetic)."""
    st = _init(len(blocks[0][0]))
    for blk in blocks:
        st = _compress_kw(st, _expand_kw(blk))
    return st


def _reduce(st: list, levels: list) -> list:
    """The kernel's reduce: thread t hashes nodes 2t and 2t + 1, level by
    level up to one node; each level's (blocks, digests) into ``levels``."""
    while len(st[0]) > 1:
        blocks = _node_blocks([s[0::2] for s in st], [s[1::2] for s in st])
        st = _hash_level(blocks)
        levels.append((blocks, st))
    return st


def _kernel_merkle(roots: np.ndarray) -> tuple[np.ndarray, list]:
    """One DAH's root as the kernel computes it: C = cluster_size(n) blocks
    of n / C leaves, each staging its roots (a pad word before them) and
    reducing them to a subtree root, then block 0 gathering the C roots and
    reducing them. Returns the root and, per block and then for block 0's
    last levels, every level's (blocks, digests), leaves first."""
    n = roots.shape[0]
    c = merkle_cuda.cluster_size(n)
    per = n // c
    trees, subroots = [], []
    for rank in range(c):
        area = np.zeros(per * 90 // 4 + 2, dtype=U32)
        area[1:-1] = np.frombuffer(roots[rank * per:(rank + 1) * per].tobytes(), dtype="<u4")
        blocks = _leaf_blocks(area, per)
        levels = [(blocks, _hash_level(blocks))]
        subroots.append(_reduce(levels[0][1], levels))
        trees.append(levels)
    gathered = [np.concatenate([r[j] for r in subroots]) for j in range(8)]
    top = []
    st = _reduce(gathered, top)
    root = np.concatenate([np.asarray(s, dtype=">u4").view(np.uint8) for s in st])
    return root, trees, top


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_emulated_kernel_matches_hashlib(k):
    n = 4 * k
    roots = _roots(2, n, 200 + k)
    c = merkle_cuda.cluster_size(n)
    assert c == min(8, max(1, n // 64)) and n // c >= 4
    for dah in roots:
        root, trees, top = _kernel_merkle(dah)
        assert root.tobytes() == _hashlib_root(dah)
        per = n // c
        for rank, levels in enumerate(trees):  # every padded message and digest
            msgs = [b"\x00" + r.tobytes() for r in dah[rank * per:(rank + 1) * per]]
            for blocks, st in levels:
                digests = _check_level(blocks, st, msgs)
                msgs = [b"\x01" + digests[i] + digests[i + 1]
                        for i in range(0, len(digests) - 1, 2)]
            assert digests[0] == _hashlib_root(dah[rank * per:(rank + 1) * per])
        assert len(top) == c.bit_length() - 1
    ours = merkle_cuda.dah_merkle_reference(torch.from_numpy(roots)).numpy()
    assert all(ours[i].tobytes() == _kernel_merkle(roots[i])[0].tobytes() for i in range(2))


def _check_level(blocks: list, st: list, msgs: list[bytes]) -> list[bytes]:
    """Each thread's two blocks are its message, padded; its digest is the
    message's SHA-256. Returns the digests."""
    padded = [a + b for a, b in zip(_bytes(blocks[0]), _bytes(blocks[1]))]
    digests = _bytes(st)
    assert len(padded) == len(msgs)
    for m, p, d in zip(msgs, padded, digests):
        assert p == m + sha256.pad_tail(len(m)).tobytes()
        assert d == hashlib.sha256(m).digest()
    return digests


# ---------------------------------------------------------------------- #
# the wrapper and the callers


def test_wrapper_runs_the_plain_version_on_a_cpu_tensor():
    roots = torch.from_numpy(_roots(2, 8, 1))
    assert torch.equal(merkle_cuda.dah_merkle(roots), merkle_cuda.dah_merkle_reference(roots))


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 8, 90), dtype=torch.int16),  # dtype
    torch.zeros((1, 8, 89), dtype=torch.uint8),  # root size
    torch.zeros((8, 90), dtype=torch.uint8),  # no batch axis
    torch.zeros((0, 8, 90), dtype=torch.uint8),  # no DAH
    torch.zeros((1, 12, 90), dtype=torch.uint8),  # not a power of two
    torch.zeros((1, 2, 90), dtype=torch.uint8),  # fewer than 4k at k = 1
    torch.zeros((1, 1024, 90), dtype=torch.uint8),  # more than 4k at k = 128
])
def test_wrapper_refuses_malformed_roots(bad):
    with pytest.raises(ValueError, match="roots"):
        merkle_cuda.dah_merkle(bad)
    with pytest.raises(ValueError, match="roots"):
        merkle_cuda.dah_merkle_reference(bad)


@pytest.mark.parametrize("k", SMALL_K)
def test_extend_and_root_device_gives_the_jax_dah(k):
    _eds, rows, cols, dah = extend.extend_and_root_device(square(k), device="cpu")
    j_dah = jax_extend_and_root(k, 0)[3]
    assert np.array_equal(dah, j_dah)
    assert dah.tobytes() == _hashlib_root(np.concatenate([rows, cols]))


def test_batched_extend_and_root_is_one_merkle_call():
    calls = []

    def counted(roots):
        calls.append(tuple(roots.shape))
        return merkle_cuda.dah_merkle(roots)

    kernels = dataclasses.replace(extend.KERNELS, dah_merkle=counted)
    squares = torch.from_numpy(np.stack([square(2, seed=s) for s in (1, 2, 3)]))
    m2 = rs.encode_matrix(2, torch.device("cpu"))
    eds, rows, cols, dah = extend.extend_and_root_batched(squares, m2, kernels)
    assert calls == [(3, 8, 90)]
    for i in range(3):
        one = extend.extend_and_root(squares[i], m2)
        assert all(torch.equal(a, b[i]) for a, b in zip(one, (eds, rows, cols, dah)))
