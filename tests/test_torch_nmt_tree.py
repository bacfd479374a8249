"""The NMT tree kernel (``nmt_cuda.nmt_tree``, ``csrc/nmt_tree.cu``):
leaf-digest grid -> row and column roots, and the row-tree levels, in one
launch. Outputs are hashes: the tolerance is exact equality throughout.

- ``nmt_tree_reference`` (what the wrapper runs on a CPU tensor) against
  ``extend_tpu._digest_grid_roots`` and ``extend_tpu.nmt_reduce_levels`` on
  the same numpy inputs: both families' roots, and the rows with their
  levels.
- The four-quadrant-tile input, strided views in place, against the
  assembled grid.
- The wrapper's contract: output shapes and dtypes, a CPU tensor runs the
  plain version without a launch, inputs the kernel does not take are
  refused.
- A numpy emulation of what the kernel runs on the card (``_kernel_tree``),
  held against hashlib and against the plain version. It follows the kernel
  block by block: the block size the host picks (``groups_for``), the
  word-plane node layout of shared memory, each leaf node built from its
  digest tile (read through the strides the wrapper sends) and its
  namespace words, the byte permutes that build the 48 message words of a
  node from children at message bytes 1 and 91, the pad and length words,
  the helper threads' K + W schedule on the upper levels, the namespace
  rule, the digest put back at node byte 58, and the 16-bit copy-out of the
  roots and the row levels.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import extend_tpu
from celestia_tpu_torch.appconsts import NAMESPACE_SIZE
from celestia_tpu_torch.ops import _cuda, nmt_cuda
from tests.test_torch_extend import CASES, PARITY, square
from tests.test_torch_leaf import H0, K256, _compress, _prmt, _rotr

NODE = nmt_cuda.NMT_NODE_SIZE
# the two calls the port makes: an extend's roots of both families, and
# eds_row_levels_device's rows with every level
MODES = {"both": False, "rows_levels": True}

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _digest_grid(k: int, seed: int) -> np.ndarray:
    """(2k, 2k, 8) uint32 leaf digest words, as K1/K2 emit them."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(2 * k, 2 * k, 8), dtype=np.uint64).astype(np.uint32)


def _quadrants(grid: torch.Tensor, k: int) -> tuple:
    return (grid[:k, :k], grid[:k, k:], grid[k:, :k], grid[k:, k:])


def _words_to_be_bytes(words: np.ndarray) -> np.ndarray:
    return words.astype(">u4").view(np.uint8).reshape(*words.shape[:-1], 4 * words.shape[-1])


@jax.jit
def _jax_roots_and_levels(digest_bytes, leaf_ns):
    """extend_tpu's two tree spellings, compiled as one graph (eager, each
    SHA-256 op would dispatch on its own)."""
    roots = extend_tpu._digest_grid_roots(digest_bytes, leaf_ns)
    leaves = jnp.concatenate([leaf_ns, leaf_ns, digest_bytes], axis=-1)
    return roots, extend_tpu.nmt_reduce_levels(leaves)


@functools.lru_cache(maxsize=None)
def _jax_tree(k: int, pad_tail: int):
    """The JAX package's roots and row levels of the case's inputs."""
    grid = _digest_grid(k, seed=3000 + k + pad_tail)
    q0_ns = square(k, pad_tail=pad_tail)[..., :NAMESPACE_SIZE]
    leaf_ns = extend_tpu._leaf_namespaces(jnp.asarray(q0_ns), k)
    (rows, cols), levels = _jax_roots_and_levels(jnp.asarray(_words_to_be_bytes(grid)), leaf_ns)
    return grid, q0_ns, np.asarray(rows), np.asarray(cols), [np.asarray(lv) for lv in levels]


# ---- the plain version against the JAX package


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k,pad_tail", CASES)
def test_reference_matches_jax(k, pad_tail, mode):
    grid, q0_ns, j_rows, j_cols, j_levels = _jax_tree(k, pad_tail)
    keep = MODES[mode]
    roots, levels = nmt_cuda.nmt_tree_reference(
        _quadrants(torch.from_numpy(grid), k), torch.from_numpy(q0_ns), keep_levels=keep)
    expect = [j_rows] if keep else [j_rows, j_cols]
    assert roots.dtype == torch.uint8 and tuple(roots.shape) == (len(expect), 2 * k, NODE)
    for got, want in zip(roots.numpy(), expect):
        assert np.array_equal(got, want)
    if keep:
        split = nmt_cuda.split_levels(levels.numpy(), k)
        assert len(split) == len(j_levels) == int(np.log2(2 * k)) + 1
        for got, want in zip(split, j_levels):
            assert np.array_equal(got, want)
    else:
        assert levels is None


@pytest.mark.parametrize("k", [2, 8])
def test_quadrant_tiles_in_place_match_the_assembled_grid(k):
    """The fused route's input: Q1 and Q3 as [col, row] tensors passed
    transposed, and the namespaces as a view of the shares."""
    grid = torch.from_numpy(_digest_grid(k, seed=77 + k))
    sq = torch.from_numpy(square(k, seed=5))
    d1t = grid[:k, k:].transpose(0, 1).contiguous()
    d3t = grid[k:, k:].transpose(0, 1).contiguous()
    tiles = (grid[:k, :k].contiguous(), d1t.transpose(0, 1), grid[k:, :k].contiguous(),
             d3t.transpose(0, 1))
    got, _ = nmt_cuda.nmt_tree(tiles, sq[..., :NAMESPACE_SIZE])
    want, _ = nmt_cuda.nmt_tree_reference(_quadrants(grid, k),
                                          sq[..., :NAMESPACE_SIZE].contiguous())
    assert torch.equal(got, want)


# ---- the wrapper's contract


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    k = 4
    grid = torch.from_numpy(_digest_grid(k, seed=1))
    q0_ns = torch.from_numpy(square(k)[..., :NAMESPACE_SIZE])
    before = _cuda.LAUNCHES["nmt_tree"]
    roots, levels = nmt_cuda.nmt_tree(_quadrants(grid, k), q0_ns, keep_levels=True)
    assert _cuda.LAUNCHES["nmt_tree"] == before
    ref_roots, ref_levels = nmt_cuda.nmt_tree_reference(_quadrants(grid, k), q0_ns,
                                                        keep_levels=True)
    assert torch.equal(roots, ref_roots) and torch.equal(levels, ref_levels)
    assert tuple(roots.shape) == (1, 2 * k, NODE)
    assert levels.dtype == torch.uint8 and levels.dim() == 1
    shapes = [tuple(lv.shape) for lv in nmt_cuda.split_levels(levels, k)]
    assert shapes == [(8, 8, NODE), (8, 4, NODE), (8, 2, NODE), (8, 1, NODE)]
    assert torch.equal(nmt_cuda.split_levels(levels, k)[-1][:, 0], roots[0])


@pytest.mark.parametrize("k", [3, 256])
def test_bad_k_raises(k):
    quads = (torch.zeros((k, k, 8), dtype=torch.uint32),) * 4
    with pytest.raises(ValueError):
        nmt_cuda.nmt_tree(quads, torch.zeros((k, k, NAMESPACE_SIZE), dtype=torch.uint8))


@pytest.mark.parametrize("bad", ["dtype", "shape", "namespace", "tiles", "k_mismatch"])
def test_refused_inputs_raise(bad):
    k = 2
    quads = [torch.zeros((k, k, 8), dtype=torch.uint32) for _ in range(4)]
    q0_ns = torch.zeros((k, k, NAMESPACE_SIZE), dtype=torch.uint8)
    kw = {}
    if bad == "dtype":
        quads[1] = quads[1].view(torch.int32)
    elif bad == "shape":
        quads[3] = torch.zeros((k, k, 4), dtype=torch.uint32)
    elif bad == "namespace":
        q0_ns = q0_ns[..., :NAMESPACE_SIZE - 1]
    elif bad == "tiles":
        quads = quads[:3]
    else:
        q0_ns = torch.zeros((2 * k, 2 * k, NAMESPACE_SIZE), dtype=torch.uint8)
    with pytest.raises(ValueError):
        nmt_cuda.nmt_tree(tuple(quads), q0_ns)


# ---- a numpy emulation of the kernel


WORDS, HALVES = 23, 45
ONES = 0xFFFFFFFF
HELP_NODES = 16  # kHelpNodes: levels of at most 16 nodes a group are helped


def _groups(total_leaves: int) -> int:
    """groups_for: 128-thread groups a block (1, 2 or 4), as many as keep
    at least 128 blocks."""
    groups = 1
    while groups < 4 and total_leaves // (256 * 2 * groups) >= 128:
        groups *= 2
    return groups


def _planes(groups: int) -> dict:
    """(half, pitch) of the two word-plane buffers of a block: 256·groups
    nodes (a) and 128·groups nodes (b); the odd half 16 banks on."""
    return {"a": (128 * groups + 16, 256 * groups + 17),
            "b": (64 * groups + 16, 128 * groups + 17)}


PLANES = _planes(1)


def _slot(n, half: int):
    """Word 0 of node n in a word-plane buffer."""
    n = np.asarray(n)
    return (n & 1) * half + (n >> 1)


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _put_digest(buf, base, pitch, x14, st):
    buf[base + 14 * pitch] = _prmt(x14, st[0], 0x6710)
    for j in range(1, 8):
        buf[base + (14 + j) * pitch] = _prmt(st[j - 1], st[j], 0x6701)
    buf[base + 22 * pitch] = _prmt(st[7], 0, 0x4401)


def _leaf_words(buf, base, pitch, nw, st):
    """load_leaf's stores: ns ‖ ns ‖ digest from 8 namespace words (little
    endian) and 8 big-endian digest words."""
    for j in range(7):
        buf[base + j * pitch] = nw[j]
    buf[base + 7 * pitch] = _prmt(nw[7], nw[0], 0x6540)
    for m in range(1, 7):
        buf[base + (7 + m) * pitch] = _prmt(nw[m - 1], nw[m], 0x6543)
    _put_digest(buf, base, pitch, _prmt(nw[6], nw[7], 0x0043), st)


def _message(src, l, r, sp):
    """message_block for b = 0, 1, 2: the 48 big-endian words of the node
    message 0x01 ‖ left ‖ right of the nodes at word-0 indices l and r."""
    def lw(j):
        return src[l + j * sp]

    def rw(j):
        return src[r + j * sp]

    msg = [_prmt(np.full(len(l), 0x01000000, np.uint32), lw(0), 0x3456)]
    msg += [_prmt(lw(j - 1), lw(j), 0x3456) for j in range(1, 22)]
    msg.append(_prmt(_prmt(lw(21), lw(22), 0x3456), rw(0), 0x3214))
    msg += [_prmt(rw(j - 23), rw(j - 22), 0x1234) for j in range(23, 45)]
    msg.append(_prmt(rw(22), 0x80, 0x1455))
    zero = np.zeros_like(msg[0])
    msg += [zero, zero + np.uint32(181 * 8)]
    assert len(msg) == 48
    return [m.astype(np.uint64) for m in msg]


def _schedule_kw(w16) -> list:
    """schedule_block: K[t] + W[t] for the 64 rounds of one block."""
    w = list(w16)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> np.uint64(3))
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> np.uint64(10))
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & ONES)
    return [(x + K256[t]) & ONES for t, x in enumerate(w)]


def _compress_kw(st: list, kw: list) -> list:
    """compress_kw: the 64 rounds over a precomputed K + W."""
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & ONES & g)
        t1 = (h + s1 + ch + kw[t]) & ONES
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & ONES
        d, c, b, a = c, b, a, (t1 + s0 + maj) & ONES
    return [(x + y) & ONES for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def _inner(src, l, r, sp, dst, d, dp, helped=False):
    """inner_node (or, ``helped``, schedule_block then compress_kw) and
    put_node: parents of the nodes at word-0 indices l and r (arrays)."""
    msg = _message(src, l, r, sp)
    st = [np.full(len(l), h, dtype=np.uint64) for h in H0]
    for b in range(3):
        block = msg[16 * b:16 * b + 16]
        st = _compress_kw(st, _schedule_kw(block)) if helped else _compress(st, block)
    st = [_u32(s) for s in st]
    rw7 = src[r + 7 * sp]
    right_parity = (rw7 & 0xFF) == 0xFF
    for j in range(7):
        right_parity &= src[r + j * sp] == ONES
    x = np.where(right_parity, l, r)
    for j in range(7):
        dst[d + j * dp] = src[l + j * sp]
    dst[d + 7 * dp] = _prmt(src[l + 7 * sp], src[x + 7 * sp], 0x7650)
    for j in range(8, 14):
        dst[d + j * dp] = src[x + j * sp]
    _put_digest(dst, d, dp, src[x + 14 * sp], st)


def _copy_nodes(buf, half, pitch, count, out, at):
    """copy_nodes: count nodes as 16-bit little-endian stores at byte at."""
    h = np.arange(count * HALVES)
    n, i = h // HALVES, h % HALVES
    word = buf[_slot(n, half) + (i >> 1) * pitch]
    val = (word >> (16 * (i & 1)).astype(np.uint32)) & 0xFFFF
    out[at + 2 * h] = val & 0xFF
    out[at + 2 * h + 1] = val >> 8


def _storage(t: torch.Tensor) -> np.ndarray:
    """The whole storage under a view, as numpy of its dtype."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage(), 0, (n,), (1,)).numpy()


def _kernel_tree(quads, q0_ns, keep_levels=False, groups=None):
    """(roots (F, 2k, 90), flat levels or None) as nmt_tree_kernel computes
    them, block by block, from the operands the wrapper sends; ``groups``
    overrides the block size the host would choose."""
    k = quads[0].shape[0]
    w, log_w = 2 * k, (2 * k).bit_length() - 1
    n_trees = (1 if keep_levels else 2) * w
    groups = groups or _groups(n_trees * w)
    planes, leaves = _planes(groups), 256 * groups
    per_block = leaves >> log_w
    tiles = []
    for i, q in enumerate(quads):
        rs, cs = nmt_cuda._word_strides(q, f"quadrant {i}")
        tiles.append((_storage(q), q.storage_offset(), rs, cs))
    ns_rs, ns_cs = nmt_cuda._word_strides(q0_ns, "q0_ns")
    ns_mem, ns_off = _storage(q0_ns), q0_ns.storage_offset()
    roots = np.zeros(n_trees * NODE, np.uint8)
    levels = (np.zeros(sum(a * b * c for a, b, c in nmt_cuda.level_shapes(k)), np.uint8)
              if keep_levels else None)
    for blk in range(-(-n_trees // per_block)):
        bufs = {p: np.zeros(WORDS * pitch, np.uint32) for p, (_h, pitch) in planes.items()}
        tree0 = blk * per_block
        row_trees = min(max(w - tree0, 0), per_block)
        c = np.arange(leaves)  # leaf 2t + s of thread t
        tree = tree0 + (c >> log_w)
        live = tree < n_trees
        col = tree >= w
        i, n = tree & (w - 1), c & (w - 1)
        r, cc = np.where(col, n, i), np.where(col, i, n)
        st = np.zeros((8, leaves), np.uint32)
        nw = np.full((8, leaves), ONES, np.uint32)
        for lane in np.flatnonzero(live):
            q = (2 if r[lane] >= k else 0) + (1 if cc[lane] >= k else 0)
            mem, off, rs, cs = tiles[q]
            at = off + (r[lane] & (k - 1)) * rs + (cc[lane] & (k - 1)) * cs
            st[:, lane] = mem[at:at + 8]
            if q == 0:
                b = ns_off + r[lane] * ns_rs + cc[lane] * ns_cs
                nw[:, lane] = ns_mem[b:b + 32].view("<u4")
        st[:, ~live] = 0
        nw[:, ~live] = 0
        half_a, pitch_a = planes["a"]
        _leaf_words(bufs["a"], _slot(c, half_a), pitch_a, list(nw), list(st))
        level_off = 0
        if keep_levels:
            _copy_nodes(bufs["a"], half_a, pitch_a, row_trees * w, levels, tree0 * w * NODE)
            level_off += w * w
        for lv in range(1, log_w + 1):
            s, d = ("a", "b") if lv & 1 else ("b", "a")
            (sh, sp), (dh, dp) = planes[s], planes[d]
            t = np.arange(leaves >> lv)
            _inner(bufs[s], _slot(2 * t, sh), _slot(2 * t + 1, sh), sp,
                   bufs[d], _slot(t, dh), dp, helped=len(t) <= HELP_NODES * groups)
            per_tree = w >> lv
            if keep_levels:
                _copy_nodes(bufs[d], dh, dp, row_trees * per_tree, levels,
                            (level_off + tree0 * per_tree) * NODE)
                level_off += w * per_tree
            if lv == log_w:
                _copy_nodes(bufs[d], dh, dp, min(per_block, n_trees - tree0), roots,
                            tree0 * NODE)
    return roots.reshape(-1, w, NODE), levels


def _hash_node(left: bytes, right: bytes) -> bytes:
    """The two-branch NMT inner node, from hashlib."""
    max_ns = left[29:58] if right[:29] == PARITY else right[29:58]
    return left[:29] + max_ns + hashlib.sha256(b"\x01" + left + right).digest()


def _pairs(seed: int, count: int) -> list[tuple[bytes, bytes]]:
    """Random sibling pairs: ordinary, right.min parity, equal namespaces,
    all parity, left.max parity."""
    rng = np.random.default_rng(seed)

    def ns_bytes():
        return bytes(rng.integers(0, 256, NAMESPACE_SIZE, dtype=np.uint8))

    def dig():
        return bytes(rng.integers(0, 256, 32, dtype=np.uint8))

    out = []
    for i in range(count):
        a, b, c = ns_bytes(), ns_bytes(), ns_bytes()
        kind = i % 5
        if kind == 0:
            left, right = a + b, b + c
        elif kind == 1:
            left, right = a + b, PARITY + PARITY
        elif kind == 2:
            left, right = a + a, a + a
        elif kind == 3:
            left, right = PARITY + PARITY, PARITY + PARITY
        else:
            left, right = a + PARITY, b + PARITY
        out.append((left + dig(), right + dig()))
    return out


def _to_planes(nodes: list[bytes], half: int, pitch: int) -> np.ndarray:
    buf = np.zeros(WORDS * pitch, np.uint32)
    for n, node in enumerate(nodes):
        words = np.frombuffer(node + b"\x00\x00", "<u4")
        buf[_slot(n, half) + np.arange(WORDS) * pitch] = words
    return buf


@pytest.mark.parametrize("seed", range(4))
def test_kernel_message_assembly_matches_hashlib(seed):
    pairs = _pairs(500 + seed, 40)
    half, pitch = PLANES["a"]
    src = _to_planes([x for p in pairs for x in p], half, pitch)
    dh, dp = PLANES["b"]
    dst = np.zeros(WORDS * dp, np.uint32)
    t = np.arange(len(pairs))
    _inner(src, _slot(2 * t, half), _slot(2 * t + 1, half), pitch, dst, _slot(t, dh), dp)
    out = np.zeros(len(pairs) * NODE, np.uint8)
    _copy_nodes(dst, dh, dp, len(pairs), out, 0)
    for i, (left, right) in enumerate(pairs):
        assert out[i * NODE:(i + 1) * NODE].tobytes() == _hash_node(left, right)
        # the padding bytes of a node stay zero: they never reach a message
        assert dst[_slot(i, dh) + 22 * dp] >> 16 == 0


def test_kernel_leaf_node_is_ns_ns_digest():
    rng = np.random.default_rng(9)
    ns_runs = rng.integers(0, 256, size=(6, 32), dtype=np.uint8)
    digests = rng.integers(0, 2**32, size=(6, 8), dtype=np.uint64).astype(np.uint32)
    half, pitch = PLANES["a"]
    buf = np.zeros(WORDS * pitch, np.uint32)
    nw = list(np.ascontiguousarray(ns_runs).view("<u4").T)
    _leaf_words(buf, _slot(np.arange(6), half), pitch, nw, list(digests.T))
    out = np.zeros(6 * NODE, np.uint8)
    _copy_nodes(buf, half, pitch, 6, out, 0)
    for i in range(6):
        ns29 = ns_runs[i, :NAMESPACE_SIZE].tobytes()
        want = ns29 + ns29 + digests[i].astype(">u4").tobytes()
        assert out[i * NODE:(i + 1) * NODE].tobytes() == want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k,pad_tail", [(1, 0), (2, 0), (4, 5), (8, 0), (16, 0)])
def test_kernel_tree_matches_reference(k, pad_tail, mode):
    grid = torch.from_numpy(_digest_grid(k, seed=4000 + k))
    sq = torch.from_numpy(square(k, seed=6, pad_tail=pad_tail))
    # the fused route's layout: Q1 and Q3 transposed views
    d1t = grid[:k, k:].transpose(0, 1).contiguous()
    d3t = grid[k:, k:].transpose(0, 1).contiguous()
    quads = (grid[:k, :k], d1t.transpose(0, 1), grid[k:, :k], d3t.transpose(0, 1))
    q0_ns = sq[..., :NAMESPACE_SIZE]
    keep = MODES[mode]
    roots, levels = _kernel_tree(quads, q0_ns, keep_levels=keep)
    ref_roots, ref_levels = nmt_cuda.nmt_tree_reference(quads, q0_ns, keep_levels=keep)
    assert np.array_equal(roots, ref_roots.numpy())
    if keep:
        assert np.array_equal(levels, ref_levels.numpy())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k,groups", [(8, 2), (8, 4), (16, 4)])
def test_kernel_tree_larger_blocks_match_reference(k, groups, mode):
    """The block sizes the host takes at k = 128 (2 and 4 groups: 2 and 4
    trees a block there), at a k small enough to emulate: several trees
    a block, rows and columns in one block (both families), blocks with
    empty tree slots (the rows with their levels)."""
    grid = torch.from_numpy(_digest_grid(k, seed=4100 + k))
    q0_ns = torch.from_numpy(square(k, seed=7, pad_tail=k))[..., :NAMESPACE_SIZE]
    keep = MODES[mode]
    roots, levels = _kernel_tree(_quadrants(grid, k), q0_ns, keep_levels=keep, groups=groups)
    ref_roots, ref_levels = nmt_cuda.nmt_tree_reference(_quadrants(grid, k), q0_ns,
                                                        keep_levels=keep)
    assert np.array_equal(roots, ref_roots.numpy())
    if keep:
        assert np.array_equal(levels, ref_levels.numpy())


def test_block_size_rule():
    """One block an SM at the main path's k = 128 calls: 4 groups for an
    extend (512 trees of 256 leaves), 2 for the row levels, 1 at k = 64."""
    assert _groups(2 * 256 * 256) == 4 and _groups(256 * 256) == 2
    assert _groups(2 * 128 * 128) == 1 and _groups(4) == 1


def test_kernel_tree_single_namespace_square():
    """A Q0 of one namespace: every Q0 leaf has min = max, so the parity
    rule decides every max on the boundary."""
    k = 4
    sq = square(k, seed=8)
    sq[..., :NAMESPACE_SIZE] = sq[0, 0, :NAMESPACE_SIZE]
    grid = torch.from_numpy(_digest_grid(k, seed=12))
    q0_ns = torch.from_numpy(sq)[..., :NAMESPACE_SIZE]
    roots, _ = _kernel_tree(_quadrants(grid, k), q0_ns)
    ref, _ = nmt_cuda.nmt_tree_reference(_quadrants(grid, k), q0_ns)
    assert np.array_equal(roots, ref.numpy())
    assert roots[0, 0, NAMESPACE_SIZE:2 * NAMESPACE_SIZE].tobytes() == \
        sq[0, 0, :NAMESPACE_SIZE].tobytes()
