"""Kernels K5 (XOR-schedule encode + NMT leaf hash) and K6 (XOR-schedule
encode), and the unfused XOR extend.

Counterpart of the Pallas half of the JAX package's ops/xor_schedule.py.
Source: ``csrc/xor_schedule.cu``, sharing ``csrc/sha256.cuh`` with K1.

K5 ``encode2d_xor_hash(x2, ops)`` replaces ``xor_schedule.encode2d_xor_hash``
(xor_schedule.py:537, ``pallas_call`` at :512): K1's output contract, the
(k, N) parity and the (k, N/512, 8) uint32 leaf digests under the parity
namespace, with the parity from the compiled XOR schedule. It is the quadrant
encode of the fused XOR route.

K6 ``encode2d_xor(x2, ops)`` replaces ``xor_schedule.encode2d_xor``
(xor_schedule.py:476, ``pallas_call`` at :465): K5 without the hash, the
quadrant encode of the unfused XOR route (``extend_square_xor``).

``ops`` is an ``XorOperands``: the schedule of ``xor_schedule.compile_schedule``
and its ``XorLayout``, the program the kernels run, made once per
(k, device) by ``schedule_operands``. The int64 index tensors the plain
versions gather with are built on the operands' device at the first plain
call, not beside the kernel operands on every route.

The layout (``operands_from_schedule``). The kernels keep a chunk of 128
lanes of every plane in shared memory, one 16-byte plane a slot, and each
thread XORs whole slots. Shared memory serves a warp's 16-byte loads eight
threads at a time, and eight slots whose indices differ mod 8 (their
*residue*: their bank group) in one wavefront. The layout is built so that
every such eight read distinct residues at every step:

- the k shards are split into ``groups`` of k / groups; each block runs one
  group's output rows (``groups`` blocks share a chunk) and holds that
  group's program on chip for the whole launch: the nodes its rows need
  (their closure), level by level, in shared memory, and each thread's row
  segment as a list of 16-bit slots in registers (past REG_PAIRS pairs, in
  shared memory);
- input plane 8s + b sits in slot 8s + ((b + s) mod 8), so a warp that
  bit-slices eight shards stores eight residues; the zero plane has eight
  slots, 8k + r, one per residue;
- a level's nodes are dealt to quarters of eight threads: each node's two
  operands are oriented along an Euler circuit of the residue multigraph
  and the oriented nodes split into perfect matchings (Birkhoff-von
  Neumann), so in a quarter the first operands, the second operands and
  the eight results (slots base + 0..7) each cover the eight residues; a
  result's residue goes to the node read most by the row quarters that
  read that residue least, which evens out the rows' residues;
- a row's operands (in ``segs`` segments, one thread each) are dealt the
  same way: the eight threads of a quarter x the eight residues form a
  bipartite multigraph, padded with zero-plane reads to regular degree and
  split into matchings, one step each, so each step's eight reads cover
  the eight residues. The zero-plane reads are the layout's padding
  (``padded_reads - reads``).

What bounds them on the H100, at k = 128 (N = 65,536): the schedule has
242,496 two-input XORs per lane; with each output row assembled from
three-input XORs (LOP3) that is 123,520 operations, and bit-sliced 32 lanes
to a word 123,520 × N/32 = 2.5e8 int32 operations, 15 µs at ~16.7 T int32
op/s (64 INT32 lanes × 132 SMs × 1.98 GHz, an estimate from the SM layout).
K5 adds K1's 147,456 leaf SHA blocks (~19 µs); the bytes (16 MB for K6,
18 MB for K5) are ~5 µs at 3.35 TB/s. So both are bound by operations, and
the bounds are K4's and K1's (the same functions; ``ops/rs_cuda.py``). The
spelling itself reads every operand from shared memory: 247,616 16-byte
reads per 128 lanes, 61 µs at one 128-byte wavefront per clock and SM
(this layout: 282,976, 69 µs). See ``csrc/xor_schedule.cu`` for the kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.ops import _cuda, rs, rs_cuda
from celestia_tpu_torch.ops import xor_schedule as xs

MAX_K = 128  # the Leopard code's largest square
RESIDUES = 8  # 16-byte bank groups of shared memory: eight slots a wavefront
STEPS = 8  # a thread's step count is a multiple: four pairs, one 16-byte vector
WARP = 32
ENC_THREADS = 512  # the encode warps of a block (csrc/xor_schedule.cu)
MAX_PAIRS = 64  # step pairs of a thread's row program
REG_PAIRS = 32  # of which registers hold the first (kRegPairs in the kernel)
HEADER = 5  # fixed header words of a group's program
MAX_SEGS = 2  # segments of a row (the pack stage XORs at most two)
STAGE_STRIDE = 144  # bytes per shard row of the staged input chunk
RING_SLOTS = 4  # K5's chunk slots between the encode warps and the hash warp
RING_STRIDE = 33  # words per shard row of a ring slot
MAX_SMEM = 232448  # bytes of shared memory a block may use
MIN_BLOCKS = 128  # K5 runs a 512-lane cell column a block: groups · k of them


@dataclasses.dataclass(frozen=True, eq=False)
class XorLayout:
    """One schedule as the kernels' per-group programs.

    prog: (groups, words) uint32, group g's program. Its first ``smem_words``
        words go to shared memory: a header (the word count of that part,
        the row-pair count P, the offsets of the register pairs and of the
        thread words, the offset of the shared row vectors, then each
        level's node-entry count, a multiple of 8, and each level's offset),
        the node entries, level by level, two words each: a | b << 16
        (operand slots) and the result slot, and the row pairs past
        REG_PAIRS, [vector][thread][4], four a 16-byte load. The rest is
        read once into registers: the first min(P, REG_PAIRS) row pairs,
        [pair][thread], step pair j as a | b << 16, and the thread words,
        (ENC_THREADS,), rowbuf slot | pairs << 16 (a multiple of 4, one
        count for a whole warp).
    plane_slot: (groups, n_planes) int32, the slot of each schedule plane in
        group g's plane store, -1 where the group does not hold it.
    reads / padded_reads: operand reads per 32 lanes over all groups, real
        ones and as the kernels issue them (zero-plane padding included).
    """

    k: int
    groups: int
    segs: int
    n_slots: int
    rowbuf_slots: int
    n_levels: int
    smem_words: int
    max_pairs: int
    prog: np.ndarray
    plane_slot: np.ndarray
    reads: int
    padded_reads: int

    @property
    def shards_per_group(self) -> int:
        return self.k // self.groups

    def row_program(self, g: int) -> tuple[np.ndarray, np.ndarray]:
        """Group g's row program as the kernels see it: the step pairs
        (max_pairs, ENC_THREADS), a | b << 16, registers' and shared
        memory's together, and the thread words (ENC_THREADS,)."""
        p = self.prog[g]
        smem_words, n_pairs, reg_off, words_off, vec_off = (int(v) for v in p[:HEADER])
        reg = min(n_pairs, REG_PAIRS)
        vec = p[vec_off: smem_words].reshape(-1, ENC_THREADS, 4).transpose(0, 2, 1)
        pairs = np.concatenate([p[reg_off: reg_off + reg * ENC_THREADS].reshape(reg, ENC_THREADS),
                                vec.reshape(-1, ENC_THREADS)])
        return pairs, p[words_off: words_off + ENC_THREADS]

    def smem_bytes(self, hashed: bool) -> int:
        """Dynamic shared memory of a block: the plane store, the row
        accumulators, the program's shared part, the staged input chunk and,
        for K5, the ring of parity chunks for the hash warp."""
        ring = RING_SLOTS * self.shards_per_group * RING_STRIDE * 4 if hashed else 0
        return (16 * (self.n_slots + self.rowbuf_slots) + 4 * self.smem_words
                + STAGE_STRIDE * self.k + ring)


def input_slot(q: int) -> int:
    """Slot of input plane q = 8s + b: 8s + ((b + s) mod 8)."""
    s, b = divmod(q, 8)
    return 8 * s + ((b + s) & 7)


def _perfect_matching(m: np.ndarray) -> list[int]:
    """A perfect matching in the support of the 8 x 8 count matrix m (one
    exists: m is regular), as perm[row] = column."""
    owner = [-1] * RESIDUES

    def augment(i: int, seen: list[bool]) -> bool:
        for j in range(RESIDUES):
            if m[i, j] > 0 and not seen[j]:
                seen[j] = True
                if owner[j] < 0 or augment(owner[j], seen):
                    owner[j] = i
                    return True
        return False

    for i in range(RESIDUES):
        if not augment(i, [False] * RESIDUES):
            raise AssertionError("a regular bipartite multigraph has a perfect matching")
    perm = [0] * RESIDUES
    for j, i in enumerate(owner):
        perm[i] = j
    return perm


def _matchings(counts: np.ndarray) -> tuple[int, list[tuple[list[int], int]]]:
    """Split an 8 x 8 count matrix into (perm, repeats): (delta, steps) with
    delta = the largest row or column sum, every row i reading column
    perm[i] in each of the sum(repeats) = delta steps. The counts are first
    padded to row and column sums delta (the padding is zero-plane reads);
    the padded matrix is regular, so Birkhoff-von Neumann applies."""
    m = counts.astype(np.int64).copy()
    delta = int(max(m.sum(axis=1).max(), m.sum(axis=0).max()))
    dr, dc = delta - m.sum(axis=1), delta - m.sum(axis=0)
    i = j = 0
    while i < RESIDUES and j < RESIDUES:
        d = min(dr[i], dc[j])
        m[i, j] += d
        dr[i] -= d
        dc[j] -= d
        i += dr[i] == 0
        j += dc[j] == 0
    steps = []
    while m.any():
        perm = _perfect_matching(m)
        w = int(min(m[i, perm[i]] for i in range(RESIDUES)))
        for i in range(RESIDUES):
            m[i, perm[i]] -= w
        steps.append((perm, w))
    return delta, steps


def _euler_orient(edges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Orient each edge of a multigraph on the 8 residues along Euler
    circuits (odd vertices paired by extra edges first), so that every
    residue has in- and out-degree at most ceil(degree / 2)."""
    all_edges = list(edges)
    deg = [0] * RESIDUES
    for u, v in edges:
        deg[u] += 1
        deg[v] += 1
    odd = [m for m in range(RESIDUES) if deg[m] % 2]
    all_edges += list(zip(odd[::2], odd[1::2]))
    adj: list[list[int]] = [[] for _ in range(RESIDUES)]
    for e, (u, v) in enumerate(all_edges):
        adj[u].append(e)
        adj[v].append(e)
    used = [False] * len(all_edges)
    orient: list[tuple[int, int]] = [(0, 0)] * len(all_edges)
    ptr = [0] * RESIDUES
    for start in range(RESIDUES):
        stack = [start]
        while stack:
            v = stack[-1]
            while ptr[v] < len(adj[v]) and used[adj[v][ptr[v]]]:
                ptr[v] += 1
            if ptr[v] == len(adj[v]):
                stack.pop()
                continue
            e = adj[v][ptr[v]]
            used[e] = True
            u, w = all_edges[e]
            nxt = w if u == v else u
            orient[e] = (v, nxt)
            stack.append(nxt)
    return orient[: len(edges)]


def _closure(sched: xs.XorSchedule, rows) -> set[int]:
    """The node planes that ``rows`` read, directly or through other nodes."""
    first = sched.n_in + 1
    need = {int(p) for r in rows for p in sched.row_idx[r] if p >= first}
    stack = list(need)
    while stack:
        t = stack.pop() - first
        for q in (int(sched.flat_a[t]), int(sched.flat_b[t])):
            if q >= first and q not in need:
                need.add(q)
                stack.append(q)
    return need


@dataclasses.dataclass
class _Group:
    """One group's program while it is built."""

    slot: np.ndarray  # plane -> slot, -1 where not held
    levels: list[np.ndarray]  # per level (entries, 2) uint32
    pairs: np.ndarray  # (pairs, ENC_THREADS) uint32
    words: np.ndarray  # (ENC_THREADS,) uint32
    n_slots: int
    reads: int
    padded_reads: int


def _row_threads(sched: xs.XorSchedule, rows: list[int], spc: int, segs: int) -> list:
    """(operand planes, rowbuf slot) of every row thread, in quarter order.

    Thread (row 8s + b, segment) stores to rowbuf slot
    seg * 8spc + 8s + ((b + s) mod 8): pack reads eight shards' slots of one
    bit at once. A quarter takes the i-th longest thread of each of the
    eight slot residues, so its stores are conflict-free too, and its eight
    lists are of about one length. Dummy threads (no operand, a junk slot of
    the right residue) fill the block's other threads."""
    by_residue: list[list] = [[] for _ in range(RESIDUES)]
    for i, r in enumerate(rows):
        ops = [int(p) for p in sched.row_idx[r] if p != sched.zero]
        s_l, b = divmod(i, 8)
        for seg in range(segs):
            dest = seg * 8 * spc + 8 * s_l + ((b + s_l) & 7)
            by_residue[dest & 7].append((ops[seg::segs], dest))
    for cls in by_residue:
        cls.sort(key=lambda t: -len(t[0]))
    threads = [cls[i] for i in range(len(by_residue[0])) for cls in by_residue]
    return threads


def _build_group(sched: xs.XorSchedule, g: int, spc: int, segs: int) -> _Group:
    k = sched.n_in // 8
    zero = 8 * k  # zero plane of residue r at slot zero + r
    first = sched.n_in + 1
    slot = np.full(sched.n_planes, -1, np.int64)
    slot[: sched.n_in] = [input_slot(q) for q in range(sched.n_in)]
    rows = [8 * s + b for s in range(g * spc, (g + 1) * spc) for b in range(8)]
    need = _closure(sched, rows)
    threads = _row_threads(sched, rows, spc, segs)
    if len(threads) > ENC_THREADS:
        raise ValueError(f"{len(threads)} row threads exceed a block's {ENC_THREADS}")
    junk = segs * 8 * spc
    # each row quarter's reads by residue: the inputs' now, each node's once
    # it has a slot; a node's result residue is picked to even them out
    load = np.zeros((len(threads) // RESIDUES, RESIDUES), np.int64)
    node_reads: dict[int, collections.Counter] = collections.defaultdict(collections.Counter)
    for i, (ops, _dest) in enumerate(threads):
        for p in ops:
            if p < first:
                load[i // RESIDUES, slot[p] & 7] += 1
            else:
                node_reads[p][i // RESIDUES] += 1
    reads = sum(len(ops) for ops, _ in threads)
    nxt = zero + RESIDUES
    padded = 0
    levels = []
    off = 0
    for width in sched.level_widths:
        nodes = [p for p in range(first + off, first + off + width) if p in need]
        off += width
        pools = collections.defaultdict(list)
        edges = [(int(slot[sched.flat_a[p - first]]) & 7, int(slot[sched.flat_b[p - first]]) & 7)
                 for p in nodes]
        for p, (ra, _rb), (u, v) in zip(nodes, edges, _euler_orient(edges)):
            a, b = int(sched.flat_a[p - first]), int(sched.flat_b[p - first])
            pools[(u, v)].append((p, a, b) if u == ra else (p, b, a))
        counts = np.zeros((RESIDUES, RESIDUES), np.int64)
        for (u, v), pool in pools.items():
            counts[u, v] = len(pool)
        entries = []
        for perm, w in (_matchings(counts)[1] if nodes else []):
            for _ in range(w):
                # the quarter's eight threads: (node or None, first, second)
                quarter = []
                for u in range(RESIDUES):
                    pool = pools[(u, perm[u])]
                    if pool:
                        p, a, b = pool.pop()
                        quarter.append((p, int(slot[a]), int(slot[b])))
                    else:
                        quarter.append((None, zero + u, zero + perm[u]))
                # result residues: the most-read node first, to the residue
                # its readers' quarters read least
                free = list(range(RESIDUES))
                place = {}
                real = [i for i, (p, _a, _b) in enumerate(quarter) if p is not None]
                real.sort(key=lambda i: -sum(node_reads[quarter[i][0]].values()))
                for i in real:
                    qs = node_reads[quarter[i][0]]
                    if qs:
                        qi = np.fromiter(qs.keys(), np.int64)
                        cost = np.fromiter(qs.values(), np.int64) @ load[qi][:, free]
                        r = free[int(np.argmin(cost))]
                        load[qi, r] += np.fromiter(qs.values(), np.int64)
                    else:
                        r = free[0]
                    free.remove(r)
                    place[i] = r
                for i in range(RESIDUES):
                    if i not in place:
                        place[i] = free.pop(0)
                row = [None] * RESIDUES
                for i, (p, a, b) in enumerate(quarter):
                    r = place[i]
                    if p is not None:
                        slot[p] = nxt + r
                    row[r] = (a, b, nxt + r)
                entries += row
                nxt += RESIDUES
        reads += 2 * len(nodes)
        padded += 2 * len(entries)
        e = np.array(entries, np.int64).reshape(-1, 3)
        levels.append(np.stack([e[:, 0] | (e[:, 1] << 16), e[:, 2]], axis=1).astype(np.uint32))

    seqs = []
    for q0 in range(0, len(threads), RESIDUES):
        counts = np.zeros((RESIDUES, RESIDUES), np.int64)
        pools = collections.defaultdict(list)
        for i, (ops, _dest) in enumerate(threads[q0: q0 + RESIDUES]):
            for p in ops:
                counts[i, slot[p] & 7] += 1
                pools[(i, int(slot[p]) & 7)].append(int(slot[p]))
        _delta, steps = _matchings(counts)
        seq = [[pools[(i, perm[i])].pop() if pools[(i, perm[i])] else zero + perm[i]
                for i in range(RESIDUES)] for perm, w in steps for _ in range(w)]
        seqs.append(np.array(seq, np.int64).reshape(-1, RESIDUES))
    # a warp runs its longest quarter's steps, rounded up to a multiple of
    # STEPS (four pairs, a 16-byte vector of the shared part); its other
    # quarters pad with zero planes of their threads' residues
    pairs = np.zeros((0, ENC_THREADS), np.int64)
    words = np.zeros(ENC_THREADS, np.int64)
    for t0 in range(0, ENC_THREADS, WARP):
        quarters = seqs[t0 // RESIDUES: (t0 + WARP) // RESIDUES]
        n_steps = -(-max((len(q) for q in quarters), default=0) // STEPS) * STEPS
        if n_steps // 2 > pairs.shape[0]:
            pairs = np.concatenate([pairs, np.zeros((n_steps // 2 - pairs.shape[0], ENC_THREADS),
                                                    np.int64)])
        for i in range(WARP // RESIDUES if n_steps else 0):
            q = quarters[i] if i < len(quarters) else np.zeros((0, RESIDUES), np.int64)
            lanes = slice(t0 + RESIDUES * i, t0 + RESIDUES * (i + 1))
            seq = np.concatenate([q, np.broadcast_to(zero + np.arange(RESIDUES),
                                                     (n_steps - len(q), RESIDUES))])
            pairs[: n_steps // 2, lanes] = (seq[0::2] | (seq[1::2] << 16))
            padded += RESIDUES * n_steps
        dests = [d for _ops, d in threads[t0: t0 + WARP]]
        dests += [junk + i % RESIDUES for i in range(len(dests), WARP)]
        words[t0: t0 + WARP] = np.array(dests) | ((n_steps // 2) << 16)
    return _Group(slot=slot, levels=levels, pairs=pairs.astype(np.uint32),
                  words=words.astype(np.uint32), n_slots=nxt, reads=reads, padded_reads=padded)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def build_layout(sched: xs.XorSchedule, groups: int, segs: int) -> XorLayout:
    """The kernels' program for ``sched`` with its k shards in ``groups``
    groups and each row in ``segs`` segments."""
    k = sched.n_in // 8
    if groups < 1 or k % groups or not 1 <= segs <= MAX_SEGS:
        raise ValueError(f"cannot split k = {k} into {groups} groups of {segs} segments")
    spc = k // groups
    built = [_build_group(sched, g, spc, segs) for g in range(groups)]
    n_levels = len(sched.level_widths)
    header = _pad4(HEADER + 2 * n_levels)
    max_pairs = max(grp.pairs.shape[0] for grp in built)
    extra = max(max_pairs - REG_PAIRS, 0)  # pairs beyond the registers, in shared memory
    vec_off = _pad4(header + max(sum(e.size for e in grp.levels) for grp in built))
    smem_words = vec_off + extra * ENC_THREADS
    reg_pairs = min(max_pairs, REG_PAIRS)
    words = smem_words + (reg_pairs + 1) * ENC_THREADS
    prog = np.zeros((groups, words), np.uint32)
    for g, grp in enumerate(built):
        p = prog[g]
        p[:HEADER] = (smem_words, max_pairs, smem_words, smem_words + reg_pairs * ENC_THREADS,
                      vec_off)
        pos = header
        for lv, entries in enumerate(grp.levels):
            p[HEADER + lv] = len(entries)
            p[HEADER + n_levels + lv] = pos
            p[pos: pos + entries.size] = entries.reshape(-1)
            pos += entries.size
        pairs = np.zeros((max_pairs, ENC_THREADS), np.uint32)
        pairs[: grp.pairs.shape[0]] = grp.pairs
        p[smem_words: smem_words + reg_pairs * ENC_THREADS] = pairs[:reg_pairs].reshape(-1)
        # [vector][thread][4]: four pairs a 16-byte load
        vec = pairs[reg_pairs:].reshape(-1, 4, ENC_THREADS).transpose(0, 2, 1)
        p[vec_off: smem_words] = vec.reshape(-1)
        p[smem_words + reg_pairs * ENC_THREADS:] = grp.words
    n_slots = max(grp.n_slots for grp in built)
    if n_slots > 1 << 16:
        raise ValueError(f"{n_slots} slots do not fit 16-bit operands")
    return XorLayout(
        k=k, groups=groups, segs=segs, n_slots=n_slots,
        rowbuf_slots=segs * 8 * spc + RESIDUES, n_levels=n_levels, smem_words=smem_words,
        max_pairs=max_pairs, prog=prog,
        plane_slot=np.stack([grp.slot for grp in built]).astype(np.int32),
        reads=sum(grp.reads for grp in built),
        padded_reads=sum(grp.padded_reads for grp in built))


def default_layout(sched: xs.XorSchedule) -> XorLayout:
    """The layout the kernels run: the fewest groups (powers of two) that
    give K5 at least MIN_BLOCKS cell columns a launch and its hash warp at
    most 32 shards, whose threads' row programs fit MAX_PAIRS step pairs
    and whose block fits shared memory. A group's rows are cut into as many segments
    as its ENC_THREADS threads hold, down to about 24 operands a segment,
    at most MAX_SEGS."""
    k = sched.n_in // 8
    lens = (sched.row_idx != sched.zero).sum(axis=1)
    groups = 1
    while groups < k and (groups * k < MIN_BLOCKS or k // groups > WARP):
        groups *= 2
    while True:
        rows = 8 * (k // groups)
        segs = max(1, min(ENC_THREADS // rows, int(lens.mean()) // 24, MAX_SEGS))
        while rows * segs <= ENC_THREADS and segs <= MAX_SEGS:
            if -(-int(lens.max()) // segs) <= 2 * MAX_PAIRS or groups == k:
                layout = build_layout(sched, groups, segs)
                if (layout.max_pairs <= MAX_PAIRS
                        and layout.smem_bytes(hashed=True) <= MAX_SMEM):
                    return layout
            segs += 1
        if groups == k:
            raise ValueError(f"no layout of the k = {k} schedule fits a block")
        groups *= 2


@dataclasses.dataclass(frozen=True)
class XorOperands:
    """One schedule on one device: its layout and the layout's programs
    there (``prog``, (groups, words) int32)."""

    sched: xs.XorSchedule
    layout: XorLayout
    prog: torch.Tensor

    @functools.cached_property
    def index(self) -> xs.ScheduleIndex:
        """The int64 index tensors the plain versions gather with, built
        at their first call."""
        return xs.schedule_index(self.sched, self.prog.device)


def operands_from_schedule(sched: xs.XorSchedule, device) -> XorOperands:
    """The kernels' layout of ``sched`` (``default_layout``) on ``device``."""
    layout = default_layout(sched)
    return XorOperands(sched=sched, layout=layout,
                       prog=torch.as_tensor(layout.prog.view(np.int32), device=device))


@functools.lru_cache(maxsize=16)
def _operands_cached(k: int, device: str) -> XorOperands:
    return operands_from_schedule(xs.compile_schedule(k), device)


def schedule_operands(k: int, device: torch.device) -> XorOperands:
    """The compiled schedule for square size k on ``device``, made once per
    (k, device): the programs are not copied to the card on each call."""
    return _operands_cached(k, str(device))


def encode2d_xor_reference(x2: torch.Tensor, ops: XorOperands) -> torch.Tensor:
    """Plain PyTorch version of K6: (k, N) parity through the schedule."""
    rs_cuda.check_lanes(x2)
    return xs.rs_encode_rows_xor(x2, ops.index)


def encode2d_xor_hash_reference(x2: torch.Tensor, ops: XorOperands):
    """Plain PyTorch version of K5: ((k, N) parity, (k, N/512, 8) digests)."""
    parity = encode2d_xor_reference(x2, ops)
    return parity, rs_cuda.parity_leaf_digests_plain(parity)


def _launch(name: str, x2: torch.Tensor, ops: XorOperands, *outs: torch.Tensor) -> None:
    rs_cuda.check_lanes(x2)
    k, n = x2.shape
    if k & (k - 1) or k > MAX_K:
        raise ValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    lay = ops.layout
    if lay.k != k:
        raise ValueError(f"the schedule is for k = {lay.k}, x2 has k = {k}")
    dev = x2.device
    _cuda.require(x2, "x2", torch.uint8, (k, n), dev)
    _cuda.require(ops.prog, "prog", torch.int32, lay.prog.shape, dev)
    rc = getattr(_cuda.library(), f"celestia_{name}")(
        x2.data_ptr(), ops.prog.data_ptr(), lay.prog.shape[1], lay.smem_words, lay.n_levels,
        lay.max_pairs, lay.n_slots, lay.groups, lay.segs,
        *(o.data_ptr() for o in outs), k, n, dev.index or 0, _cuda.stream_of(x2))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1


def encode2d_xor(x2: torch.Tensor, ops: XorOperands) -> torch.Tensor:
    """XOR-schedule encode: (k, N) uint8 data shards -> (k, N) parity.

    A CPU tensor runs the plain version; a CUDA tensor launches K6."""
    if x2.device.type == "cpu":
        return encode2d_xor_reference(x2, ops)
    parity = torch.empty(tuple(x2.shape), dtype=torch.uint8, device=x2.device)
    _launch("encode2d_xor", x2, ops, parity)
    return parity


def encode2d_xor_hash(x2: torch.Tensor, ops: XorOperands):
    """XOR-schedule encode + NMT leaf hash: (k, N) uint8 data shards ->
    ((k, N) parity, (k, N/512, 8) uint32 leaf digest words), the output
    contract of ``rs_cuda.encode2d_hash``.

    A CPU tensor runs the plain version; a CUDA tensor launches K5."""
    if x2.device.type == "cpu":
        return encode2d_xor_hash_reference(x2, ops)
    k, n = x2.shape
    parity = torch.empty((k, n), dtype=torch.uint8, device=x2.device)
    digests = torch.empty((k, n // SHARE_SIZE, 8), dtype=torch.uint32, device=x2.device)
    _launch("encode2d_xor_hash", x2, ops, parity, digests)
    return parity, digests


def extend_square_xor(q0: torch.Tensor, ops: XorOperands,
                      encode=encode2d_xor) -> torch.Tensor:
    """(k, k, 512) -> EDS with every quadrant encode on K6 (the unfused XOR
    route); ``encode=encode2d_xor_reference`` runs the plain version on any
    device."""
    return rs.extend_quadrants(q0, lambda x: encode(x, ops))
