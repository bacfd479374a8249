#!/usr/bin/env python3
"""On-card smoke test of celestia_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--xor-table-out PATH] [--sass-out PATH]

``--xor-table-out`` also writes the dense/XOR routing table this run measured
(phase 7) to PATH, in the format of celestia_tpu_torch/config/xor_schedule.json;
``--sass-out`` writes the SASS of K2, K3 and the tree kernel to PATH.

The port has four extend routes (fused/unfused × dense/XOR); a route is
picked with the env pins CELESTIA_FUSED_KERNELS and CELESTIA_XOR_SCHEDULE,
as a user picks it. Seven kernels carry them: K1 encode2d_hash, K2
leaf_digests2d, K3 sha256_words, K4 encode2d, K5 encode2d_xor_hash, K6
encode2d_xor, and nmt_tree, K3's tree form (every route ends in it: the
leaf-digest grid to the row and column roots, and the row levels, in one
launch). dah_merkle, K3's merkle form (csrc/dah_merkle.cu), is the device
DAH of extend_and_root_device: one launch over the 4k axis roots. K3
itself is on no entry's path any more. decode_sweep (csrc/rs_decode.cu)
carries EDS repair: one launch per planned sweep of the Leopard erasure
decode, in place in the EDS. ragged_gather (csrc/ragged_gather.cu) carries
the serving reads: one launch per page geometry of a crowd of DAS samples
across heights, reading every row in place through the paged cache's pages, and
assemble_square (csrc/assemble_square.cu) the proposer's square: one
launch builds it on the card from the resident blob arena and the
deduplicated host shares.

Phases, in order (any failed check raises, so the script exits non-zero and
prints no result; it also exits non-zero when no CUDA device is present):

1. Environment: versions, the card's name, power limit, SM count and
   maximum SM clock, the kernel build (nvcc for sm_90a, from
   celestia_tpu_torch/csrc/) and its seconds, the ptxas report (registers,
   spills; also of K5/K6, every decode sweep instance and the merkle
   kernel) and SASS opcode mix of the k = 128 encode, K2, K3, the tree
   kernel, the merkle kernel and the n = 256 decode sweep (and its LDS,
   PRMT, LOP3 and SHF in one pass of its work-item loop), the tree
   kernel's resident blocks per SM, the operations of one
   SHA-256 block counted from K3's compiled block loop (ALU pipe: LOP3,
   SHF, IADD3, PRMT; FMA pipe: IMAD), which every SHA bound below uses, the
   operations of its 64 rounds alone counted from the tree kernel's
   rounds-only loop (the chain term of the SHA tree bounds), the XOR
   schedule's host compile at k = 128 and its seconds, and K5/K6's layout
   at each rung of the routing table (``xor_layout``: block groups, cluster
   size, row segments, step pairs in registers, shared memory per block,
   the padding of the conflict-free operand order).
2. Each kernel against its plain PyTorch version on the card, byte for byte:
   K3 on messages of every length 0..600 (and against hashlib) and at the
   NMT level shapes; the merkle kernel at every power of two k from 1 to
   128, one DAH and a batch of 3 (and against hashlib); K1, K4, K5 and K6
   at every power of two k from 1 to
   128 (the FFT program of K1/K4 differs per k), K2 at the same k on both
   of its main-path shapes, (k, k·512) and (2k, 2k·512), and at 1, 3 and
   65 rows; the FFT and XOR kernels against each other (K5 = K1,
   K6 = K4); and the tree kernel at every power of two k from 1 to 128
   (roots of both families, and the row roots with the full row-level
   stack) on random digests, under random, TAIL_PADDING-tailed and single
   namespaces, its digest tiles in the fused route's layout. Then K1 and K4
   in the strided layouts of the main path at every k (``strided_vs_plain``:
   the three quadrant encodes in place in one EDS, and the roots-only
   core's scratch layout), and K2 reading each Q0 cell's namespace from the
   cell itself.
3. The reference DAH hashes (MIN k = 1, TYPICAL k = 2, MAX k = 128) through
   da.extend_shares -> new_data_availability_header(...).hash(), and the DAH
   computed on the device by extend_and_root_device equal to the host's, on
   each of the four routes.
4. Realistic squares (sorted v0 namespaces over random bytes, and a variant
   with a TAIL_PADDING tail) at k = 64 and k = 128. For each route the
   launch counts are set to 0 just before the main path runs on the k = 128
   square (extend -> DAH -> row levels, as a block producer runs it) and
   read just after: the route's own kernels ran, the tree kernel once per
   extend and once for the row levels, K3 no time, and the other routes'
   encode kernels did not. The device-DAH entry (extend_and_root_device)
   is read the same way: the merkle kernel once, the tree kernel once, K3
   no time (its ``main_path`` line comes with phase 7's timing: the
   device DAH's aten ops and H2D copies, 0 each, and the entry's wall ms
   at k = 64 and 128). On
   each route the kernel route equals the plain route
   (EDS, roots, DAH) and the fused dense route; on the fused dense route the
   row levels equal the plain ones, and at k = 64 the roots equal the host
   oracle (gf256 + nmt_host).
5. The block path around the kernels: ``roots_only`` (on every route,
   roots_device's roots-only core equals extend_roots_device_resident's
   roots and the plain route, k = 64 and 128); ``batched``
   (batched_roots_device on lists and stacked arrays, B = 1, 2, 4, 8 at
   k = 64 and 128, byte-identical to one roots_device a square, with ms per
   square); ``staging`` (the k = 128 square to the card through
   device_put_chunked with 1, 2, 4 and 8 chunks, against a pageable and a
   pinned ``.to()``, host time until the card has it, bytes equal) and
   ``staging_levers`` (fused dense roots_device at k = 128, in turns, with
   the chunk rule, with one chunk, and with a pageable ``.to()`` instead);
   ``integrity`` (the syndrome through K4 against its plain version at
   sampled and full, clean and with a flipped bit, with its device ms) and
   ``integrity_drill`` (a device.extend.output bitflip raising with the
   plain count, a transfer.chunk bitflip healing and raising);
   ``sliced_reads`` (row, column, cell and batch reads of the resident
   k = 128 EDS equal to a chunked full fetch, with the bytes each moved).
6. EDS repair (``repair``): first the decode sweep at every power of two
   k from 1 to 32, every sweep of one random 25% mask against its plain
   version; then the repair-after-extend path of a catching-up
   node, at k = 128 and 64: bench.py's square extended by
   extend_roots_device_resident, erased under bench.py's four masks
   (seeds 7-10, 25%, one row sweep each) and tests/test_repair.py's
   multi-sweep mask (a full row, a full column and a corner: a row and a
   column sweep). Every sweep of every mask: the kernel byte-identical to
   its plain version (the bit-matrix spelling) on the same staged input.
   The main path with the counts from 0: repair_resident_verified under
   every mask (one decode launch per planned sweep, one K2 and one tree
   launch per verify, nothing else) and repair_device (the sweeps alone);
   both return the true EDS, a flipped row or column root raises, the
   caller's resident EDS is unchanged and run() gives the same bytes
   twice. Host ms of plan_sweeps, wall ms of repair_device and of the
   resident cycle (plan, sweeps, root recompute, root compare), median of
   10, the masks in turn; at k = 128 the same two entries with the plan's
   error-locator product through torch (the port) and through numpy's
   BLAS (``repair_levers``: blocks of 2 warm-up and 5 timed calls, the
   spellings in turns, twice), and a device.repair.output bitflip
   under the full audit raises IntegrityError at that site.
6b. Serving reads (``serving``): the ragged gather against its plain
   version byte for byte at every power of two k from 1 to 128 (one
   descriptor, a group with duplicates, 300 descriptors at k = 128), over
   more descriptors and pages than one launch's parameter table holds (one
   launch a table), and over four page geometries in one group (one launch
   each). Then a node (``Node``) with its default paged cache (128 MiB,
   4 heights, 8-row pages) holding four heights of bench.py's square at
   k = 128 (seeds 42-45, extended by da.extend_shares and put as ExtendBlock
   retention puts them): a crowd of 256 samples uniform over the heights
   through sample_batch_ragged, with the counts from 0 (ragged_gather once,
   nothing else), every document equal to the host's from the fetched EDS
   and verified against block_dah(h); ms per sample (median of 5 fresh
   crowds) and the stage split of one, and sample_batch at one height (64
   samples). The same squares and crowd at a budget of 8 pages: the same
   documents, demotions and fault-ins, the device bytes back inside the
   budget and one page after each call, each square's memory freed when its
   handle is dropped (the pages are buffers of their own), ms per sample,
   and one page's demotion, fault-in and CRC32C ms; a cache.faultin bitflip
   drill healing the one height it names; and a ResidentEdsCache node whose
   provers come from one K2 and one tree launch, its proofs the host's.
6c. The proposer's path from transactions (``proposal``): the square
   assembly kernel against its plain version byte for byte at every power
   of two k from 1 to 128 on seven input families (one blob; many blobs of
   random share counts and odd lengths; host cells over blob cells; cells
   no blob or host row covers; no blob; blobs running past the arena's
   end; the arena's alignments: every shift between a share's arena bytes
   and its cell on first and later shares, last shares ending at every
   residue mod 16, and an arena of 7 mod 16 bytes with a blob on its last
   byte), 56 cases, with its registers and spills (none allowed). Then
   bench.py config 8b's traffic
   (60 blobs of 120,000 random bytes, seed 11, each in its own v0
   namespace, a fixed inner tx of a signed PFB's length): the port's
   square.build_ex to a k = 128 square, the blobs staged by put_many into
   a fresh DeviceBlobArena (median of 5), and assembled_proposal_dah with
   the counts from 0 (assemble_square 1, K2 1, K1 3, the tree 1, nothing
   else; the bytes counted at proposal.stage and at arena.stage), its DAH
   equal to roots_device's and to the host NMT DAH of the same square, and
   the MIN/TYPICAL/MAX DAHs through assembled_roots with every cell a host
   cell; host ms of the blob content keys and of the proposal's metadata,
   and the medians of 20 of assembled_proposal_dah and of roots_device on
   the same square, in turns.
6d. The durable store tier (``store``), in a fresh temporary directory
   removed at the end: a node with a home (``Node(home=...)``) holding
   phase 6b's four k = 128 heights persists each through
   _persist_block_eds with the counts from 0 (K2 once and nmt_tree once,
   the row levels; the square fetched once at store.persist), each entry
   with its levels, its stored DAH equal to block_dah's bytes and to the
   extend's roots; ms per height split into fetch (d2h), levels, CRC and
   write (with the fsyncs), and the file size. The same node's crowd gives
   phase 6b's documents. Then a fresh node over the same home (a deep
   re-index of 4 heights, its ms) serves the crowd from disk: ragged_gather
   once and nothing else (every height's provers from the stored levels),
   the documents and DAH bytes equal to those before the restart, pages read
   off disk, ragged_gather equal to its plain version on the store-loaded
   pages; cold and warm ms per sample beside phase 6b's, the cold crowd's
   stage split (disk, crc, h2d, gather, d2h, device, prove), read_page, CRC
   and store fault-in ms a page. The same at device and host budgets of 8
   pages: pages spill and come off disk again, the documents unchanged.
   The drills: a store.read bitflip raises IntegrityError (counted as
   store_read_corrupt_total and sdc_detected_total) and, in a crowd,
   refuses the one height it struck (None; the others as before); a
   truncated and a garbage file are quarantined by the next re-index; and
   ``python -m celestia_tpu_torch.cli store verify`` exits 1 on the damaged
   store and 0 once it is clean.
7. Timing, after warm-up: each kernel at its main-path shapes (K2 at
   k = 64 and 128, on Q0 and on the EDS), as its own device time per launch
   (torch.profiler's CUDA records, mean of 10 launches) and as CUDA-event
   time per launch (median of 10 samples of 10 back-to-back launches),
   beside its bound and its plain version (CUDA events, median of 10 calls;
   3 for K2 on the k = 128 EDS); the tree kernel at k = 64 and 128, on
   both families (an extend's launch) and on the rows with their levels
   (eds_row_levels_device's), beside both terms of its bound
   (``nmt_tree_floor``: all nodes at the card's rate, and one tree's chain
   of levels, rounds only) and the floor of its level-at-a-time design
   (``chain_floor_seconds``); K3 at the shapes of one device DAH (its 10
   launches), bound the same way; the merkle kernel at k = 64 and 128 on
   the tree kernel's roots, beside the same bound and the 10 K3 launches;
   K5/K6 beside the function bound and the XOR spelling's own
   floors (its operations on the ALU pipe, its operand reads from shared
   memory, and this layout's reads); the decode sweep at k = 128 and 64 (a
   random mask's row sweep) beside its bound, counted from
   rs.decode_program and the plan's data (``decode_sweep_work``), and
   its plain version (median of 3); the assembly at config 8b's square
   beside its bound (every cell written, every blob byte and host row read
   once), its copy floor (the device time of one device-to-device copy_
   of the square's 8 MiB: the same bytes moved, not the same function) and
   its plain version (median of 3); and K6 with the layout's levers undone
   one at a time (``xor_levers``: the rows' or the nodes' conflict-free
   order shuffled, 8 groups instead of 4); end to end (host clock, H2D and D2H included) at k = 64 and
   128, 20 calls of roots_device and extend_roots_device_resident per route
   with the routes in turns (median, quartiles, best), and the median of 10
   calls of eds_row_levels_device (which takes an EDS and runs no extend, so
   no route); the dense/XOR routing table by device time (K1 against K5 at
   k = 16, 32, 64 and 128, the only kernels in which the fused routes
   differ); and a torch.profiler breakdown of one k = 128 roots_device and
   one extend_roots_device_resident call per route (device time by op,
   launches, aten ops beside the kernels, H2D copies and their ms, idle
   share), and of the device DAH alone (``merkle_root_pow2`` on the k = 128
   roots); on the fused dense route roots_device must launch no aten op
   (no EDS is assembled) and the resident path at most one (Q0's copy
   into the EDS), and the device DAH none and no H2D copy. The median of
   10 calls of extend_and_root_device at k = 64 and 128.

Every measurement is one JSON line carrying the card's name and power limit.
Then come the ``kernels`` line (the eleven kernels; the ragged gather timed
at the full-width crowd's bucket, its library time the device time of
torch.cat of the bucket's row views; the assembly at config 8b's square), the card as nvidia-smi reports it, and the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import pathlib
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, int8
# tensor-core rate, and 67 TFLOP/s fp32, which is 132 SMs x 128 FP32 lanes x
# 2 x the 1.98 GHz clock used below. Per SM and clock (NVIDIA H100 Tensor
# Core GPU Architecture white paper, the GH100 SM: four sub-partitions, each
# with 16 INT32 lanes, 32 FP32 lanes and one warp instruction dispatched per
# clock): 64 lanes on the integer ALU pipe (LOP3, SHF, IADD3, PRMT), 128 on
# the FMA pipe that also runs IMAD, and 128 issue slots for both together.
# The shared-memory lookup rate is an estimate (one 32-bank wavefront per
# clock per SM: 32 byte lookups without bank conflicts). One SHA-256
# compression's operations are counted from the compiled SASS of K3's block
# loop (phase 1), not estimated.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SMS = 132
CLOCK_HZ = 1.98e9
ALU_LANES = 64
FMA_LANES = 128
ISSUE_LANES = 128
LOOKUPS_PER_S = 32 * SMS * CLOCK_HZ
SMEM_WAVEFRONT_WORDS = 32  # 4-byte words one shared-memory wavefront serves
SHA_ALU_OPS = ("LOP3", "SHF", "IADD3", "PRMT")
# the FFT spelling of the encode, per 4-lane word: a multiply butterfly is 4
# byte permutes (lookup addresses), 3 permutes (assembly) and 2 XORs beside
# its 4 lookups; a butterfly with a zero twiddle is 1 XOR
FFT_MUL_OPS = 9
FFT_PLAIN_OPS = 1
# a multiply by a constant into a new word (the decode's scale and unscale):
# the 4 address and 3 assembling permutes, no XOR
CONST_MUL_OPS = 7
CELL_BYTES = 512  # byte lanes of a share
LEAF_BLOCKS = 9  # 542-byte NMT leaf message
NODE_BLOCKS = 3  # 181-byte NMT node message
DAH_BLOCKS = 2  # 91-byte merkle leaf and 65-byte merkle node messages of the DAH

# pkg/da/data_availability_header_test.go:28, :44, :50
MIN_DAH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
TYPICAL_DAH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
MAX_DAH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"

SEED = 20261017
REPS = 10
E2E_REPS = 20
TABLE_K = (16, 32, 64, 128)  # the routing table's rungs

# route name: (CELESTIA_FUSED_KERNELS, CELESTIA_XOR_SCHEDULE, its encode kernel)
ROUTES = {
    "fused-dense": ("1", "0", "encode2d_hash"),
    "fused-xor": ("1", "1", "encode2d_xor_hash"),
    "unfused-dense": ("0", "0", "encode2d"),
    "unfused-xor": ("0", "1", "encode2d_xor"),
}
PIN_VARS = ("CELESTIA_FUSED_KERNELS", "CELESTIA_XOR_SCHEDULE")


@contextlib.contextmanager
def pinned(route: str):
    """Run the block under the env pins that select ``route``."""
    saved = {v: os.environ.get(v) for v in PIN_VARS}
    os.environ.update(zip(PIN_VARS, ROUTES[route][:2]))
    try:
        yield
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


# the serving phase (6b): four heights of bench.py's square at k = 128 in a
# node's default paged cache, a crowd of 256 samples over them, and the same
# at a budget of 8 pages
SERVING_HEIGHTS = (1, 2, 3, 4)
SERVING_K = 128
SERVING_SAMPLES = 256
SERVING_TIGHT_PAGES = 8

# every kernel of the port: its source and the TPU kernel (or XLA graph) it
# replaces, as the ``kernels`` line names them
KERNEL_SOURCES = {
    "encode2d_hash": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:276"),
    "leaf_digests2d": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:295"),
    "sha256_words": ("celestia_tpu_torch/csrc/sha256_words.cu",
                     "celestia_tpu/ops/sha256_pallas.py:129"),
    "encode2d": ("celestia_tpu_torch/csrc/rs_hash.cu", "celestia_tpu/ops/rs_pallas.py:270"),
    "encode2d_xor_hash": ("celestia_tpu_torch/csrc/xor_schedule.cu",
                          "celestia_tpu/ops/xor_schedule.py:537"),
    "encode2d_xor": ("celestia_tpu_torch/csrc/xor_schedule.cu",
                     "celestia_tpu/ops/xor_schedule.py:476"),
    # the tree form of K3: every NMT level of extend_tpu._nmt_reduce_once
    "nmt_tree": ("celestia_tpu_torch/csrc/nmt_tree.cu", "celestia_tpu/ops/sha256_pallas.py:129"),
    # the repair sweep, an XLA graph in JAX (no Pallas kernel)
    "decode_sweep": ("celestia_tpu_torch/csrc/rs_decode.cu", "celestia_tpu/ops/repair_tpu.py:124"),
    # the merkle form of K3: every level of extend_tpu.merkle_root_pow2
    "dah_merkle": ("celestia_tpu_torch/csrc/dah_merkle.cu", "celestia_tpu/ops/sha256_pallas.py:129"),
    # the ragged cross-height gather, an XLA graph in JAX (no Pallas kernel)
    "ragged_gather": ("celestia_tpu_torch/csrc/ragged_gather.cu", "celestia_tpu/ops/ragged.py:51"),
    "assemble_square": ("celestia_tpu_torch/csrc/assemble_square.cu",
                        "celestia_tpu/ops/extend_tpu.py:766"),
}

# the proposal phase (6c): bench.py config 8b's traffic (bench.py:726-757),
# 60 blobs of 120,000 random bytes (seed 11), each in its own v0 namespace,
# at k = 128. A signed PFB is 333-337 bytes (the JAX package's sign_tx of one
# MsgPayForBlobs); the port cannot sign yet, so each BlobTx carries a fixed
# inner tx of that length, opaque to square construction.
PROPOSAL_K = 128
PROPOSAL_BLOBS = 60
PROPOSAL_BLOB_BYTES = 120_000
PROPOSAL_SEED = 11
PFB_INNER_BYTES = 337
# the assembly kernel's input families (kernel against plain, phase 6c)
ASSEMBLY_FAMILIES = ("one_blob", "many_blobs", "host_over_blob", "uncovered", "no_blobs",
                     "arena_edge", "misaligned")
FIRST_SPARSE, CONT_SPARSE = 478, 482  # data bytes of a blob's first and later shares
FIRST_PREFIX, CONT_PREFIX = 34, 30  # the bytes before them: namespace, info[, length]


def serving_crowd(seed: int, heights, width: int, n: int) -> list[tuple[int, int, int]]:
    """n DAS samples (height, row, column), uniform over the heights and
    over the cells of a width x width square."""
    r = np.random.default_rng(seed)
    hs = r.choice(np.asarray(heights), size=n)
    cells = r.integers(0, width, size=(n, 2))
    return [(int(h), int(i), int(j)) for h, (i, j) in zip(hs, cells)]


def gather_case(pages_of, payloads, rows_per_page: int) -> tuple[list, list[int], list[int]]:
    """The bucket a crowd's ragged gather reads, as the kernel takes it: the
    unique pages in first-use order (``pages_of(h)[i // rows_per_page]``)
    and one (slot, row in page) descriptor per distinct (height, row)."""
    pages, slot_of, slots, rows, seen = [], {}, [], [], set()
    for h, i, _j in payloads:
        if (h, i) in seen:
            continue
        seen.add((h, i))
        key = (h, i // rows_per_page)
        if key not in slot_of:
            slot_of[key] = len(pages)
            pages.append(pages_of(h)[i // rows_per_page])
        slots.append(slot_of[key])
        rows.append(i % rows_per_page)
    return pages, slots, rows


def proposal_txs(seed: int = PROPOSAL_SEED, n: int = PROPOSAL_BLOBS,
                 size: int = PROPOSAL_BLOB_BYTES) -> list[bytes]:
    """bench.py config 8b's blob txs, each blob in its own v0 namespace and
    its data drawn in bench.py's order; the inner tx is a fixed byte string
    of a signed PFB's length with the tx's index in front."""
    from celestia_tpu_torch import blob as blob_pkg
    from celestia_tpu_torch import namespace as ns

    r = np.random.default_rng(seed)
    filler = np.random.default_rng(seed + 1).integers(
        0, 256, PFB_INNER_BYTES - 2, dtype=np.uint8).tobytes()
    txs = []
    for i in range(n):
        data = r.integers(0, 256, size, dtype=np.uint8).tobytes()
        b = blob_pkg.new_blob(ns.new_v0(b"arena" + i.to_bytes(5, "big")), data, 0)
        txs.append(blob_pkg.marshal_blob_tx(i.to_bytes(2, "big") + filler, [b]))
    return txs


def assembly_case(k: int, seed: int, family: str) -> dict[str, np.ndarray]:
    """Inputs of ``extend.assembled_roots`` (its host arrays, and the arena's
    bytes) for one of ASSEMBLY_FAMILIES at k: blobs at strictly ascending
    starts with a random share count each (mostly a full blob's bytes,
    sometimes fewer), the host cells every cell no blob covers, except:
    ``one_blob``, one blob; ``no_blobs``, none, half the cells host cells;
    ``host_over_blob``, a quarter of all cells host cells, blob cells among
    them; ``uncovered``, no host cell, cell 0 before every blob and each
    blob over half its gap (the rest blob 0's namespace and zeros); ``arena_edge``, blobs that run past the
    arena's end (their indexes clamped); ``misaligned``, the arena's
    alignments (``misaligned_blobs``)."""
    if family not in ASSEMBLY_FAMILIES:
        raise ValueError(f"unknown assembly family {family!r}")
    r = np.random.default_rng(seed)
    s = k * k
    n_arena = max(8192, s * 256)
    if family == "misaligned":
        n_arena += 7  # not a multiple of 16: the arena's last vector is partial
        starts, nsh, lens, offs = misaligned_blobs(r, s, n_arena)
    else:
        if family == "no_blobs":
            starts: list[int] = []
        elif family == "one_blob":
            starts = [int(r.integers(0, max(1, s // 4)))]
        elif family == "uncovered" and s > 1:  # cell 0 and each blob's tail uncovered
            starts = sorted(int(x) + 1 for x in r.choice(
                s - 1, size=min(max(1, s // 4), int(r.integers(2, 65))), replace=False))
        else:
            starts = sorted(int(x) for x in r.choice(s, size=min(s, int(r.integers(2, 65))),
                                                     replace=False))
        nsh, lens, offs = [], [], []
        for st, en in zip(starts, starts[1:] + [s]):
            gap = en - st
            n = max(1, gap // 2) if family == "uncovered" else int(r.integers(1, gap + 1))
            full = FIRST_SPARSE + (n - 1) * CONT_SPARSE
            lo = full - CONT_SPARSE + 1 if n > 1 and r.random() < 0.8 else 1
            ln = int(r.integers(lo, full + 1))
            off = (n_arena - ln // 2 if family == "arena_edge"
                   else int(r.integers(0, max(1, n_arena - ln))))
            nsh.append(n)
            lens.append(ln)
            offs.append(off)
    covered = np.zeros(s, bool)
    for st, n in zip(starts, nsh):
        covered[st: st + n] = True
    if family == "host_over_blob":
        pos = np.flatnonzero(r.random(s) < 0.25)
    elif family == "uncovered":
        pos = np.zeros(0, np.int64)
    elif family == "no_blobs":
        pos = np.flatnonzero(r.random(s) < 0.5)
    else:
        pos = np.flatnonzero(~covered)
    h = min(len(pos), 7)
    return {
        "arena": r.integers(0, 256, n_arena, dtype=np.uint8),
        "host_shares": r.integers(0, 256, (h, 512), dtype=np.uint8),
        "host_pos": pos.astype(np.int32),
        "host_row": r.integers(0, max(h, 1), len(pos)).astype(np.int32),
        "blob_start": np.asarray(starts, np.int32),
        "blob_nshares": np.asarray(nsh, np.int32),
        "blob_off": np.asarray(offs, np.int32),
        "blob_len": np.asarray(lens, np.int32),
        "ns_table": r.integers(0, 256, (len(starts), 29), dtype=np.uint8),
    }


def misaligned_blobs(r: np.random.Generator, s: int, n_arena: int):
    """(starts, shares, lengths, offsets) of the ``misaligned`` family over
    s cells: one one-share blob that ends on the arena's last byte, then 16
    blobs whose offsets take every residue mod 16 (so a first share's shift
    takes all 16 values) and whose last shares end at every residue mod 16
    of the cell, one of them a full share; the first even- and odd-offset
    blobs have 9 shares (their later shares' shifts, off + 2 (j - 1) mod 16,
    take the other 8 values each), the rest 1 to 3, at least two of them
    one share. A blob whose shares do not fit after those before it is left
    out; every blob fits from s = 64 (k = 8) on. They lie in the square in
    a random order, with random gaps."""
    res, tails = r.permutation(16), r.permutation(16)
    long_ = {int(np.flatnonzero(res % 2 == 0)[0]), int(np.flatnonzero(res % 2 == 1)[0])}
    short = [i for i in range(16) if i not in long_]
    one = set(short[:2])
    blobs = []  # (shares, length, offset)
    end_len = int(r.integers(1, FIRST_SPARSE + 1))
    blobs.append((1, end_len, n_arena - end_len))
    for i in range(16):
        n = 9 if i in long_ else 1 if i in one else int(r.integers(1, 4))
        cap, prefix = (FIRST_SPARSE, FIRST_PREFIX) if n == 1 else (CONT_SPARSE, CONT_PREFIX)
        if tails[i] == 0:
            last = cap  # ends at the cell's last byte
        else:
            last = int((tails[i] - prefix) % 16) + 16 * int(r.integers(0, cap // 16 - 2))
            last = last or 16
        ln = (0 if n == 1 else FIRST_SPARSE + (n - 2) * CONT_SPARSE) + last
        off = 16 * int(r.integers(0, (n_arena - ln - res[i]) // 16 + 1)) + int(res[i])
        blobs.append((n, ln, off))
    kept, used = [], 0
    for b in blobs:
        if used + b[0] <= s:
            kept.append(b)
            used += b[0]
    kept = [kept[i] for i in r.permutation(len(kept))]
    gaps = r.multinomial(s - used, np.ones(len(kept) + 1) / (len(kept) + 1))
    starts, at = [], 0
    for (n, _ln, _off), g in zip(kept, gaps):
        at += int(g)
        starts.append(at)
        at += n
    return (starts, [b[0] for b in kept], [b[1] for b in kept], [b[2] for b in kept])


def assembly_bytes(k: int, blob_len, host_rows: int) -> int:
    """The bytes the assembly must move: every cell written once, every
    blob byte and every host row read once."""
    return k * k * 512 + int(np.sum(np.asarray(blob_len, np.int64))) + host_rows * 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> tuple[str, str, str]:
    line = smi("name,power.limit")
    name, limit = (s.strip() for s in line.split(",", 1))
    return line, name, limit


def fft_butterflies(multiplies: np.ndarray) -> tuple[int, int]:
    """(multiply, plain) butterflies per lane of an FFT program over k
    positions, one bool a butterfly group, True where its twiddle is
    nonzero (ops/rs.py fft_program and decode_program order: IFFT levels
    with dist 1 -> k/2, then FFT levels with dist k/2 -> 1; a zero twiddle's
    butterflies skip the multiply)."""
    k = len(multiplies) // 2 + 1
    levels = [1 << lv for lv in range(k.bit_length() - 1)]
    dists = [d for d in levels for _ in range(k // (2 * d))]
    dists += [d for d in reversed(levels) for _ in range(k // (2 * d))]
    mul = sum(d for d, m in zip(dists, multiplies.tolist()) if m)
    return mul, sum(dists) - mul


def repair_masks(k: int) -> list[tuple[str, np.ndarray]]:
    """The repair phase's presence masks of a 2k x 2k EDS: bench.py's four
    (seeds 7-10, 25% of the cells erased at random), each one row sweep,
    and tests/test_repair.py's multi-sweep mask (a full row, a full column
    and a corner), a row sweep and then a column sweep."""
    w = 2 * k
    out = []
    for seed in (7, 8, 9, 10):
        r = np.random.default_rng(seed)
        present = np.ones((w, w), dtype=bool)
        present.reshape(-1)[r.choice(w * w, size=int(0.25 * w * w), replace=False)] = False
        out.append((f"random_{seed}", present))
    present = np.ones((w, w), dtype=bool)
    present[1, :] = False
    present[:, 2] = False
    present[0, 0] = False
    out.append(("row_column_corner", present))
    return out


def numpy_locator(erased: np.ndarray) -> np.ndarray:
    """The JAX package's spelling of gf256._error_locator_logs_batch: the
    same product through numpy's float64 dgemm (the port runs it through
    torch); the repair phase times the repair entries under each."""
    from celestia_tpu_torch.ops import gf256

    err = np.zeros((erased.shape[0], gf256.K_ORDER), dtype=np.float64)
    err[:, : erased.shape[1]] = erased
    return (err @ gf256._locator_matrix()).astype(np.int64) % gf256.K_MODULUS


def decode_sweep_work(twiddles: np.ndarray, scale_bytes: np.ndarray,
                      write: np.ndarray) -> dict[str, float]:
    """The work of one decode sweep on its plan's data, counted as
    ``fft_butterflies`` counts the encode: the core's butterflies from the
    decode program's twiddles (``rs.decode_program(n)``: IFFT levels, then
    FFT levels, 0 a zero twiddle) for every axis the sweep writes, each byte a
    lane; a multiply by a per-position constant for every cell read (a
    nonzero scale) and every cell written. ALU operations per 4-lane word:
    FFT_MUL_OPS per multiply butterfly, FFT_PLAIN_OPS per plain one,
    CONST_MUL_OPS per constant multiply; one byte lookup per multiply and
    lane. Bytes: each read and written cell once, and the plan's three
    (w, n) arrays. An axis the sweep writes nothing of needs no work."""
    mul, plain = fft_butterflies(twiddles != 0)
    active = write.any(axis=1)
    axes = int(active.sum())
    reads = int((scale_bytes[active] != 0).sum())
    written = int(write.sum())
    words = CELL_BYTES / 4
    return {
        "axes": axes, "mul_butterflies": mul, "plain_butterflies": plain,
        "reads": reads, "written": written,
        "alu_ops": (axes * (mul * FFT_MUL_OPS + plain * FFT_PLAIN_OPS)
                    + (reads + written) * CONST_MUL_OPS) * words,
        "lookups": (axes * mul + reads + written) * CELL_BYTES,
        "bytes": (reads + written) * CELL_BYTES + 3 * scale_bytes.size,
    }


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory per kernel, from
    nvcc's ``-Xptxas -v`` log, keyed by the mangled kernel name."""
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if name and m:
                out[name][key] = int(m.group(1))
    return out


def sass_functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """(address, opcode with its modifiers, operands) of every instruction of
    every kernel in ``cuobjdump -sass`` output, by mangled kernel name."""
    insn = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;\n]*);")
    out = {}
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)", sass, re.S):
        out[m.group(1)] = [(int(i.group(1), 16), i.group(2), i.group(3).strip())
                           for i in insn.finditer(m.group(2))]
    return out


def sass_mix(sass: str, fragment: str) -> dict[str, collections.Counter]:
    """Opcode counts (without modifiers) of each kernel whose mangled name
    contains ``fragment``."""
    return {name: collections.Counter(op.split(".")[0] for _a, op, _r in lines)
            for name, lines in sass_functions(sass).items() if fragment in name}


def sass_lines(sass: str, fragment: str) -> list[tuple[int, str, str]]:
    """The instructions of the one kernel whose mangled name contains
    ``fragment``."""
    funcs = [lines for name, lines in sass_functions(sass).items() if fragment in name]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} kernels match {fragment!r}")
    return funcs[0]


def sass_loops(lines: list[tuple[int, str, str]]) -> list[collections.Counter]:
    """Opcode counts (with modifiers) of one pass of each loop of a kernel:
    the instructions from the target of a backward branch to that branch,
    widest loop first."""
    loops = []
    for addr, op, args in lines:
        target = re.findall(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else []
        if target and int(target[-1], 16) < addr:
            loops.append((int(target[-1], 16), addr))
    loops.sort(key=lambda t: t[0] - t[1])
    return [collections.Counter(op for addr, op, _ in lines if lo <= addr <= hi)
            for lo, hi in loops]


def block_loop_mix(sass: str, fragment: str) -> collections.Counter:
    """One pass of the kernel's widest loop (K3's: one SHA-256 block)."""
    loops = sass_loops(sass_lines(sass, fragment))
    if not loops:
        raise ValueError(f"no loop in the SASS of {fragment!r}")
    return loops[0]


def opcode_counts(loop: collections.Counter, names) -> dict[str, int]:
    """Instructions of each base opcode in ``names`` (modifiers dropped)."""
    return {name: sum(n for op, n in loop.items() if op.split(".")[0] == name)
            for name in names}


def rounds_loop_mix(sass: str, fragment: str) -> collections.Counter:
    """One pass of the tree kernel's rounds-only loop (compress_kw in
    csrc/nmt_tree.cu: the 64 rounds of a block over a K + W its helper
    threads expanded): the shortest loop whose pass holds exactly 64
    shared-memory loads, one K + W word a round."""
    rounds = [mix for mix in sass_loops(sass_lines(sass, fragment))
              if sum(n for op, n in mix.items() if op.split(".")[0] == "LDS") == 64]
    if not rounds:
        raise ValueError(f"no loop of 64 shared loads in the SASS of {fragment!r}")
    return min(rounds, key=lambda mix: sum(mix.values()))


def sha_block_ops(loop: collections.Counter) -> tuple[int, int]:
    """(ALU-pipe, FMA-pipe) operations of one SHA-256 block in K3's loop:
    LOP3, SHF, IADD3 and PRMT, and IMAD other than the 64-bit IMAD.WIDE
    of the loads' addresses."""
    base = collections.Counter()
    for op, n in loop.items():
        base[op.split(".")[0] if not op.startswith("IMAD.WIDE") else "IMAD.WIDE"] += n
    return sum(base[op] for op in SHA_ALU_OPS), base["IMAD"]


def pipe_seconds(alu: float, fma: float) -> float:
    """The least time for ``alu`` ALU-pipe and ``fma`` FMA-pipe lane
    operations on the card: each pipe at its lane rate, and both within the
    issue rate."""
    return max(alu / ALU_LANES, fma / FMA_LANES, (alu + fma) / ISSUE_LANES) / (SMS * CLOCK_HZ)


def chain_block_seconds(alu: float, fma: float) -> float:
    """One warp's SHA-256 block alone on an SM sub-partition (16 ALU lanes,
    32 FMA lanes, one warp instruction issued a clock): the latency floor
    of a chain of compressions."""
    warp = 32
    return max(alu * warp / (ALU_LANES / 4), fma * warp / (FMA_LANES / 4),
               (alu + fma) * warp / (ISSUE_LANES / 4)) / CLOCK_HZ


def chain_floor_seconds(level_messages, blocks: int, alu: float, fma: float) -> float:
    """The least time of a tree hashed one whole level after another, level
    i hashing level_messages[i] messages of ``blocks`` SHA-256 blocks: each
    level at least its throughput time and at least one chain of its
    blocks. This is the floor of that design (one launch a level, or every
    tree's level at once), not of the function: independent subtrees need
    not wait for each other's levels."""
    return sum(max(pipe_seconds(m * blocks * alu, m * blocks * fma),
                   blocks * chain_block_seconds(alu, fma)) for m in level_messages)


def tree_chain_seconds(depth: int, blocks: int, round_alu: float, round_fma: float) -> float:
    """One tree's critical path: ``depth`` dependent messages of ``blocks``
    SHA-256 blocks, each block at least its 64 rounds (``round_alu`` and
    ``round_fma`` operations) at one warp's issue rate. The message
    schedule is off that path: other threads can expand it beforehand."""
    return depth * blocks * chain_block_seconds(round_alu, round_fma)


def dah_levels(k: int) -> list[int]:
    """Messages of each level of a DAH's merkle tree over its 4k axis
    roots: the 4k leaves, then 2k, k, ..., 1 nodes (2 SHA-256 blocks each)."""
    return [4 * k >> lv for lv in range((4 * k).bit_length())]


def nmt_tree_levels(k: int, families: int) -> list[int]:
    """Inner nodes of each level of ``families`` families of 2k NMT trees of
    2k leaves, leaves' parents first."""
    w = 2 * k
    return [families * w * (w >> lv) for lv in range(1, w.bit_length())]


def nmt_tree_floor(k: int, families: int, alu: float, fma: float, round_alu: float,
                   round_fma: float) -> tuple[float, float]:
    """(throughput, chain) in seconds, the two terms of the least time of
    the NMT inner nodes of ``families`` families of 2k trees of 2k leaves
    (3 SHA-256 blocks a node): all nodes at the card's rate (a block is
    ``alu`` + ``fma`` operations), and one tree's log2(2k) levels of 3
    blocks' rounds in a row. The bound is the larger."""
    levels = nmt_tree_levels(k, families)
    throughput = pipe_seconds(sum(levels) * NODE_BLOCKS * alu, sum(levels) * NODE_BLOCKS * fma)
    return throughput, tree_chain_seconds(len(levels), NODE_BLOCKS, round_alu, round_fma)


def hashlib_merkle(items: np.ndarray) -> bytes:
    """RFC-6962 merkle root of (n, D) items through hashlib, n a power of
    two (leaf SHA-256(0x00 ‖ item), node SHA-256(0x01 ‖ left ‖ right))."""
    nodes = [hashlib.sha256(b"\x00" + it.tobytes()).digest() for it in items]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(b"\x01" + nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def shuffled_layout_prog(layout, seed: int, rows: bool, nodes: bool) -> np.ndarray:
    """K5/K6's programs with the conflict-free operand order undone (a lever
    measurement): each thread's row steps, or each level's node entries,
    in a random order. The reads, and so the parity, are unchanged; only
    which bank groups a quarter's eight threads hit at a step."""
    from celestia_tpu_torch.ops import xor_cuda

    rng = np.random.default_rng(seed)
    prog = layout.prog.copy()
    head, threads = xor_cuda.HEADER, xor_cuda.ENC_THREADS
    for g in range(layout.groups):
        p = prog[g]
        if nodes:
            for lv in range(layout.n_levels):
                count, off = p[head + lv], p[head + layout.n_levels + lv]
                entries = p[off: off + 2 * count].reshape(-1, 2)
                p[off: off + 2 * count] = entries[rng.permutation(len(entries))].reshape(-1)
        if rows:
            pairs, words = layout.row_program(g)
            pairs = pairs.copy()
            for t in range(threads):
                n = int(words[t] >> 16)
                slots = np.stack([pairs[:n, t] & 0xFFFF, pairs[:n, t] >> 16], 1).reshape(-1)
                slots = slots[rng.permutation(len(slots))].reshape(-1, 2)
                pairs[:n, t] = slots[:, 0] | (slots[:, 1] << 16)
            smem_words, _n, reg_off, _w, vec_off = (int(v) for v in p[:head])
            reg = min(layout.max_pairs, xor_cuda.REG_PAIRS)
            p[reg_off: reg_off + reg * threads] = pairs[:reg].reshape(-1)
            p[vec_off: smem_words] = pairs[reg:].reshape(-1, 4, threads).transpose(0, 2, 1).reshape(-1)
    return prog


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xor-table-out", default=None,
                    help="also write the measured dense/XOR routing table here")
    ap.add_argument("--sass-out", default=None,
                    help="also write the SASS of K2, K3 and the tree kernel "
                         "(cuobjdump -sass) here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from celestia_tpu_torch import da, faults, integrity
    from celestia_tpu_torch import namespace as ns
    from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
    from celestia_tpu_torch.app import calibration
    from celestia_tpu_torch.ops import _cuda, extend, gf256, merkle_cuda, nmt_cuda, nmt_host, rs
    from celestia_tpu_torch.ops import rs_cuda
    from celestia_tpu_torch.ops import sha256, sha256_cuda, transfers, xor_cuda, xor_schedule
    from celestia_tpu_torch.telemetry import metrics

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

    max_err = dict.fromkeys(_cuda.LAUNCHES, 0)

    def same(name: str, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
        err = int((as_i64(a) - as_i64(b)).abs().max()) if a.numel() else 0
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{what}: kernel differs from its plain version (max abs err {err})")

    def dev_bytes(shape) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    # ---- phase 1: environment and build
    emit(phase="environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count(),
         sm_count=torch.cuda.get_device_properties(0).multi_processor_count,
         max_sm_clock=smi("clocks.max.sm"))
    t0 = time.perf_counter()
    lib = _cuda.library()
    emit(phase="build", seconds=time.perf_counter() - t0)
    for line in _cuda.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip(), file=sys.stderr)
    sha_kernels = ("leaf_digests2d_kernel", "sha256_words_kernel", "nmt_tree_kernel",
                   "dah_merkle_kernel")
    for name, report in ptxas_report(_cuda.build_log()).items():
        if any(f in name for f in ("encode2d_fft_kernel", "encode2d_xor_kernel",
                                   "decode_sweep_kernel", "ragged_gather_kernel",
                                   "assemble_square_kernel",
                                   *sha_kernels)):
            emit(phase="ptxas", kernel=name, **report)
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    for fragment in ("encode2d_fft_kernelILi128E", "decode_sweep_kernelILi256E", *sha_kernels):
        for kname, mix in sass_mix(sass, fragment).items():
            emit(phase="sass_mix", kernel=kname, instructions=sum(mix.values()),
                 ops=dict(mix.most_common(10)))
    # one pass of the decode sweep's work-item loop (its widest) at n = 256:
    # the lookups (LDS), their addresses and products (PRMT) and the rest
    decode_pass = block_loop_mix(sass, "decode_sweep_kernelILi256E")
    emit(phase="sass_mix", kernel="decode_sweep_kernel<256>", scope="one work item",
         instructions=sum(decode_pass.values()),
         per_pass=opcode_counts(decode_pass, ("LDS", "PRMT", "LOP3", "SHF", "IMAD", "IADD3",
                                              "LDG", "STG", "BAR")))
    emit(phase="occupancy", kernel="nmt_tree_kernel",
         blocks_per_sm=lib.celestia_nmt_tree_blocks_per_sm(0))
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            for fragment in sha_kernels:
                f.writelines(f"/*{a:04x}*/ {op} {arg};\n"
                             for a, op, arg in sass_lines(sass, fragment))
    # one SHA-256 block as compiled: a pass of K3's block loop (its 16 loads,
    # their addresses and the loop's own counter aside)
    k3_loop = block_loop_mix(sass, "sha256_words_kernel")
    sha_alu, sha_fma = sha_block_ops(k3_loop)
    check(1000 < sha_alu + sha_fma < 3000,
          f"K3's loop holds {sha_alu} + {sha_fma} SHA operations: not one compression")
    emit(phase="sha_block_count", kernel="sha256_words_kernel", alu_ops=sha_alu,
         fma_ops=sha_fma, loop_instructions=sum(k3_loop.values()),
         loop_ops=dict(k3_loop.most_common()))
    # one block's 64 rounds alone, the message schedule aside (the tree
    # kernel's rounds-only loop): the chain term of the SHA tree bounds
    r_loop = rounds_loop_mix(sass, "nmt_tree_kernel")
    round_alu, round_fma = sha_block_ops(r_loop)
    check(400 < round_alu < sha_alu,
          f"the tree kernel's rounds loop holds {round_alu} ALU operations: not 64 rounds")
    emit(phase="sha_rounds_count", kernel="nmt_tree_kernel", alu_ops=round_alu,
         fma_ops=round_fma, loop_instructions=sum(r_loop.values()),
         loop_ops=dict(r_loop.most_common()))
    t0 = time.perf_counter()
    xor_schedule.compile_schedule(128)  # host time at first use, before any timing
    emit(phase="xor_compile", k=128, seconds=time.perf_counter() - t0,
         **xor_schedule.schedule_stats(128))
    # K5/K6's layout at every rung of the routing table: the block groups
    # (no thread-block cluster: cluster size 1), the row segments, the row
    # program's step pairs, shared memory per block, and the padding of the
    # conflict-free operand order (zero-plane reads over real ones)
    for kk in TABLE_K:
        t0 = time.perf_counter()
        lay = xor_cuda.schedule_operands(kk, dev).layout
        emit(phase="xor_layout", k=kk, seconds=time.perf_counter() - t0, cluster_size=1,
             groups=lay.groups, segs=lay.segs, max_pairs=lay.max_pairs,
             register_pairs=min(lay.max_pairs, xor_cuda.REG_PAIRS), slots=lay.n_slots,
             smem_bytes_k6=lay.smem_bytes(hashed=False), smem_bytes_k5=lay.smem_bytes(hashed=True),
             reads_per_32_lanes=lay.reads, padded_reads_per_32_lanes=lay.padded_reads,
             padding=lay.padded_reads / lay.reads - 1)

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
    # K3's merkle form at every power-of-two k, one DAH and a batch of 3
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        for b in (1, 3):
            roots = dev_bytes((b, 4 * k, merkle_cuda.ROOT_SIZE))
            got = merkle_cuda.dah_merkle(roots)
            same("dah_merkle", got, merkle_cuda.dah_merkle_reference(roots),
                 f"dah_merkle k={k} B={b}")
            host = roots.cpu().numpy()
            check(all(got[i].cpu().numpy().tobytes() == hashlib_merkle(host[i])
                      for i in range(b)), f"dah_merkle k={k} B={b} differs from hashlib")
    emit(phase="kernel_vs_plain", kernel="dah_merkle", k=[1, 2, 4, 8, 16, 32, 64, 128],
         batches=[1, 3], tolerance=0, max_abs_err=max_err["dah_merkle"], hashlib=True)

    def identical(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(a.shape == b.shape and bool(torch.equal(a, b)), f"{what}: not byte-identical")

    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        x2 = dev_bytes((k, k * SHARE_SIZE))
        m2 = rs.encode_matrix(k, dev)
        ops = xor_cuda.schedule_operands(k, dev)
        parity, digests = rs_cuda.encode2d_hash(x2, m2)
        ref_parity, ref_digests = rs_cuda.encode2d_hash_reference(x2, m2)
        same("encode2d_hash", parity, ref_parity, f"K1 parity k={k}")
        same("encode2d_hash", digests, ref_digests, f"K1 digests k={k}")
        # K2 at the main path's two shapes: Q0 (k, k·512) and an EDS (2k, 2k·512)
        for rows in (k, 2 * k):
            xl = x2 if rows == k else dev_bytes((rows, rows * SHARE_SIZE))
            ns_pad = dev_bytes((rows, rows, rs_cuda.NS_PAD))
            same("leaf_digests2d", rs_cuda.leaf_digests2d(xl, ns_pad),
                 rs_cuda.leaf_digests2d_reference(xl, ns_pad), f"K2 ({rows}, {rows}*512)")
        p4 = rs_cuda.encode2d(x2, m2)
        same("encode2d", p4, rs_cuda.encode2d_reference(x2, m2), f"K4 k={k}")
        p5, d5 = xor_cuda.encode2d_xor_hash(x2, ops)
        ref5, ref_d5 = xor_cuda.encode2d_xor_hash_reference(x2, ops)
        same("encode2d_xor_hash", p5, ref5, f"K5 parity k={k}")
        same("encode2d_xor_hash", d5, ref_d5, f"K5 digests k={k}")
        p6 = xor_cuda.encode2d_xor(x2, ops)
        same("encode2d_xor", p6, xor_cuda.encode2d_xor_reference(x2, ops), f"K6 k={k}")
        # the FFT and XOR spellings are one code: their kernels agree
        identical(p5, parity, f"K5 parity vs K1, k={k}")
        identical(d5, digests, f"K5 digests vs K1, k={k}")
        identical(p6, p4, f"K6 vs K4, k={k}")
        identical(p4, parity, f"K4 vs K1, k={k}")
        emit(phase="kernel_vs_plain", k=k, tolerance=0,
             kernels=["encode2d_hash", "leaf_digests2d", "encode2d", "encode2d_xor_hash",
                      "encode2d_xor"],
             max_abs_err=max(max_err[n] for n in max_err if n != "sha256_words"),
             dense_equals_xor=True)
    # K2 at row counts that are no multiple of its 64-thread block
    for rows in (1, 3, 65):
        xl, ns_pad = dev_bytes((rows, 2 * SHARE_SIZE)), dev_bytes((rows, 2, rs_cuda.NS_PAD))
        same("leaf_digests2d", rs_cuda.leaf_digests2d(xl, ns_pad),
             rs_cuda.leaf_digests2d_reference(xl, ns_pad), f"K2 ({rows}, 1024)")
    emit(phase="kernel_vs_plain", kernel="leaf_digests2d", tolerance=0,
         shapes="(k, k*512) and (2k, 2k*512) for k = 1..128; (1|3|65, 1024)",
         max_abs_err=max_err["leaf_digests2d"])

    # K1 and K4 in the strided layouts the main path uses: the three
    # quadrant encodes in place in one (2k, 2k, 512) EDS (Q0 read from its
    # quadrant, Q3 reading Q2 where Q2 was written) and the roots-only
    # core's scratch layout (Q0 contiguous, row extends into unread
    # buffers); the whole EDS, untouched bytes included, equals the plain
    # version's. K2 with each cell's namespace read from the cell (Q0).
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        m2 = rs.encode_matrix(k, dev)
        eds = dev_bytes((2 * k, 2 * k, SHARE_SIZE))
        for layout in ("eds", "scratch"):
            for name, fn, ref in (
                    ("encode2d_hash", rs_cuda.encode_hash_into, rs_cuda.encode_hash_into_reference),
                    ("encode2d", rs_cuda.encode_into, rs_cuda.encode_into_reference)):
                a, b = eds.clone(), eds.clone()
                if layout == "eds":
                    qa, qb = rs_cuda.eds_quadrants(a, a[:k, :k]), rs_cuda.eds_quadrants(b, b[:k, :k])
                else:
                    qa = extend._scratch_quadrants(a[:k, :k].contiguous())
                    qb = extend._scratch_quadrants(b[:k, :k].contiguous())
                for i, ((sa, da_), (sb, db_)) in enumerate(zip(qa, qb)):
                    out, want = fn(sa, da_, m2), ref(sb, db_, m2)
                    if out is not None:
                        same(name, out, want, f"{name} digests {layout} quadrant {i} k={k}")
                    same(name, da_, db_, f"{name} parity {layout} quadrant {i} k={k}")
                same(name, a, b, f"{name} {layout} square k={k}")
        x2 = eds[:k, :k].contiguous().reshape(k, k * SHARE_SIZE)
        same("leaf_digests2d", rs_cuda.leaf_digests2d(x2, rs_cuda.own_namespaces(x2)),
             rs_cuda.leaf_digests2d_reference(x2, rs_cuda.own_namespaces(x2)),
             f"K2 own namespaces k={k}")
        emit(phase="strided_vs_plain", k=k, tolerance=0, layouts=["eds", "scratch"],
             kernels=["encode2d_hash", "encode2d", "leaf_digests2d (own namespaces)"],
             strides_bytes={"column_extend": [2 * k * SHARE_SIZE, SHARE_SIZE],
                            "row_extend": [SHARE_SIZE, 2 * k * SHARE_SIZE]},
             max_abs_err=max(max_err["encode2d_hash"], max_err["encode2d"],
                             max_err["leaf_digests2d"]))

    # the tree kernel on random digests in the fused route's layout (Q1 and
    # Q3 [col, row] tensors passed transposed, the namespaces a view of the
    # shares): the roots of both families (an extend's call), and the row
    # roots with every row level (eds_row_levels_device's), against the
    # plain level loop
    def tree_square(k: int, kind: str) -> torch.Tensor:
        sq = rng.integers(0, 256, size=(k, k, SHARE_SIZE), dtype=np.uint8)
        subs = sorted(rng.integers(0, 200, size=(k * k, 10), dtype=np.uint8).tolist())
        nss = [ns.new_v0(bytes(sub)).bytes for sub in subs]
        if kind == "tail_padding":
            nss[k * k - max(1, k * k // 3):] = [ns.TAIL_PADDING_NAMESPACE.bytes] * max(1, k * k // 3)
        elif kind == "single_namespace":
            nss = [nss[0]] * (k * k)
        sq.reshape(k * k, SHARE_SIZE)[:, :NAMESPACE_SIZE] = np.frombuffer(
            b"".join(nss), np.uint8).reshape(k * k, NAMESPACE_SIZE)
        return torch.from_numpy(sq).to(dev)

    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        for kind in ("random", "tail_padding", "single_namespace"):
            grid = dev_bytes((2 * k, 2 * k, 32)).view(torch.int32).view(torch.uint32)
            d1t = grid[:k, k:].transpose(0, 1).contiguous()
            d3t = grid[k:, k:].transpose(0, 1).contiguous()
            quads = (grid[:k, :k].contiguous(), d1t.transpose(0, 1),
                     grid[k:, :k].contiguous(), d3t.transpose(0, 1))
            q0_ns = tree_square(k, kind)[..., :NAMESPACE_SIZE]
            roots, _ = nmt_cuda.nmt_tree(quads, q0_ns)
            ref_roots, _ = nmt_cuda.nmt_tree_reference(quads, q0_ns)
            same("nmt_tree", roots, ref_roots, f"nmt_tree roots k={k} {kind}")
            rows, levels = nmt_cuda.nmt_tree(quads, q0_ns, keep_levels=True)
            ref_rows, ref_levels = nmt_cuda.nmt_tree_reference(quads, q0_ns, keep_levels=True)
            same("nmt_tree", rows, ref_rows, f"nmt_tree row roots k={k} {kind}")
            same("nmt_tree", levels, ref_levels, f"nmt_tree row levels k={k} {kind}")
            identical(rows[0], roots[0], f"nmt_tree row roots of both calls, k={k} {kind}")
        emit(phase="kernel_vs_plain", kernel="nmt_tree", k=k, tolerance=0,
             squares=["random", "tail_padding", "single_namespace"],
             outputs=["roots (rows, columns)", "row roots and row levels"],
             max_abs_err=max_err["nmt_tree"])
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
    for rname in ROUTES:
        for label, k, share, expect in oracles:
            flat = (np.frombuffer(share, np.uint8)[None] if share is not None
                    else oracle_square(k * k))
            with pinned(rname):
                if label == "MIN":
                    got = da.min_data_availability_header(dev).hash().hex()
                else:
                    got = da.new_data_availability_header(
                        da.extend_shares(flat, dev)).hash().hex()
                _eds, rows, cols, dah = extend.extend_and_root_device(
                    flat.reshape(k, k, SHARE_SIZE), dev)
            check(got == expect, f"{label} DAH on {rname}: {got} != {expect}")
            check(dah.tobytes().hex() == expect == host_dah(rows, cols).hex(),
                  f"{label} device DAH on {rname} differs from the host DAH")
            emit(phase="oracle", route=rname, name=label, k=k, dah=got)

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
    encoders = {enc for _f, _x, enc in ROUTES.values()}
    launches: dict[str, int] = {}
    main: dict[str, tuple] = {}
    for rname, (_f, _x, enc) in ROUTES.items():
        with pinned(rname):
            torch.cuda.synchronize()
            _cuda.reset_launches()
            r_eds = da.extend_shares(main_sq.reshape(-1, SHARE_SIZE), dev)
            r_dah = da.new_data_availability_header(r_eds)
            r_levels = extend.eds_row_levels_device(r_eds.device_data, dev)
            torch.cuda.synchronize()
            counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route=rname, k=main_sq.shape[0],
             entry="da.extend_shares+new_data_availability_header+eds_row_levels_device",
             launches=counts, dah=r_dah.hash().hex())
        for kname in (enc, "leaf_digests2d", "nmt_tree"):
            check(counts[kname] > 0, f"the {rname} main path launched {kname} no time")
        # one tree launch for the extend, one for the row levels; no K3
        check(counts["nmt_tree"] == 2, f"the {rname} main path launched nmt_tree "
                                       f"{counts['nmt_tree']} times, expected 2")
        check(counts["sha256_words"] == 0, f"the {rname} main path launched sha256_words")
        for other in encoders - {enc}:
            check(counts[other] == 0, f"the {rname} main path launched {other}")
        launches[enc] = counts[enc]
        if rname == "fused-dense":
            launches["leaf_digests2d"] = counts["leaf_digests2d"]
            launches["nmt_tree"] = counts["nmt_tree"]
        main[rname] = (r_eds, r_dah, r_levels)
    main_eds, main_dah, main_levels = main["fused-dense"]
    # the device DAH: K3's merkle form, one launch over the 4k axis roots
    # (its main_path line, with the DAH's aten ops and the entry's wall ms,
    # comes with the timing of phase 7)
    with pinned("fused-dense"):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        dah_dev = extend.extend_and_root_device(main_sq, dev)[3]
        torch.cuda.synchronize()
        dah_counts = dict(_cuda.LAUNCHES)
    check(dah_dev.tobytes() == main_dah.hash(), "extend_and_root_device DAH != main path DAH")
    check(dah_counts["dah_merkle"] == 1 and dah_counts["sha256_words"] == 0
          and dah_counts["nmt_tree"] == 1,
          f"extend_and_root_device launched {dah_counts}: expected dah_merkle 1, "
          f"sha256_words 0, nmt_tree 1")
    launches["dah_merkle"] = dah_counts["dah_merkle"]
    launches["sha256_words"] = dah_counts["sha256_words"]

    squares = [("realistic", 64, realistic(64, 0)), ("tail_padding", 64, realistic(64, 700)),
               ("realistic", 128, main_sq), ("tail_padding", 128, realistic(128, 3000))]
    for label, k, sq in squares:
        with pinned("fused-dense"):
            got = extend.extend_and_root_device(sq, dev)
            plain = extend.extend_and_root_device(sq, dev, kernels=extend.PLAIN)
            rows, cols = extend.roots_device(sq, dev)
        for part, a, b in zip(("eds", "rows", "cols", "dah"), got, plain):
            check(np.array_equal(a, b), f"{label} k={k}: kernel route {part} != plain route")
        check(got[3].tobytes() == host_dah(got[1], got[2]), f"{label} k={k}: device DAH != host DAH")
        levels = extend.eds_row_levels_device(got[0], dev)
        plain_levels = extend.eds_row_levels_device(got[0], dev, kernels=extend.PLAIN)
        check(len(levels) == len(plain_levels) == int(np.log2(2 * k)) + 1, "level count")
        for a, b in zip(levels, plain_levels):
            check(np.array_equal(a, b), f"{label} k={k}: row levels differ from plain")
        check(np.array_equal(levels[-1][:, 0], got[1]), f"{label} k={k}: levels' roots")
        check(np.array_equal(rows, got[1]) and np.array_equal(cols, got[2]), "roots_device")
        e_rows, e_cols = extend.eds_roots_device(got[0], dev)
        check(np.array_equal(e_rows, got[1]) and np.array_equal(e_cols, got[2]),
              "eds_roots_device")
        if k == 64:
            h_rows, h_cols = host_oracle_roots(sq)
            check(np.array_equal(rows, h_rows) and np.array_equal(cols, h_cols),
                  f"{label} k=64: roots differ from the host oracle")
        # every other route: its kernels equal its plain versions and the
        # fused dense route
        for rname in ROUTES:
            if rname == "fused-dense":
                continue
            with pinned(rname):
                r_got = extend.extend_and_root_device(sq, dev)
                r_plain = extend.extend_and_root_device(sq, dev, kernels=extend.PLAIN)
                r_rows, r_cols = extend.roots_device(sq, dev)
            for part, a, b, c in zip(("eds", "rows", "cols", "dah"), r_got, r_plain, got):
                check(np.array_equal(a, b), f"{label} k={k} {rname}: kernel {part} != plain")
                check(np.array_equal(a, c), f"{label} k={k} {rname}: {part} != fused dense")
            check(np.array_equal(r_rows, rows) and np.array_equal(r_cols, cols),
                  f"{label} k={k} {rname}: roots_device")
        if sq is main_sq:
            for rname, (r_eds, r_dah, r_levels) in main.items():
                check(np.array_equal(r_eds.data, got[0]), f"main path EDS on {rname}")
                check(r_dah.hash() == got[3].tobytes(), f"main path DAH on {rname}")
                for a, b in zip(r_levels, levels):
                    check(np.array_equal(a, b), f"main path row levels on {rname}")
        emit(phase="route_vs_plain", square=label, k=k, routes=list(ROUTES),
             dah=got[3].tobytes().hex(), host_oracle=(k == 64))

    # ---- phase 5: the block path around the kernels (roots-only core,
    # batched roots, staging, integrity, sliced reads)
    def wall_ms(fn, reps: int = REPS) -> float:
        """Median host time of ``fn`` until the card is done, after two
        warm-up calls."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def cuda_event_ms(fn, reps: int = REPS) -> float:
        """Median CUDA-event time of one call, after two warm-up calls."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    sq64 = squares[0][2]
    # the roots-only core (no EDS assembled) against the resident path's
    # roots and the plain route, on every route
    for rname in ROUTES:
        with pinned(rname):
            for kk, sq in ((64, sq64), (128, main_sq)):
                rows, cols = extend.roots_device(sq, dev)
                _eds, r_rows, r_cols = extend.extend_roots_device_resident(sq, dev)
                p_rows, p_cols = extend._rows_cols_only(
                    torch.from_numpy(sq).to(dev), rs.encode_matrix(kk, dev), kernels=extend.PLAIN)
                check(np.array_equal(rows, r_rows) and np.array_equal(cols, r_cols),
                      f"roots_device != extend_roots_device_resident on {rname} k={kk}")
                check(np.array_equal(rows, p_rows.cpu().numpy())
                      and np.array_equal(cols, p_cols.cpu().numpy()),
                      f"the roots-only core != its plain route on {rname} k={kk}")
        emit(phase="roots_only", route=rname, k=[64, 128], equals_resident_roots=True,
             equals_plain_route=True)

    # batched roots (the replay verifier's entry): squares with the same
    # sorted namespaces and other bytes, byte-identical to one roots_device
    # a square, lists and stacked; ms per square beside roots_device's
    def variant(sq: np.ndarray) -> np.ndarray:
        out = sq.copy()
        out[..., NAMESPACE_SIZE:] = rng.integers(0, 256, size=out[..., NAMESPACE_SIZE:].shape,
                                                 dtype=np.uint8)
        return out

    for kk, base in ((64, sq64), (128, main_sq)):
        pool = [variant(base) for _ in range(8)]
        singles = [extend.roots_device(sq, dev) for sq in pool]
        for b in (1, 2, 4, 8):
            for form, shares in (("list", pool[:b]), ("stacked", np.stack(pool[:b]))):
                rows, cols = extend.batched_roots_device(shares, dev)
                check(all(np.array_equal(rows[i], singles[i][0])
                          and np.array_equal(cols[i], singles[i][1]) for i in range(b)),
                      f"batched_roots_device ({form}) B={b} k={kk} != roots_device")
            batched = wall_ms(lambda s=pool[:b]: extend.batched_roots_device(s, dev), reps=5)
            single = wall_ms(lambda s=pool[:b]: [extend.roots_device(q, dev) for q in s], reps=5)
            emit(phase="batched", k=kk, batch=b, chunk=extend._batch_chunk(kk, b),
                 identical=True, ms_per_square=batched / b,
                 roots_device_ms_per_square=single / b)

    # staging: the k = 128 square to the card, until the card has it
    nbytes = main_sq.nbytes
    staged = {}
    stage_ms = {}
    for c in (1, 2, 4, 8):
        def put(c=c):
            staged[f"chunks_{c}"] = transfers.device_put_chunked(main_sq, dev, site="smoke.staging",
                                                                 chunks=c)
        stage_ms[f"chunks_{c}"] = wall_ms(put)
    src_pageable = torch.from_numpy(main_sq)
    src_pinned = src_pageable.pin_memory()

    def put_pageable():
        staged["pageable_to"] = src_pageable.to(dev)

    def put_pinned():
        staged["pinned_to"] = src_pinned.to(dev, non_blocking=True)

    stage_ms["pageable_to"] = wall_ms(put_pageable)
    stage_ms["pinned_to"] = wall_ms(put_pinned)
    # the host's share: the square into pinned memory, by numpy (one
    # thread) and by torch (its thread pool, as device_put_chunked does)
    pinned_host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    stage_ms["host_copy_to_pinned_numpy"] = wall_ms(
        lambda: np.copyto(pinned_host.numpy(), main_sq.reshape(-1)))
    stage_ms["host_copy_to_pinned_torch"] = wall_ms(
        lambda: pinned_host.copy_(src_pageable.reshape(-1)))
    check(np.array_equal(staged["pageable_to"].cpu().numpy(), main_sq),
          "staging: the pageable copy differs")
    for name, t in staged.items():
        check(torch.equal(t, staged["pageable_to"]), f"staging {name}: bytes differ")
    emit(phase="staging", k=128, bytes=nbytes, ms=stage_ms,
         gb_per_s={n: nbytes / (v * 1e6) for n, v in stage_ms.items()},
         identical=True, auto_chunks=transfers._auto_chunks(nbytes, 128),
         host_threads=torch.get_num_threads())
    # the staging levers end to end: fused dense roots_device at k = 128
    # with the chunk rule (transfers._auto_chunks), with one chunk, and with
    # the monolithic pageable copy in place of the staging, in turns
    def pageable_stage(arr, d):
        return torch.from_numpy(np.asarray(arr)).to(d)

    rule, stage = transfers._auto_chunks, extend._stage
    levers = {"chunk_rule": (rule, stage), "one_chunk": (lambda _n, _r: 1, stage),
              "pageable_to": (rule, pageable_stage)}
    lever_ms: dict[str, list[float]] = {name: [] for name in levers}
    try:
        with pinned("fused-dense"):
            for rep in range(2 + E2E_REPS):
                for name, (chunk_rule, stage_fn) in levers.items():
                    transfers._auto_chunks, extend._stage = chunk_rule, stage_fn
                    t = time.perf_counter()
                    extend.roots_device(main_sq, dev)  # ends in a D2H copy of the roots
                    if rep >= 2:
                        lever_ms[name].append((time.perf_counter() - t) * 1e3)
    finally:
        transfers._auto_chunks, extend._stage = rule, stage
    emit(phase="staging_levers", k=128, route="fused-dense", entry="roots_device",
         median_ms={n: statistics.median(v) for n, v in lever_ms.items()},
         q1_q3_ms={n: statistics.quantiles(v, n=4)[::2] for n, v in lever_ms.items()},
         samples=E2E_REPS)

    # integrity: the syndrome through K4 against its plain version, clean
    # and with one flipped parity bit, at sampled (q = 4) and full (q = 2k)
    eds_main = main_eds.device_data
    for level, q in (("sampled", 4), ("full", 256)):
        draw = random.Random(SEED)
        ri = np.asarray(draw.sample(range(256), q), dtype=np.int32)
        ci = np.asarray(draw.sample(range(256), q), dtype=np.int32)
        bad = eds_main.clone()
        bad[int(ri[0]), 200, 7:8].bitwise_xor_(4)  # a parity cell of a sampled row
        counts = {}
        for label, sq in (("clean", eds_main), ("flipped", bad)):
            got = int(integrity.syndrome(sq, ri, ci))
            want = int(integrity.syndrome(sq, ri, ci, rs_cuda.encode_into_reference))
            check(got == want, f"syndrome {level} {label}: K4 {got} != plain {want}")
            counts[label] = got
        check(counts["clean"] == 0 and counts["flipped"] > 0, f"syndrome {level}: {counts}")
        emit(phase="integrity", level=level, k=128, q=q, counts=counts,
             device_ms=cuda_event_ms(lambda: integrity.syndrome(eds_main, ri, ci)),
             plain_ms=cuda_event_ms(
                 lambda: integrity.syndrome(eds_main, ri, ci, rs_cuda.encode_into_reference),
                 reps=3),
             wall_ms=wall_ms(lambda: int(integrity.syndrome(eds_main, ri, ci))))
    # the drills: a flipped extend output must raise with the plain count,
    # a transient transfer.chunk flip heal on its retry, a persistent one raise
    integrity.configure("full", q=4, seed=SEED)
    try:
        with faults.inject(faults.rule("device.extend.output", "bitflip"), seed=SEED):
            try:
                extend.extend_roots_device_resident(main_sq, dev)
                fail("a device.extend.output bitflip passed the full audit")
            except integrity.IntegrityError as err:
                caught = err
        draw = random.Random(SEED)
        rows_all, cols_all = draw.sample(range(256), 256), draw.sample(range(256), 256)
        plain_count = int(integrity.syndrome(torch.from_numpy(caught.eds).to(dev), rows_all,
                                             cols_all, rs_cuda.encode_into_reference))
        plain_count += integrity.host_recompute_mismatch(caught.eds, 128)
        check(caught.mismatches == plain_count > 0,
              f"the drill's mismatches {caught.mismatches} != the plain count {plain_count}")
        retries = metrics.get_counter("transfer_retry_total", site="smoke.drill", direction="h2d")
        with faults.inject(faults.rule("transfer.chunk", "bitflip", times=1), seed=SEED):
            healed = transfers.device_put_chunked(main_sq, dev, site="smoke.drill", chunks=4)
        check(np.array_equal(healed.cpu().numpy(), main_sq), "the healed upload differs")
        check(metrics.get_counter("transfer_retry_total", site="smoke.drill",
                                  direction="h2d") == retries + 1, "no retry was counted")
        with faults.inject(faults.rule("transfer.chunk", "bitflip"), seed=SEED):
            try:
                transfers.device_put_chunked(main_sq, dev, site="smoke.drill", chunks=4)
                fail("a persistent transfer.chunk bitflip did not raise")
            except integrity.IntegrityError:
                pass
    finally:
        integrity.configure("off")
    emit(phase="integrity_drill", k=128, level="full", extend_output_mismatches=caught.mismatches,
         plain_count=plain_count, transfer_chunk_transient="healed",
         transfer_chunk_persistent="raised")

    # sliced reads of the device-resident k = 128 EDS against a full fetch
    def d2h(site: str) -> float:
        return metrics.get_counter("transfer_bytes", site=site, direction="d2h")

    full = transfers.device_get_chunked(eds_main, site="smoke.full")
    check(np.array_equal(full, eds_main.cpu().numpy()), "the chunked full fetch differs")
    idx = [0, 1, 127, 128, 255]
    for i in idx:
        check(np.array_equal(transfers.eds_row(eds_main, i), full[i]), f"row {i}")
        check(np.array_equal(transfers.eds_col(eds_main, i), full[:, i]), f"column {i}")
        check(np.array_equal(transfers.eds_share(eds_main, i, 255 - i), full[i, 255 - i]),
              f"cell {i}")
    check(np.array_equal(transfers.eds_rows_batch(eds_main, idx), full[idx]), "row batch")
    pts = [(i, 255 - i) for i in idx]
    check(np.array_equal(transfers.eds_cells_batch(eds_main, pts), full[idx, [255 - i for i in idx]]),
          "cell batch")
    resident = da.ExtendedDataSquare.from_device(eds_main, 128)
    check(resident.row(7) == [full[7, j].tobytes() for j in range(256)]
          and resident.share(200, 3) == full[200, 3].tobytes() and resident._data is None,
          "ExtendedDataSquare sliced reads")
    emit(phase="sliced_reads", k=128, reads=len(idx), full_fetch_bytes=d2h("smoke.full"),
         bytes={site: d2h(site) for site in ("eds.row", "eds.col", "eds.share",
                                             "eds.rows_batch", "eds.cells_batch")},
         row_read_ms=wall_ms(lambda: transfers.eds_row(eds_main, 5)),
         cell_read_ms=wall_ms(lambda: transfers.eds_share(eds_main, 5, 9)),
         full_fetch_ms=wall_ms(lambda: transfers.device_get_chunked(eds_main, site="smoke.t"),
                               reps=3))

    # ---- phase 6: EDS repair, the repair-after-extend path of a catching-up
    # node (BASELINE config 4): bench.py's square and masks at k = 128 and 64
    from celestia_tpu_torch.ops import repair, repair_cuda

    def bench_square(kk: int, seed: int = 42) -> np.ndarray:
        """bench.py's build_square(kk, seed): sorted v0 namespaces."""
        r = np.random.default_rng(seed)
        flat = r.integers(0, 256, size=(kk * kk, SHARE_SIZE), dtype=np.uint8)
        subs = sorted(r.integers(0, 200, size=(kk * kk, 10), dtype=np.uint8).tolist())
        for i, sub in enumerate(subs):
            flat[i, :NAMESPACE_SIZE] = np.frombuffer(ns.new_v0(bytes(sub)).bytes, np.uint8)
        return flat.reshape(kk, kk, SHARE_SIZE)

    # the decode sweep at every power of two k to 32: one random 25% mask
    # (the first of its seed's draws that a repair can undo), every sweep
    # against the plain version, the swept square the extended one
    from celestia_tpu_torch.da.repair import UnrepairableError

    small_sweeps = 0
    for kk in (1, 2, 4, 8, 16, 32):
        with pinned("fused-dense"):
            s_eds = extend.extend_roots_device_resident(bench_square(kk), dev)[0]
        w = 2 * kk
        draw = np.random.default_rng(SEED + kk)
        while True:
            present = np.ones((w, w), dtype=bool)
            present.reshape(-1)[draw.choice(w * w, size=max(1, w * w // 4), replace=False)] = False
            try:
                s_plans = repair.plan_sweeps(present, kk)
                break
            except UnrepairableError:
                continue
        a = torch.where(torch.from_numpy(present).to(dev)[..., None], s_eds, 0)
        b = a.clone()
        for i, plan in enumerate(repair._stage_plans(s_plans, dev)):
            repair_cuda.sweep(a, plan)
            repair_cuda.sweep_reference(b, plan)
            same("decode_sweep", a, b, f"decode sweep {i} k={kk} (25% mask)")
        identical(a, s_eds, f"the swept square k={kk} (25% mask)")
        small_sweeps += len(s_plans)
    emit(phase="kernel_vs_plain", kernel="decode_sweep", k=[1, 2, 4, 8, 16, 32],
         masks="one random 25% mask each", sweeps=small_sweeps, tolerance=0,
         max_abs_err=max_err["decode_sweep"])

    repair_timed = {}  # k: (repaired square, a row sweep of a random mask, its plan)
    for kk in (128, 64):
        with pinned("fused-dense"):
            r_eds, r_rows, r_cols = extend.extend_roots_device_resident(bench_square(kk), dev)
        truth = r_eds.clone()
        truth_host = truth.cpu().numpy()
        row_roots = [r.tobytes() for r in r_rows]
        col_roots = [c.tobytes() for c in r_cols]
        masks = repair_masks(kk)
        plans = {label: repair.plan_sweeps(present, kk) for label, present in masks}
        n_sweeps = sum(len(v) for v in plans.values())
        n_columns = sum(p.transpose for v in plans.values() for p in v)
        check(all(len(plans[label]) == 1 for label, _p in masks[:4]) and n_columns > 0,
              f"k={kk}: the random masks plan one row sweep each, the last mask a column sweep")
        # the kernel against its plain version, sweep by sweep on the same input
        for label, present in masks:
            a = torch.where(torch.from_numpy(present).to(dev)[..., None], r_eds, 0)
            b = a.clone()
            for i, plan in enumerate(repair._stage_plans(plans[label], dev)):
                repair_cuda.sweep(a, plan)
                repair_cuda.sweep_reference(b, plan)
                same("decode_sweep", a, b, f"decode sweep {i} "
                     f"({'column' if plan.transpose else 'row'}) k={kk} {label}")
            identical(a, truth, f"the swept square k={kk} {label}")
        emit(phase="kernel_vs_plain", kernel="decode_sweep", k=kk,
             masks=[label for label, _p in masks], sweeps=n_sweeps, column_sweeps=n_columns,
             tolerance=0, max_abs_err=max_err["decode_sweep"])
        # the main path: the resident cycle (sweeps, the roots recomputed on
        # the card, compared with the DAH), then repair_device (square in and
        # out through the host), each with the counts from 0
        torch.cuda.synchronize()
        _cuda.reset_launches()
        fixed = [repair.repair_resident_verified(r_eds, present, row_roots, col_roots, dev)
                 for _label, present in masks]
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route="fused-dense", k=kk, entry="repair_resident_verified",
             masks=len(masks), sweeps=n_sweeps, launches=counts)
        check(counts["decode_sweep"] == n_sweeps,
              f"k={kk}: {counts['decode_sweep']} decode sweeps launched, {n_sweeps} planned")
        # the verify's roots: one leaf pass (K2) and one tree launch a repair
        check(counts["nmt_tree"] == counts["leaf_digests2d"] == len(masks),
              f"k={kk}: the verify launched nmt_tree {counts['nmt_tree']} times")
        check(all(counts[name] == 0 for name in counts
                  if name not in ("decode_sweep", "nmt_tree", "leaf_digests2d")),
              f"k={kk}: the resident repair launched {counts}")
        for (label, _p), f in zip(masks, fixed):
            identical(f, truth, f"repair_resident_verified k={kk} {label}")
        if kk == 128:
            launches["decode_sweep"] = counts["decode_sweep"]
        srcs = [np.where(present[..., None], truth_host, 0) for _label, present in masks]
        torch.cuda.synchronize()
        _cuda.reset_launches()
        got = [repair.repair_device(src, present, dev) for src, (_l, present) in zip(srcs, masks)]
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", route="fused-dense", k=kk, entry="repair_device",
             masks=len(masks), sweeps=n_sweeps, launches=counts)
        check(counts["decode_sweep"] == n_sweeps and sum(counts.values()) == n_sweeps,
              f"k={kk}: repair_device launched {counts}; {n_sweeps} sweeps planned, no tree")
        for (label, _p), g in zip(masks, got):
            check(np.array_equal(g, truth_host), f"repair_device k={kk} {label}: not the EDS")
        # a flipped root must raise; the caller's square never changes; run()
        # returns the same bytes each time
        for which in ("row", "column"):
            bad = list(row_roots if which == "row" else col_roots)
            bad[3] = bytes([bad[3][0] ^ 1]) + bad[3][1:]
            try:
                repair.repair_resident_verified(
                    r_eds, masks[0][1], bad if which == "row" else row_roots,
                    bad if which == "column" else col_roots, dev)
                fail(f"k={kk}: a flipped {which} root passed the verify")
            except ValueError as err:
                check(f"repaired {which} roots do not match DAH" in str(err), str(err))
        run, _n = repair.stage_resident_repair(r_eds, masks[-1][1], dev)
        first = run().clone()
        identical(run(), first, f"k={kk}: run() twice")
        identical(first, truth, f"k={kk}: run()")
        identical(r_eds, truth, f"k={kk}: the caller's resident EDS changed")
        # timing, the masks in turn as bench.py cycles them
        turn = iter(range(10**9))

        def cycled(fn):
            return lambda: fn(next(turn) % 4)

        emit(phase="repair", k=kk, masks=4, erased=0.25,
             plan_ms=wall_ms(cycled(lambda i: repair.plan_sweeps(masks[i][1], kk))),
             repair_device_ms=wall_ms(cycled(
                 lambda i: repair.repair_device(srcs[i], masks[i][1], dev))),
             resident_cycle_ms=wall_ms(cycled(lambda i: repair.repair_resident_verified(
                 r_eds, masks[i][1], row_roots, col_roots, dev))))
        if kk == 128:
            # the locator lever: the plan's dgemm through torch (the port) or
            # through numpy's BLAS (the JAX package's spelling), whose threads
            # keep spinning after the call and slow the host copies that come
            # next, the next call's included. So each spelling runs as a
            # block (2 warm-up calls, then REPS), the blocks in turns twice
            locator = gf256._error_locator_logs_batch
            erased = (~masks[0][1]).astype(np.int64)
            check(np.array_equal(numpy_locator(erased), locator(erased)),
                  "the two spellings of the error locator differ")
            entries = {"repair_device": lambda i: repair.repair_device(srcs[i], masks[i][1], dev),
                       "resident_cycle": lambda i: repair.repair_resident_verified(
                           r_eds, masks[i][1], row_roots, col_roots, dev)}
            lever_ms: dict[str, list[float]] = {}
            try:
                for _turn in range(2):
                    for lever, fn in (("torch_matmul", locator), ("numpy_dgemm", numpy_locator)):
                        gf256._error_locator_logs_batch = fn
                        for entry, call in entries.items():
                            for rep in range(2 + REPS // 2):
                                t = time.perf_counter()
                                call(rep % 4)
                                torch.cuda.synchronize()
                                if rep >= 2:
                                    lever_ms.setdefault(f"{entry}:{lever}", []).append(
                                        (time.perf_counter() - t) * 1e3)
            finally:
                gf256._error_locator_logs_batch = locator
            emit(phase="repair_levers", k=kk, samples=2 * (REPS // 2),
                 median_ms={n: statistics.median(v) for n, v in lever_ms.items()},
                 q1_q3_ms={n: statistics.quantiles(v, n=4)[::2] for n, v in lever_ms.items()})
        plan0 = plans[masks[0][0]][0]
        repair_timed[kk] = (truth.clone(), truth.clone(), repair._stage_plans([plan0], dev)[0],
                            plan0)
        if kk == 128:
            # a device.repair.output bitflip must raise under the full audit
            integrity.configure("full", q=4, seed=SEED)
            try:
                with faults.inject(faults.rule("device.repair.output", "bitflip"), seed=SEED):
                    try:
                        repair.repair_device(srcs[0], masks[0][1], dev)
                        fail("a device.repair.output bitflip passed the full audit")
                    except integrity.IntegrityError as err:
                        check(err.site == "device.repair.output" and err.mismatches > 0,
                              f"the repair drill raised at {err.site}")
                        repair_drill = err.mismatches
            finally:
                integrity.configure("off")
            emit(phase="integrity_drill", k=kk, level="full", site="device.repair.output",
                 mismatches=repair_drill)

    # ---- phase 6b: serving reads, DAS samples off the paged device EDS cache
    from celestia_tpu_torch import proof, tracing
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.eds_cache import PagedEdsCache, ResidentEdsCache
    from celestia_tpu_torch.ops import ragged, ragged_cuda

    def pages_of(eds_t: torch.Tensor, rpp: int) -> list[torch.Tensor]:
        return [eds_t[lo:lo + rpp].clone() for lo in range(0, eds_t.shape[0], rpp)]

    # (a) the gather kernel against its plain version at every power of two k
    # (8-row pages), one descriptor and a group with duplicates; a group of
    # 300 at k = 128 (the full parameter table); more descriptors and pages
    # than one table holds; and two geometries in one group
    pick = np.random.default_rng(SEED + 1)
    cases = 0
    for kk in (1, 2, 4, 8, 16, 32, 64, 128):
        pages = pages_of(dev_bytes((2 * kk, 2 * kk, SHARE_SIZE)), 8)
        n = 300 if kk == 128 else 40
        slots = [int(s) for s in pick.integers(len(pages), size=n)]
        rows = [int(r) for r in pick.integers(pages[0].shape[0], size=n)]
        slots, rows = slots + slots[:7], rows + rows[:7]  # duplicates
        for s, r in ((slots[:1], rows[:1]), (slots, rows)):
            same("ragged_gather", ragged_cuda.ragged_gather(pages, s, r),
                 ragged_cuda.gather_rows_reference(pages, s, r),
                 f"ragged_gather k={kk} n={len(s)}")
            cases += 1
    many = pages_of(dev_bytes((2 * (ragged_cuda.MAX_PAGES + 128), 2, SHARE_SIZE)), 2)
    n_many = ragged_cuda.MAX_DESCS + 1000
    slots = [int(s) for s in pick.integers(len(many), size=n_many)]
    rows = [int(r) for r in pick.integers(2, size=n_many)]
    plan = ragged_cuda.plan_launches(slots, rows)
    before = _cuda.LAUNCHES["ragged_gather"]
    got = ragged_cuda.ragged_gather(many, slots, rows)
    check(len(plan) >= 2 and _cuda.LAUNCHES["ragged_gather"] - before == len(plan),
          f"{n_many} descriptors over {len(many)} pages: {len(plan)} planned launches, "
          f"{_cuda.LAUNCHES['ragged_gather'] - before} made")
    same("ragged_gather", got, ragged_cuda.gather_rows_reference(many, slots, rows),
         f"ragged_gather over {len(plan)} launches")
    geo = {kk: pages_of(dev_bytes((2 * kk, 2 * kk, SHARE_SIZE)), 3) for kk in (8, 16)}
    # every page once (full 3-row pages and each k's short tail page), then
    # 20 more, alternating k
    picks = [(kk, i) for kk in (8, 16) for i in range(len(geo[kk]))]
    picks += [((8, 16)[t % 2], None) for t in range(20)]
    descs, want = [], []
    for kk, i in picks:
        page = geo[kk][int(pick.integers(len(geo[kk]))) if i is None else i]
        r = int(pick.integers(page.shape[0]))
        descs.append((page, r, 2 * kk))
        want.append(page[r].cpu().numpy())
    shapes = {tuple(d[0].shape) for d in descs}
    before = _cuda.LAUNCHES["ragged_gather"]
    got = ragged.gather_rows(descs)
    check(_cuda.LAUNCHES["ragged_gather"] - before == len(shapes) == 4,
          f"gather_rows over {len(shapes)} geometries launched "
          f"{_cuda.LAUNCHES['ragged_gather'] - before} times")
    check(all(g.tobytes() == w.tobytes() for g, w in zip(got, want)),
          "gather_rows over mixed geometries differs from the rows sliced one by one")
    emit(phase="kernel_vs_plain", kernel="ragged_gather", k=[1, 2, 4, 8, 16, 32, 64, 128],
         cases=cases, table_launches=len(plan), descriptors=n_many, pages=len(many),
         geometries=len(shapes), tolerance=0, max_abs_err=max_err["ragged_gather"])

    # (b) full width: four heights of bench.py's square at k = 128 in a
    # node's default paged cache (128 MiB, 4 heights, 8-row pages: 32 a
    # height, every page resident), a crowd of 256 samples uniform over them,
    # one ragged_gather launch and nothing else
    sk, width = SERVING_K, 2 * SERVING_K
    heights = SERVING_HEIGHTS
    node = Node(device=dev)
    cache = node._eds_cache
    check((cache.device_byte_budget, cache.max_heights, cache.rows_per_page)
          == (128 << 20, 4, 8), f"the node's default cache is {cache.stats()}")
    host_eds, host_rows = {}, {}
    for h in heights:
        with pinned("fused-dense"):
            eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
        host_eds[h], host_rows[h] = eds.data, eds.row_roots()
        cache.put(h, eds)  # ExtendBlock retention's call
        del eds
    check(all(len(cache.get(h).pages) == width // cache.rows_per_page for h in heights)
          and cache.stats()["page_demotes"] == 0, f"paging: {cache.stats()}")
    host_provers: dict[int, dict] = {h: {} for h in heights}

    def host_docs(payloads) -> list:
        """Every document built on the host from the fetched EDS."""
        return [proof.das_sample_docs({i: [host_eds[h][i, c].tobytes() for c in range(width)]},
                                      [(i, j)], sk, provers=host_provers[h])[0]
                for h, i, j in payloads]

    def serve(which: str, srv, payloads) -> list:
        """The crowd through sample_batch_ragged with the counts from 0: one
        ragged_gather launch (one geometry) and nothing else."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = srv.sample_batch_ragged(payloads)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache=which,
             samples=len(payloads), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the {which} crowd launched {counts}: ragged_gather once, nothing else")
        check(out == host_docs(payloads), f"the {which} crowd's documents differ from the host's")
        return out, counts

    def crowd_ms(srv, seeds) -> list[float]:
        """Host ms per sample of sample_batch_ragged, a fresh crowd a call."""
        out = []
        for s in seeds:
            p = serving_crowd(s, heights, width, SERVING_SAMPLES)
            t = time.perf_counter()
            srv.sample_batch_ragged(p)
            out.append((time.perf_counter() - t) * 1e3 / len(p))
        return out

    def stages_of(srv, payloads) -> dict:
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            srv.sample_batch_ragged(payloads)
            wall = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        return {"wall_ms": wall, **{name: s * 1e3 for name, s in sink.data.items()}}

    crowd0 = serving_crowd(SEED, heights, width, SERVING_SAMPLES)
    docs, counts = serve("full_width", node, crowd0)
    launches["ragged_gather"] = counts["ragged_gather"]
    g_case = gather_case(lambda h: [p.dev for p in cache.get(h).pages], crowd0, 8)
    same("ragged_gather", ragged_cuda.ragged_gather(*g_case),
         ragged_cuda.gather_rows_reference(*g_case), "ragged_gather at the crowd's bucket")
    full_ms = crowd_ms(node, range(SEED + 10, SEED + 15))
    full_stages = stages_of(node, serving_crowd(SEED + 20, heights, width, SERVING_SAMPLES))
    one = [(i, j) for _h, i, j in serving_crowd(SEED + 30, (1,), width, 64)]
    one_ms = []
    for s in range(5):
        coords = [(i, j) for _h, i, j in serving_crowd(SEED + 40 + s, (1,), width, 64)]
        t = time.perf_counter()
        node.sample_batch(1, coords)
        one_ms.append((time.perf_counter() - t) * 1e3 / len(coords))
    check(node.sample_batch(1, one) == host_docs([(1, i, j) for i, j in one]),
          "sample_batch at one height differs from the host's documents")
    # every document verifies against the block's DAH (block_dah materializes
    # each paged square on the host, so it comes after the timed crowds)
    verified = 0
    for h in heights:
        check(node.block_dah(h).row_roots == host_rows[h], f"block_dah({h}) row roots")
    for (h, i, j), doc in zip(crowd0, docs):
        share = bytes.fromhex(doc["share"])
        p = doc["proof"]
        pr = proof.NmtRangeProof(p["start"], p["end"], [bytes.fromhex(x) for x in p["nodes"]],
                                 p["tree_size"])
        pr.verify_inclusion(node.block_dah(h).row_roots[i],
                            [da.erasured_leaf_namespace(i, j, share, sk)], [share])
        verified += 1
    emit(phase="serving", part="full_width", k=sk, heights=len(heights),
         samples=SERVING_SAMPLES, unique_rows=len(g_case[1]), unique_pages=len(g_case[0]),
         verified=verified, ms_per_sample=statistics.median(full_ms), ms_per_sample_all=full_ms,
         stages=full_stages, sample_batch_ms_per_sample=statistics.median(one_ms),
         sample_batch_samples=64, stats=cache.stats())

    # (c) the same squares and crowd at a budget of 8 pages: demotions and
    # fault-ins, the same bytes, the device bytes back inside the budget (and
    # one page) after each call, and each square's memory freed once its
    # handle is dropped: the pages are buffers of their own
    page_bytes = 8 * width * SHARE_SIZE
    tight = Node(device=dev)
    tight._eds_cache = tc = PagedEdsCache(device_byte_budget=SERVING_TIGHT_PAGES * page_bytes,
                                          device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mem = []
    for h in heights:
        with pinned("fused-dense"):
            eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        tc.put(h, eds)
        torch.cuda.synchronize()
        put = torch.cuda.memory_allocated()
        del eds
        torch.cuda.synchronize()
        dropped = torch.cuda.memory_allocated()
        mem.append({"height": h, "square_mib": (held - base) / 2**20,
                    "after_put_mib": (put - base) / 2**20,
                    "after_drop_mib": (dropped - base) / 2**20,
                    "resident_mib": tc.device_bytes() / 2**20})
        check(put - dropped >= 2 * sk * width * SHARE_SIZE,
              f"height {h}: dropping the square freed {(put - dropped) / 2**20} MiB, not "
              f"its {2 * sk * width * SHARE_SIZE / 2**20}: the cache holds its storage")
        check(dropped - base <= tc.device_bytes() + page_bytes,
              f"height {h}: {(dropped - base) / 2**20} MiB allocated for "
              f"{tc.device_bytes() / 2**20} MiB of resident pages")
        check(tc.device_bytes() <= tc.device_byte_budget + page_bytes, "over budget after put")
    torch.cuda.reset_peak_memory_stats()
    peak0 = torch.cuda.memory_allocated()
    tight_docs, _counts = serve("tight_budget", tight, crowd0)
    peak = torch.cuda.max_memory_allocated() - peak0
    check(tight_docs == docs, "the tight budget changed the documents")
    st = tc.stats()
    check(st["page_demotes"] > 0 and st["page_faultins"] > 0 and st["page_corrupt"] == 0,
          f"the tight budget did not churn: {st}")
    check(tc.device_bytes() <= tc.device_byte_budget + page_bytes,
          f"{tc.device_bytes()} device bytes after the crowd, budget {tc.device_byte_budget}")
    tight_ms = crowd_ms(tight, range(SEED + 10, SEED + 12))
    check(tc.device_bytes() <= tc.device_byte_budget + page_bytes, "over budget after the crowds")
    tight_stages = stages_of(tight, serving_crowd(SEED + 21, heights, width, SERVING_SAMPLES))
    # one page's demotion (fetch + CRC32C) and fault-in (CRC32C + upload,
    # until it has landed), each through the cache's own leg, median of 5
    resident = next(p for p in tc._pages if p.dev is not None and not p.pins)
    demoted = next(p for p in tc._pages if p.dev is None and p.host is not None)

    def leg_ms(fn) -> float:
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    demote_ms = leg_ms(lambda: tc._demote(resident, resident.dev))
    faultin_ms = leg_ms(lambda: tc._fault_in(demoted))
    crc_ms = leg_ms(lambda: integrity.crc32c(demoted.host))
    emit(phase="serving", part="tight_budget", k=sk, budget_pages=SERVING_TIGHT_PAGES,
         samples=SERVING_SAMPLES, ms_per_sample=statistics.median(tight_ms),
         ms_per_sample_all=tight_ms, stages=tight_stages, peak_crowd_mib=peak / 2**20,
         memory=mem, demote_ms_per_page=demote_ms, faultin_ms_per_page=faultin_ms,
         crc32c_ms_per_page=crc_ms, page_mib=page_bytes / 2**20, stats=tc.stats())

    # (d) a cache.faultin bitflip drill: sample_batch_ragged invalidates the
    # one height the IntegrityError names and answers the rest
    drill = serving_crowd(SEED + 50, heights, width, SERVING_SAMPLES)
    with faults.inject(faults.rule("cache.faultin", "bitflip", times=1), seed=SEED):
        drilled = tight.sample_batch_ragged(drill)
    gone = [h for h in heights if h not in tc]
    check(len(gone) == 1 and tc.stats()["page_corrupt"] == 1,
          f"the drill invalidated {gone}, {tc.stats()['page_corrupt']} corrupt pages")
    check(all(d is None if h in gone else d == w
              for (h, _i, _j), d, w in zip(drill, drilled, host_docs(drill))),
          "the drill's other heights were not answered as the host answers them")
    emit(phase="integrity_drill", site="cache.faultin", entry="Node.sample_batch_ragged",
         healed=gone, answered=sum(d is not None for d in drilled), samples=len(drill))

    # (e) a ResidentEdsCache node: its provers come from the device's row
    # levels, one K2 and one tree launch, proofs equal to the host's
    res = Node(device=dev)
    res._eds_cache = ResidentEdsCache()
    with pinned("fused-dense"):
        res._eds_cache.put(1, da.extend_shares(bench_square(sk, 42).reshape(-1, SHARE_SIZE), dev))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    rdocs = res.sample_batch(1, one)
    first_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    emit(phase="main_path", entry="Node._row_provers", cache="resident", k=sk, launches=counts)
    check(counts["leaf_digests2d"] == 1 and counts["nmt_tree"] == 1 and sum(counts.values()) == 2,
          f"the resident node's provers launched {counts}: K2 once and nmt_tree once")
    check(res._prover_cache[1][0] is not None, "the resident node built its provers on the host")
    check(rdocs == host_docs([(1, i, j) for i, j in one]),
          "the resident node's documents differ from the host's")
    res_ms = []
    for s in range(5):
        coords = [(i, j) for _h, i, j in serving_crowd(SEED + 60 + s, (1,), width, 64)]
        t = time.perf_counter()
        res.sample_batch(1, coords)
        res_ms.append((time.perf_counter() - t) * 1e3 / len(coords))
    emit(phase="serving", part="resident", k=sk, samples=64, first_call_ms=first_ms,
         ms_per_sample=statistics.median(res_ms))

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

    def host_ms(fn, reps: int = REPS) -> float:
        fn()
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()  # ends in a D2H copy of the roots, so the device is done
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    # ---- phase 6c: the proposer's path from transactions (bench.py config 8b):
    # square construction, the blobs staged in the arena, the square
    # assembled on the card from it, the roots-only core, the DAH
    from celestia_tpu_torch import square as square_pkg
    from celestia_tpu_torch.app import proposal
    from celestia_tpu_torch.ops import assemble, assemble_cuda
    from celestia_tpu_torch.ops.blob_pool import DeviceBlobArena, blob_key
    from celestia_tpu_torch.shares import to_bytes

    def assembly_tensors(case: dict) -> tuple:
        """A case's kernel inputs on the card, in the layout assembled_roots
        stages (the arena's bytes first)."""
        meta = np.stack([case[f] for f in ("blob_start", "blob_nshares", "blob_off",
                                           "blob_len")]).astype(np.int32)
        sparse = np.stack([case["host_pos"], case["host_row"]]).astype(np.int32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            case["arena"], case["host_shares"], meta, case["ns_table"], sparse))

    # (a) the kernel against its plain version at every power of two k, on
    # every input family
    asm_k = [1, 2, 4, 8, 16, 32, 64, 128]
    cases = 0
    for kk in asm_k:
        for fi, fam in enumerate(ASSEMBLY_FAMILIES):
            a = assembly_tensors(assembly_case(kk, SEED + 31 * kk + fi, fam))
            same("assemble_square", assemble_cuda.assemble_square(*a, kk),
                 assemble.assemble_square_reference(*a, kk), f"assemble_square k={kk} {fam}")
            cases += 1
    asm_ptxas = [r for name, r in ptxas_report(_cuda.build_log()).items()
                 if "assemble_square_kernel" in name]
    check(len(asm_ptxas) == 1, "no ptxas report of the assembly kernel")
    check(asm_ptxas[0].get("spill_store_bytes", 0) == 0
          and asm_ptxas[0].get("spill_load_bytes", 0) == 0,
          f"the assembly kernel spills: {asm_ptxas[0]}")
    emit(phase="kernel_vs_plain", kernel="assemble_square", k=asm_k,
         families=list(ASSEMBLY_FAMILIES), cases=cases, tolerance=0,
         max_abs_err=max_err["assemble_square"], **asm_ptxas[0])

    # (b) the main path at full width: build the square, stage the blobs,
    # assemble and root it, with the counts from 0
    def h2d_bytes(site: str) -> float:
        return metrics.get_counter("transfer_bytes", site=site, direction="h2d")

    txs = proposal_txs()
    t = time.perf_counter()
    p_square, kept, builder = square_pkg.build_ex(txs, 1, PROPOSAL_K)
    build_ms = (time.perf_counter() - t) * 1e3
    pk = square_pkg.square_size(len(p_square))
    check(pk == PROPOSAL_K and len(kept) == PROPOSAL_BLOBS,
          f"config 8b's square is k = {pk} with {len(kept)} of {PROPOSAL_BLOBS} txs")
    p_arr = np.frombuffer(b"".join(to_bytes(p_square)), np.uint8).reshape(pk, pk, SHARE_SIZE)
    blobs = [b.data for _s, b in builder.blob_layout()]
    put_ms = []
    for _rep in range(5):  # a fresh arena each time, so every blob is staged
        p_arena = DeviceBlobArena(device=dev)
        torch.cuda.synchronize()
        before = h2d_bytes("arena.stage")
        t = time.perf_counter()
        p_arena.put_many(blobs)
        p_arena.ready()
        torch.cuda.synchronize()
        put_ms.append((time.perf_counter() - t) * 1e3)
        arena_bytes = h2d_bytes("arena.stage") - before
    check(p_arena.resident_bytes() == sum(map(len, blobs)),
          f"{p_arena.resident_bytes()} of {sum(map(len, blobs))} blob bytes resident")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    before = h2d_bytes("proposal.stage")
    p_dah = proposal.assembled_proposal_dah(p_arena, p_square, builder, pk, dev)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    staged = h2d_bytes("proposal.stage") - before
    emit(phase="main_path", entry="assembled_proposal_dah", k=pk, launches=counts,
         proposal_stage_bytes=staged, arena_stage_bytes=arena_bytes)
    want = {"assemble_square": 1, "leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1}
    check(p_dah is not None and counts == {**dict.fromkeys(counts, 0), **want},
          f"assembled_proposal_dah launched {counts}: {want} expected")
    check(staged < 1 << 20, f"{staged} bytes staged for the proposal: tens of KB expected")
    launches["assemble_square"] = counts["assemble_square"]
    rd_rows, rd_cols = extend.roots_device(p_arr, dev)
    h_rows, h_cols = host_oracle_roots(p_arr)
    check(p_dah.row_roots == [r.tobytes() for r in rd_rows] == [r.tobytes() for r in h_rows]
          and p_dah.column_roots == [c.tobytes() for c in rd_cols]
          == [c.tobytes() for c in h_cols] and p_dah.hash() == host_dah(h_rows, h_cols),
          "the assembled proposal DAH differs from roots_device's or the host NMT DAH")
    # the reference DAHs again, through the assembly: no blob, every cell a
    # row of the deduplicated host table
    no_arena = torch.zeros(4096, dtype=torch.uint8, device=dev)
    empty = np.zeros(0, np.int32)
    for label, kk, share, expect in oracles:
        flat = (np.frombuffer(share, np.uint8)[None] if share is not None
                else oracle_square(kk * kk))
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        o_rows, o_cols = extend.assembled_roots(
            no_arena, uniq, np.arange(kk * kk, dtype=np.int32), inv.reshape(-1).astype(np.int32),
            empty, empty, empty, empty, np.zeros((0, NAMESPACE_SIZE), np.uint8), kk)
        got = host_dah(o_rows, o_cols).hex()
        check(got == expect, f"{label} DAH through the assembly: {got} != {expect}")
        emit(phase="oracle", route="assembled", name=label, k=kk, dah=got)
    # host times of the proposal: the content key of every blob (the JAX
    # contract hashes each blob on each proposal), the metadata, and the
    # entry against roots_device on the same square, in turns
    p_inputs = proposal.proposal_inputs(p_arena, p_square, builder, pk)
    key_ms = host_ms(lambda: [blob_key(b) for b in blobs])
    inputs_ms = host_ms(lambda: proposal.proposal_inputs(p_arena, p_square, builder, pk))
    p_e2e: dict[str, list[float]] = {"assembled_proposal_dah": [], "roots_device": []}
    p_entries = {
        "assembled_proposal_dah":
            lambda: proposal.assembled_proposal_dah(p_arena, p_square, builder, pk, dev),
        "roots_device": lambda: extend.roots_device(p_arr, dev)}
    for rep in range(2 + E2E_REPS):  # two warm-up rounds
        for entry, fn in p_entries.items():
            t = time.perf_counter()
            fn()  # ends in a D2H copy of the roots
            if rep >= 2:
                p_e2e[entry].append((time.perf_counter() - t) * 1e3)
    asm_args = (*assembly_tensors({"arena": p_arena.arena.cpu().numpy(), **p_inputs}), pk)
    check(torch.equal(assemble_cuda.assemble_square(*asm_args),
                      torch.from_numpy(p_arr).to(dev)),
          "the assembled config-8b square differs from the host-built square")
    asm_bytes = assembly_bytes(pk, p_inputs["blob_len"], len(p_inputs["host_shares"]))
    emit(phase="proposal", k=pk, blobs=len(blobs), blob_bytes=sum(map(len, blobs)),
         host_cells=len(p_inputs["host_pos"]), host_table_rows=len(p_inputs["host_shares"]),
         proposal_stage_bytes=staged, arena_stage_bytes=arena_bytes, build_ex_ms=build_ms,
         put_many_ms=statistics.median(put_ms), put_many_all_ms=put_ms, blob_key_ms=key_ms,
         proposal_inputs_ms=inputs_ms,
         **{f"{e}_ms": statistics.median(v) for e, v in p_e2e.items()},
         **{f"{e}_q1_q3_ms": statistics.quantiles(v, n=4)[::2] for e, v in p_e2e.items()},
         samples=E2E_REPS, assembly_bytes=asm_bytes, dah=p_dah.hash().hex())

    # ---- phase 6d: the durable store tier. A node with a home persists the
    # four heights of phase 6b (bench.py's square at k = 128, seeds 42-45) to
    # its BlockStore, restarts, and serves the 256-sample crowd from disk
    from celestia_tpu_torch.store import BlockStore

    t_phase = time.perf_counter()
    home = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-store-"))
    try:
        # (a) persist: each height's square put as retention puts it, then
        # _persist_block_eds: one K2 and one tree launch (the row levels),
        # one fetch of the square at store.persist, the DAH from the roots
        # the square carries
        snode = Node(device=dev, home=home)
        check(snode.store is not None and len(snode.store) == 0 and snode._eds_cache.store is snode.store,
              "a node with a home opened no empty store below its cache")
        eds_bytes = 2 * sk * width * SHARE_SIZE
        persist, pre_dah = [], {}
        for h in heights:
            with pinned("fused-dense"):
                eds = da.extend_shares(bench_square(sk, 41 + h).reshape(-1, SHARE_SIZE), dev)
            cols = eds.col_roots()
            snode._eds_cache.put(h, eds)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            fetched = metrics.get_counter("transfer_bytes", site="store.persist", direction="d2h")
            sink = tracing.push_stage_sink()
            try:
                t = time.perf_counter()
                snode._persist_block_eds(h, eds)
                ms = (time.perf_counter() - t) * 1e3
            finally:
                tracing.pop_stage_sink()
            counts = dict(_cuda.LAUNCHES)
            emit(phase="main_path", entry="Node._persist_block_eds", k=sk, height=h,
                 launches=counts)
            check(counts["leaf_digests2d"] == 1 and counts["nmt_tree"] == 1
                  and sum(counts.values()) == 2,
                  f"persisting height {h} launched {counts}: K2 once and nmt_tree once")
            fetched = metrics.get_counter("transfer_bytes", site="store.persist",
                                          direction="d2h") - fetched
            check(fetched == eds_bytes, f"persisting height {h} fetched {fetched} B, not the "
                  f"square's {eds_bytes} once")
            entry = snode.store.entry(h)
            check(entry is not None and entry.levels_len > 0 and entry.k == sk
                  and entry.rows_per_page == 8 and entry.page_count == width // 8,
                  f"height {h}'s store entry: {entry}")
            stored = snode.store.read_dah(h)
            pre_dah[h] = json.dumps(snode.block_dah(h).to_json(), sort_keys=True)
            check(json.dumps(stored, sort_keys=True) == pre_dah[h],
                  f"height {h}: the stored DAH differs from block_dah's bytes")
            check(stored == {"row_roots": [r.hex() for r in host_rows[h]],
                             "column_roots": [c.hex() for c in cols]},
                  f"height {h}: the stored DAH differs from the extend's roots")
            persist.append({"height": h, "ms": ms,
                            **{f"{n}_ms": v * 1e3 for n, v in sink.data.items()},
                            "file_bytes": entry.path.stat().st_size})
            del eds
        emit(phase="store", part="persist", k=sk, heights=len(heights), rows_per_page=8,
             square_bytes=eds_bytes, per_height=persist,
             ms_per_height=statistics.median(p["ms"] for p in persist), stats=snode.store.stats())
        # before the restart: the same crowd as phase 6b, the same documents
        check(snode.sample_batch_ragged(crowd0) == docs,
              "the persisting node's crowd differs from phase 6b's documents")
        check(all(snode._prover_cache[h][0] is not None for h in heights),
              "the persisting node's provers did not come from the stored levels")
        del snode

        # (b) restart: a fresh node over the same home re-indexes (deep: every
        # page's CRC) and serves the crowd from disk. Its provers come from
        # the stored levels: ragged_gather once and no K2 or tree launch
        t = time.perf_counter()
        rnode = Node(device=dev, home=home)
        reindex_ms = (time.perf_counter() - t) * 1e3
        check(rnode.store.heights() == list(heights)
              and rnode.store.stats()["reindex_skipped"] == {},
              f"the restart re-indexed {rnode.store.stats()}")
        rc = rnode._eds_cache
        torch.cuda.synchronize()
        _cuda.reset_launches()
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            cold = rnode.sample_batch_ragged(crowd0)
            cold_ms = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache="store_restart",
             samples=len(crowd0), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the restart crowd launched {counts}: ragged_gather once, nothing else")
        check(cold == docs, "the restarted node's documents differ from the pre-restart crowd's")
        st = rc.stats()
        check(st["heights_from_store"] == len(heights) and st["page_store_loads"] > 0
              and st["page_corrupt"] == 0, f"the restart crowd read no page off disk: {st}")
        check(all(rnode._prover_cache[h][0] is not None for h in heights),
              "the restarted node's provers did not come from the stored levels")
        g_case = gather_case(lambda h: [p.dev for p in rc.get(h).pages], crowd0, 8)
        same("ragged_gather", ragged_cuda.ragged_gather(*g_case),
             ragged_cuda.gather_rows_reference(*g_case),
             "ragged_gather on the store-loaded pages")
        check(all(json.dumps(rnode.block_dah(h).to_json(), sort_keys=True) == pre_dah[h]
                  for h in heights), "the restarted node's DAH bytes differ from the pre-restart ones")
        warm_ms = crowd_ms(rnode, range(SEED + 10, SEED + 15))
        page = rc.get(1).pages[0]
        read_ms = leg_ms(lambda: rnode.store.read_page(1, 0))
        page_host = rnode.store.read_page(1, 0)[0]
        page_crc_ms = leg_ms(lambda: integrity.crc32c(page_host))
        check(page.host is None, "a page of the default budget kept a host copy")
        store_faultin_ms = leg_ms(lambda: rc._fault_in(page))  # read, both CRCs, upload
        emit(phase="store", part="restart", k=sk, heights=len(heights), reindex_ms=reindex_ms,
             samples=SERVING_SAMPLES, cold_ms=cold_ms, cold_ms_per_sample=cold_ms / len(crowd0),
             cold_stages={n: v * 1e3 for n, v in sink.data.items()},
             warm_ms_per_sample=statistics.median(warm_ms), warm_ms_per_sample_all=warm_ms,
             read_page_ms=read_ms, crc32c_ms_per_page=page_crc_ms,
             store_faultin_ms_per_page=store_faultin_ms, page_mib=page_bytes / 2**20,
             stats=rc.stats(), store=rnode.store.stats())
        emit(phase="store", part="vs_paged", k=sk, samples=SERVING_SAMPLES,
             restart_cold_ms_per_sample=cold_ms / len(crowd0),
             restart_warm_ms_per_sample=statistics.median(warm_ms),
             paged_full_width_ms_per_sample=statistics.median(full_ms),
             paged_tight_ms_per_sample=statistics.median(tight_ms))

        # (c) the restart at a host budget of 8 pages (and a device budget of
        # 8, so pages demote to the host at all): host copies spill and pages
        # come off disk again, the documents unchanged
        tnode = Node(device=dev, home=home)
        tnode._eds_cache = tsc = PagedEdsCache(
            device_byte_budget=SERVING_TIGHT_PAGES * page_bytes,
            host_byte_budget=SERVING_TIGHT_PAGES * page_bytes, store=tnode.store, device=dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        sink = tracing.push_stage_sink()
        try:
            t = time.perf_counter()
            tight_cold = tnode.sample_batch_ragged(crowd0)
            tight_cold_ms = (time.perf_counter() - t) * 1e3
        finally:
            tracing.pop_stage_sink()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        emit(phase="main_path", entry="Node.sample_batch_ragged", cache="store_tight",
             samples=len(crowd0), launches=counts)
        check(counts["ragged_gather"] == 1 and sum(counts.values()) == 1,
              f"the tight restart crowd launched {counts}: ragged_gather once, nothing else")
        check(tight_cold == docs, "the tight budget changed the restarted node's documents")
        # a second crowd reads spilled pages back off disk: its documents
        # are the default-budget node's for the same crowd
        again = serving_crowd(SEED + 10, heights, width, SERVING_SAMPLES)
        t = time.perf_counter()
        tight_again = tnode.sample_batch_ragged(again)
        tight_again_ms = (time.perf_counter() - t) * 1e3
        check(tight_again == rnode.sample_batch_ragged(again),
              "the spilled pages read back changed the documents")
        st = tsc.stats()
        check(st["page_spills"] > 0 and st["page_store_loads"] > len(g_case[0])
              and st["page_corrupt"] == 0 and st["host_bytes"] <= tsc.host_byte_budget,
              f"the tight restart did not spill and read back: {st}")
        emit(phase="store", part="tight_budget", k=sk, budget_pages=SERVING_TIGHT_PAGES,
             host_budget_pages=SERVING_TIGHT_PAGES, samples=SERVING_SAMPLES,
             cold_ms_per_sample=tight_cold_ms / len(crowd0),
             cold_stages={n: v * 1e3 for n, v in sink.data.items()},
             ms_per_sample=tight_again_ms / len(again), stats=tsc.stats())

        # (d) the drills. A store.read bitflip raises IntegrityError at the
        # store and at the node refuses the one height it struck: that height
        # answers None, the others as before
        dnode = Node(device=dev, home=home)
        sdc0 = metrics.get_counter("sdc_detected_total", site="store.read")
        corrupt0 = metrics.get_counter("store_read_corrupt_total")
        with faults.inject(faults.rule("store.read", "bitflip", times=1), seed=SEED):
            with contextlib.suppress(integrity.IntegrityError):
                dnode.store.read_page(1, 0)
                fail("a store.read bitflip did not raise IntegrityError")
        check(metrics.get_counter("sdc_detected_total", site="store.read") == sdc0 + 1
              and metrics.get_counter("store_read_corrupt_total") == corrupt0 + 1,
              "the store.read bitflip was not counted")
        with faults.inject(faults.rule("store.read", "bitflip", times=1), seed=SEED):
            drilled = dnode.sample_batch_ragged(crowd0)
        poisoned = sorted(dnode._store_refused)
        check(len(poisoned) == 1 and poisoned[0] not in dnode._eds_cache,
              f"the store.read drill refused {poisoned}")
        check(all(d is None if h in poisoned else d == w
                  for (h, _i, _j), d, w in zip(crowd0, drilled, docs)),
              "the drill's other heights were not answered as before")
        check(metrics.get_counter("sdc_detected_total", site="store.read") == sdc0 + 2
              and metrics.get_counter("store_read_corrupt_total") == corrupt0 + 2,
              "the node's store.read drill was not counted")
        emit(phase="integrity_drill", site="store.read", entry="Node.sample_batch_ragged",
             refused=poisoned, answered=sum(d is not None for d in drilled), samples=len(crowd0))
        # a truncated file and a garbage file: quarantined by the next re-index
        last = rnode.store.entry(heights[-1])
        with open(last.path, "r+b") as f:
            f.truncate(last.page_offset(last.page_count // 2))
        (home / "store" / "99.ctps").write_bytes(b"not a store file")
        skipped0 = {r: metrics.get_counter("store_reindex_skipped_total", reason=r)
                    for r in ("truncated", "bad_header")}
        qnode = Node(device=dev, home=home)
        report = qnode.store.stats()
        check(qnode.store.heights() == list(heights[:-1])
              and report["reindex_skipped"] == {"truncated": 1, "bad_header": 1}
              and all(metrics.get_counter("store_reindex_skipped_total", reason=r) == v + 1
                      for r, v in skipped0.items()),
              f"the damaged store re-indexed as {report}")
        check(qnode.sample_batch(heights[-1], [(0, 0)]) == [None],
              "the quarantined height answered")
        # the port's store CLI: verify exits 1 on the damaged store and 0 on
        # a clean copy of its sound heights (the two runs side by side)
        clean = home / "clean"
        (clean / "store").mkdir(parents=True)
        for h in heights[:-1]:
            shutil.copy(rnode.store.entry(h).path, clean / "store")
        t = time.perf_counter()
        runs = [subprocess.Popen(
            [sys.executable, "-m", "celestia_tpu_torch.cli", "store", "verify", "--home", str(d)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for d in (home, clean)]
        (rc_bad, doc_bad), (rc_ok, doc_ok) = [
            (r.returncode, json.loads(out) if out.strip() else None)
            for r, (out, _err) in ((r, r.communicate(timeout=300)) for r in runs)]
        cli_ms = (time.perf_counter() - t) * 1e3
        check(rc_bad == 1 and doc_bad is not None
              and doc_bad["skipped_files"] == {"truncated": 1, "bad_header": 1},
              f"store verify on the damaged store: exit {rc_bad}, {doc_bad}")
        check(rc_ok == 0 and doc_ok is not None and doc_ok["heights"] == len(heights) - 1
              and doc_ok["skipped_files"] == {}, f"store verify on the clean store: exit {rc_ok}, {doc_ok}")
        emit(phase="integrity_drill", site="store.reindex", entry="Node(home=...)",
             skipped=report["reindex_skipped"], cli_verify_damaged=rc_bad, cli_verify_clean=rc_ok,
             cli_ms=cli_ms, phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(home, ignore_errors=True)

    # ---- phase 7: timing
    def bound(ops_s: float, nbytes: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(ops_s, t_bytes) * 1e3, ("operations" if ops_s >= t_bytes else "bytes")

    k = 128
    n = k * SHARE_SIZE
    nc = n // SHARE_SIZE
    x2 = torch.from_numpy(main_sq.reshape(k, n)).to(dev)
    m2 = rs.encode_matrix(k, dev)
    ops = xor_cuda.schedule_operands(k, dev)
    ns_pad = rs_cuda.pad_namespaces(torch.from_numpy(main_sq[..., :NAMESPACE_SIZE]).to(dev))
    # SHA blocks cost the counted ALU- and FMA-pipe operations each (phase 1)
    leaf_blocks = LEAF_BLOCKS * k * nc
    # the encode's three known spellings: the dense GF(2) product on the
    # int8 tensor cores (beside the hash on the integer pipes); the compiled
    # schedule's XORs bit-sliced 32 lanes to an int32 word, each output row
    # assembled with three-input XORs (LOP3): one operation per node and
    # ceil((nnz - 1) / 2) per row, on the ALU pipe with the hash; and
    # Leopard's additive FFT, 4 lanes to a word, its ALU work beside the
    # hash and its byte lookups on the shared-memory pipe
    dense_ops = 2 * (8 * k) ** 2 * n / INT8_OPS_PER_S
    nnz = (ops.sched.row_idx != ops.sched.zero).sum(axis=1)
    xor3_ops = ops.sched.n_nodes + int((nnz // 2).sum())
    xor_alu = xor3_ops * (n / 32)
    operand_bytes = ops.prog.numel() * ops.prog.element_size()
    # the XOR spelling's own floors: its operations on the ALU pipe, and its
    # operand reads from shared memory (every node's two and every row
    # operand, 16 bytes a 128 lanes, one 128-byte wavefront a clock and SM);
    # beside them the floor of this layout's reads (each group's nodes, and
    # the zero-plane padding)
    smem_words_per_s = SMEM_WAVEFRONT_WORDS * SMS * CLOCK_HZ
    xor_smem_floor = (2 * ops.sched.n_nodes + int(nnz.sum())) * (n / 32) / smem_words_per_s
    xor_layout_floor = ops.layout.padded_reads * (n / 32) / smem_words_per_s
    fft_mul, fft_plain = fft_butterflies(m2.fft_group.cpu().numpy() >= 0)
    fft_alu = (fft_mul * FFT_MUL_OPS + fft_plain * FFT_PLAIN_OPS) * (n / 4)
    fft_lookups = fft_mul * n / LOOKUPS_PER_S
    fft_bytes = m2.fft_rows.numel() + 2 * m2.fft_group.numel()
    digest_bytes = k * nc * 32

    def encode_bound(hashed: bool) -> tuple[float, str]:
        """The bound of the encode's function (FFT and XOR kernels alike):
        the cheapest of its three spellings."""
        alu, fma, out = ((leaf_blocks * sha_alu, leaf_blocks * sha_fma, digest_bytes)
                         if hashed else (0, 0, 0))
        return min(bound(max(dense_ops, pipe_seconds(alu, fma)),
                         2 * k * n + (8 * k) ** 2 // 8 + out),
                   bound(pipe_seconds(xor_alu + alu, fma), 2 * k * n + operand_bytes + out),
                   bound(max(pipe_seconds(fft_alu + alu, fma), fft_lookups),
                         2 * k * n + fft_bytes + out))

    def leaf_bound(rows: int) -> tuple[float, str]:
        """K2's bound on (rows, rows·512): its SHA blocks, and each cell,
        namespace and digest moved once."""
        blocks = LEAF_BLOCKS * rows * rows
        return bound(pipe_seconds(blocks * sha_alu, blocks * sha_fma),
                     rows * rows * (SHARE_SIZE + 2 * 32))

    bounds = {
        "encode2d_hash": encode_bound(True),
        "leaf_digests2d": leaf_bound(k),
        "encode2d": encode_bound(False),
        "encode2d_xor_hash": encode_bound(True),
        "encode2d_xor": encode_bound(False),
    }
    xor_floors = {"xor_alu_floor_ms": pipe_seconds(xor_alu, 0) * 1e3,
                  "xor_smem_floor_ms": xor_smem_floor * 1e3,
                  "xor_layout_floor_ms": xor_layout_floor * 1e3}
    emit(phase="bounds", k=k, dense_int8_ms=dense_ops * 1e3, xor3_ops_per_word=xor3_ops,
         **xor_floors, fft_mul_butterflies=fft_mul,
         fft_plain_butterflies=fft_plain, fft_int32_ms=pipe_seconds(fft_alu, 0) * 1e3,
         fft_lookup_ms=fft_lookups * 1e3, sha_block_alu_ops=sha_alu, sha_block_fma_ops=sha_fma,
         sha_ms=pipe_seconds(leaf_blocks * sha_alu, leaf_blocks * sha_fma) * 1e3,
         encode_bound_ms=bounds["encode2d"][0], encode_hash_bound_ms=bounds["encode2d_hash"][0])
    eds_dev = main_eds.device_data
    ns_eds = rs_cuda.pad_namespaces(extend._leaf_namespaces(
        eds_dev[:k, :k, :NAMESPACE_SIZE], k).contiguous())
    x_eds = eds_dev.reshape(2 * k, 2 * n)
    # K2 at the governance-default square, k = 64: its Q0 and its EDS
    sq64 = squares[0][2]
    x64 = torch.from_numpy(sq64.reshape(64, 64 * SHARE_SIZE)).to(dev)
    ns64 = rs_cuda.pad_namespaces(torch.from_numpy(sq64[..., :NAMESPACE_SIZE]).to(dev))
    eds64 = da.extend_shares(sq64.reshape(-1, SHARE_SIZE), dev).device_data
    ns_eds64 = rs_cuda.pad_namespaces(extend._leaf_namespaces(
        eds64[:64, :64, :NAMESPACE_SIZE], 64).contiguous())
    x_eds64 = eds64.reshape(128, 128 * SHARE_SIZE)
    # (call, k, rows) of K2's four timed shapes
    leaf_shapes = (("leaf_digests2d", k, k), ("leaf_digests2d_eds", k, 2 * k),
                   ("leaf_digests2d_64", 64, 64), ("leaf_digests2d_eds_64", 64, 128))
    calls = {
        "encode2d_hash": lambda: rs_cuda.encode2d_hash(x2, m2),
        "leaf_digests2d": lambda: rs_cuda.leaf_digests2d(x2, ns_pad),
        "leaf_digests2d_eds": lambda: rs_cuda.leaf_digests2d(x_eds, ns_eds),
        "leaf_digests2d_64": lambda: rs_cuda.leaf_digests2d(x64, ns64),
        "leaf_digests2d_eds_64": lambda: rs_cuda.leaf_digests2d(x_eds64, ns_eds64),
        "encode2d": lambda: rs_cuda.encode2d(x2, m2),
        "encode2d_xor_hash": lambda: xor_cuda.encode2d_xor_hash(x2, ops),
        "encode2d_xor": lambda: xor_cuda.encode2d_xor(x2, ops),
    }
    # K3 at the shapes of one device DAH (extend_and_root_device): the 4k
    # axis roots' merkle leaves, then its 2k, k, ..., 1 nodes, 2 blocks each
    k3_shapes = []
    for batch in dah_levels(k):
        words = dev_bytes((16 * DAH_BLOCKS, batch * 4)).view(torch.int32)
        words = words.view(torch.uint32).reshape(16 * DAH_BLOCKS, batch)
        k3_shapes.append((batch, words))
        calls[f"sha256_words_{batch}"] = (lambda w=words: sha256_cuda.sha256_words(w))
    # K3's merkle form on the device DAH's roots at k = 64 and 128, as
    # extend_and_root hands them over (the tree kernel's (2, 2k, 90) roots)
    dah_roots = {}
    for kk, sq in ((64, squares[0][2]), (k, main_sq)):
        _e, r_kk = extend._roots(torch.from_numpy(sq).to(dev), rs.encode_matrix(kk, dev))
        dah_roots[kk] = r_kk.reshape(1, 4 * kk, merkle_cuda.ROOT_SIZE)
        calls[f"dah_merkle_{kk}"] = lambda r=dah_roots[kk]: merkle_cuda.dah_merkle(r)

    # the tree kernel at its two main-path calls, k = 64 and 128: an
    # extend's (both families, K1's and K2's digest tiles in the fused
    # route's layout) and eds_row_levels_device's (rows and their levels,
    # four slices of K2's grid over the EDS)
    tree_calls = {}
    for kk, sq in ((64, squares[0][2]), (k, main_sq)):
        grid = dev_bytes((2 * kk, 2 * kk, 32)).view(torch.int32).view(torch.uint32)
        d1t = grid[:kk, kk:].transpose(0, 1).contiguous()
        d3t = grid[kk:, kk:].transpose(0, 1).contiguous()
        fused = (grid[:kk, :kk].contiguous(), d1t.transpose(0, 1),
                 grid[kk:, :kk].contiguous(), d3t.transpose(0, 1))
        sliced = (grid[:kk, :kk], grid[:kk, kk:], grid[kk:, :kk], grid[kk:, kk:])
        q0_ns = torch.from_numpy(sq).to(dev)[..., :NAMESPACE_SIZE]
        tree_calls[f"nmt_tree_both_{kk}"] = (kk, 2, (fused, q0_ns), {})
        tree_calls[f"nmt_tree_levels_{kk}"] = (kk, 1, (sliced, q0_ns), {"keep_levels": True})
    for name, (_kk, _f, a, kw) in tree_calls.items():
        calls[name] = (lambda a=a, kw=kw: nmt_cuda.nmt_tree(*a, **kw))
    # the layout's levers on K6 at k = 128: the conflict-free order undone
    # for the rows, for the nodes, and the rows split over 8 groups, not 4
    levers = {"xor_lever_rows_shuffled": (ops.layout, (True, False)),
              "xor_lever_nodes_shuffled": (ops.layout, (False, True)),
              "xor_lever_groups_8": (xor_cuda.build_layout(ops.sched, 8, 2), (False, False))}
    for name, (lay, (rows, nodes)) in levers.items():
        prog = shuffled_layout_prog(lay, SEED, rows, nodes) if rows or nodes else lay.prog
        lever_ops = xor_cuda.XorOperands(sched=ops.sched, layout=lay,
                                         prog=torch.as_tensor(prog.view(np.int32), device=dev))
        check(torch.equal(xor_cuda.encode2d_xor(x2, lever_ops), xor_cuda.encode2d_xor(x2, ops)),
              f"{name}: the parity changed")
        calls[name] = lambda o=lever_ops: xor_cuda.encode2d_xor(x2, o)
    # the routing table's rungs: the fused routes' two encode kernels
    for kk in TABLE_K:
        xk = dev_bytes((kk, kk * SHARE_SIZE))
        m2k, opsk = rs.encode_matrix(kk, dev), xor_cuda.schedule_operands(kk, dev)
        calls[f"table_dense_{kk}"] = lambda x=xk, m=m2k: rs_cuda.encode2d_hash(x, m)
        calls[f"table_xor_{kk}"] = lambda x=xk, o=opsk: xor_cuda.encode2d_xor_hash(x, o)
        if kk == 64:  # K4 and K6 at the governance-default square, beside the rungs
            calls["encode2d_64"] = lambda x=xk, m=m2k: rs_cuda.encode2d(x, m)
            calls["encode2d_xor_64"] = lambda x=xk, o=opsk: xor_cuda.encode2d_xor(x, o)
    # the decode sweep at k = 128 and 64: a random mask's row sweep on its
    # repaired square (a sweep rewrites the same bytes, so every launch does
    # the same work)
    for kk, (swept, _plain_sq, plan, _p) in repair_timed.items():
        calls[f"decode_sweep_{kk}"] = lambda s=swept, p=plan: repair_cuda.sweep(s, p)
    # the ragged gather at the full-width crowd's one bucket (phase 6b)
    calls["ragged_gather"] = lambda: ragged_cuda.ragged_gather(*g_case)
    # the assembly at config 8b's square (phase 6c)
    calls["assemble_square"] = lambda: assemble_cuda.assemble_square(*asm_args)
    event_ms = {name: cuda_ms(fn, inner=10) for name, fn in calls.items()}
    plain_ms = {
        "encode2d_hash": cuda_ms(lambda: rs_cuda.encode2d_hash_reference(x2, m2)),
        "leaf_digests2d": cuda_ms(lambda: rs_cuda.leaf_digests2d_reference(x2, ns_pad)),
        "leaf_digests2d_eds": cuda_ms(
            lambda: rs_cuda.leaf_digests2d_reference(x_eds, ns_eds), reps=3),
        "leaf_digests2d_64": cuda_ms(lambda: rs_cuda.leaf_digests2d_reference(x64, ns64)),
        "leaf_digests2d_eds_64": cuda_ms(
            lambda: rs_cuda.leaf_digests2d_reference(x_eds64, ns_eds64)),
        "encode2d": cuda_ms(lambda: rs_cuda.encode2d_reference(x2, m2)),
        "encode2d_xor_hash": cuda_ms(lambda: xor_cuda.encode2d_xor_hash_reference(x2, ops)),
        "encode2d_xor": cuda_ms(lambda: xor_cuda.encode2d_xor_reference(x2, ops)),
    }
    plain_ms["ragged_gather"] = cuda_ms(lambda: ragged_cuda.gather_rows_reference(*g_case),
                                        reps=3)
    plain_ms["assemble_square"] = cuda_ms(lambda: assemble.assemble_square_reference(*asm_args),
                                          reps=3)
    # the one PyTorch call that computes the gather: torch.cat of the bucket's
    # row views (timed here as the kernels are, by the profiler and by CUDA
    # events; the port never calls it)
    row_views = [g_case[0][sl][r:r + 1] for sl, r in zip(g_case[1], g_case[2])]
    check(torch.equal(torch.cat(row_views), ragged_cuda.ragged_gather(*g_case)),
          "torch.cat of the row views differs from the ragged gather")
    library_calls = {"ragged_gather": lambda: torch.cat(row_views)}
    # the assembly's copy floor: one device-to-device copy_ of as many bytes
    # as the square (the same bytes moved, not the same function)
    copy_src = torch.empty(pk * pk * SHARE_SIZE, dtype=torch.uint8, device=dev)
    copy_dst = torch.empty_like(copy_src)
    library_calls["assemble_copy_floor"] = lambda: copy_dst.copy_(copy_src)
    library_event_ms = {name: cuda_ms(fn, inner=10) for name, fn in library_calls.items()}
    for kk, (_swept, plain_sq, plan, _p) in repair_timed.items():
        plain_ms[f"decode_sweep_{kk}"] = cuda_ms(
            lambda s=plain_sq, p=plan: repair_cuda.sweep_reference(s, p), reps=3)
    for batch, words in k3_shapes:
        plain_ms[f"sha256_words_{batch}"] = cuda_ms(
            lambda w=words: sha256_cuda.sha_core_reference(w))
    for kk, r in dah_roots.items():
        plain_ms[f"dah_merkle_{kk}"] = cuda_ms(lambda r=r: merkle_cuda.dah_merkle_reference(r),
                                               reps=3)
    for name, (_kk, _f, a, kw) in tree_calls.items():
        plain_ms[name] = cuda_ms(lambda a=a, kw=kw: nmt_cuda.nmt_tree_reference(*a, **kw),
                                 reps=3)

    # end to end, the routes in turns (sample i of every route back to back,
    # so the host's noise falls on all of them alike)
    squares_e2e = {64: realistic(64, 0), 128: main_sq}
    e2e: dict[tuple, list[float]] = {}
    for kk, sq in squares_e2e.items():
        entries = {"roots_device": lambda: extend.roots_device(sq, dev),
                   "extend_roots_device_resident":
                       lambda: extend.extend_roots_device_resident(sq, dev)}
        for rep in range(2 + E2E_REPS):  # two warm-up rounds
            for rname in ROUTES:
                with pinned(rname):
                    for entry, fn in entries.items():
                        t = time.perf_counter()
                        fn()  # ends in a D2H copy of the roots, so the device is done
                        ms = (time.perf_counter() - t) * 1e3
                        if rep >= 2:
                            e2e.setdefault((kk, rname, entry), []).append(ms)
        for rname in ROUTES:
            for entry in entries:
                xs = e2e[(kk, rname, entry)]
                q1, _q2, q3 = statistics.quantiles(xs, n=4)
                emit(phase="end_to_end", k=kk, route=rname, entry=entry,
                     ms=statistics.median(xs), min_ms=min(xs), q1_ms=q1, q3_ms=q3,
                     samples=len(xs))
        eds_kk = extend.extend_roots_device_resident(sq, dev)[0]
        emit(phase="end_to_end", k=kk, route=None, entry="eds_row_levels_device",
             ms=host_ms(lambda: extend.eds_row_levels_device(eds_kk, dev)))
    with pinned("fused-dense"):  # the device DAH's entry
        dah_entry_ms = {kk: host_ms(lambda sq=sq: extend.extend_and_root_device(sq, dev))
                        for kk, sq in squares_e2e.items()}
    profiled_entries = {"roots_device": extend.roots_device,
                        "extend_roots_device_resident": extend.extend_roots_device_resident}

    # ONE profiler session (separate sessions in one process lost their
    # records on the card): a warm-up pass (the profiler can miss the first
    # records of a session), then REPS launches of each timed kernel, then
    # one k = 128 roots_device call per route; every call apart from the
    # next by a 100 ms host sleep. The device records, split at those idle
    # gaps, are one segment per call: a timed call's segment holds only its
    # kernel (one name), and its device time per launch is the mean over
    # the records there; a route's segment is its roots_device breakdown.
    # The idle share is taken against the unprofiled median above and
    # against the profiled call's own host time: the profiler slows the
    # host, and the pageable H2D copy of the square varies from call to
    # call, so the first can read below 0 when that copy dominates.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gap_s = 0.1
    for rname in ROUTES:
        with pinned(rname):
            extend.roots_device(main_sq, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        for fn in calls.values():
            time.sleep(gap_s)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        profiled_ms = {}
        for rname in ROUTES:
            for entry, fn in profiled_entries.items():
                time.sleep(gap_s)
                with pinned(rname):
                    t = time.perf_counter()
                    fn(main_sq, dev)  # ends in a D2H copy of the roots
                    profiled_ms[(rname, entry)] = (time.perf_counter() - t) * 1e3
                torch.cuda.synchronize()
        # the device DAH of extend_and_root, alone: the k = 128 roots on the
        # card to the DAH hash
        time.sleep(gap_s)
        extend.merkle_root_pow2(dah_roots[k][0])
        torch.cuda.synchronize()
        for fn in library_calls.values():  # last: the segments above keep their places
            time.sleep(gap_s)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"), key=lambda e: e.time_range.start)
    segments: list[list] = []
    last_end = None
    for e in evs:
        if last_end is None or e.time_range.start - last_end > gap_s * 1e6 / 2:  # µs
            segments.append([])
        segments[-1].append(e)
        last_end = e.time_range.end if last_end is None else max(last_end, e.time_range.end)
    n_calls = len(calls) + len(profiled_ms) + 1 + len(library_calls)
    check(len(segments) in (n_calls, n_calls + 1),  # + 1: the warm-up pass
          f"the profiler's records split into {len(segments)} calls, expected {n_calls}")
    segments = segments[-n_calls:]
    # a library call's device time: every record of its segment (it may
    # launch several kernels), per call
    library_ms = {}
    for name, seg in zip(library_calls, segments[n_calls - len(library_calls):]):
        check(len(seg) > 0 and not any("celestia::" in e.name for e in seg),
              f"the profiler's records of torch's {name} hold {sorted({e.name for e in seg})}")
        library_ms[name] = sum(e.time_range.elapsed_us() for e in seg) / 1e3 / REPS
    dev_ms, per_launch = {}, {}
    for name, seg in zip(calls, segments):
        kern = [e for e in seg if "celestia::" in e.name]
        check(len(kern) > 0 and len({e.name for e in kern}) == 1,
              f"the profiler's records of {name} hold {sorted({e.name for e in seg})}")
        per_launch[name] = [e.time_range.elapsed_us() / 1e3 for e in kern]
        dev_ms[name] = statistics.fmean(per_launch[name])
    emit(phase="profile_records", launches_per_call=REPS,
         records={name: len(v) for name, v in per_launch.items()})

    # the port's dense/XOR routing table, by device time. The fused routes
    # differ only in their encode kernel (K1 or K5, 3 launches per extend),
    # so a rung's time per spelling is 3 x that kernel's mean device time
    # per launch. A rung enters the table only where the two spellings'
    # launches do not overlap (the faster's slowest below the slower's
    # fastest); the lookup takes the nearest rung for the others.
    table = calibration.CrossoverTable({}, time.time(), card_name, power_limit)
    committed = calibration.load_xor_table()
    rungs = {}
    for kk in TABLE_K:
        d, x = per_launch[f"table_dense_{kk}"], per_launch[f"table_xor_{kk}"]
        entry = {"dense": 3 * statistics.fmean(d), "xor": 3 * statistics.fmean(x)}
        resolved = max(d) < min(x) or max(x) < min(d)
        if resolved:
            table.entries[kk] = entry
        rungs[kk] = {**entry, "resolved": resolved,
                     "dense_launch_range_ms": [min(d), max(d)],
                     "xor_launch_range_ms": [min(x), max(x)],
                     "committed_winner": committed.winner(kk) if committed else None}
    emit(phase="xor_table", basis="device ms of one extend's 3 fused encode launches",
         rungs=rungs, table=table.to_json(),
         agrees_with_committed=all(
             (committed.winner(kk) if committed else "dense") == table.winner(kk)
             for kk in table.entries))
    if args.xor_table_out:
        with open(args.xor_table_out, "w") as f:
            json.dump(table.to_json(), f, indent=2)
            f.write("\n")
    segments = segments[len(calls):]
    dah_seg = segments[len(profiled_ms)]
    dah_aten = sorted({e.name[:90] for e in dah_seg if "celestia::" not in e.name
                       and not e.name.startswith(("Memcpy", "Memset"))})
    dah_h2d = sum("HtoD" in e.name for e in dah_seg)
    check([e.name for e in dah_seg if "celestia::" in e.name] != [] and not dah_aten
          and dah_h2d == 0, f"the device DAH ran {sorted(e.name[:90] for e in dah_seg)}: "
                            f"one merkle launch, no aten op and no H2D copy expected")
    emit(phase="main_path", route="fused-dense", k=main_sq.shape[0],
         entry="extend_and_root_device", launches=dah_counts, dah=dah_dev.tobytes().hex(),
         dah_launches=len(dah_seg), dah_aten_ops=len(dah_aten), dah_h2d_copies=dah_h2d,
         wall_ms=dah_entry_ms)
    for (rname, entry), seg in zip(profiled_ms, segments):
        by_op: dict[str, list] = {}
        for e in seg:
            cell = by_op.setdefault(e.name[:90], [0.0, 0])
            cell[0] += e.time_range.elapsed_us() / 1e3
            cell[1] += 1
        busy_ms = sum(v[0] for v in by_op.values())
        check(busy_ms > 0, f"the profiler recorded no device time for {entry} on {rname}")
        top = sorted(by_op.items(), key=lambda kv: -kv[1][0])
        # aten ops: launches neither of the port's kernels nor copies
        aten = {name: v for name, v in by_op.items()
                if "celestia::" not in name and not name.startswith(("Memcpy", "Memset"))}
        aten_launches = sum(v[1] for v in aten.values())
        median_ms = statistics.median(e2e[(128, rname, entry)])
        emit(phase="profile", k=main_sq.shape[0], route=rname, entry=entry,
             device_busy_ms=busy_ms, median_ms=median_ms,
             device_idle_share=1 - busy_ms / median_ms,
             profiled_call_ms=profiled_ms[(rname, entry)],
             profiled_idle_share=1 - busy_ms / profiled_ms[(rname, entry)],
             device_ops=len(by_op), launches=sum(v[1] for v in by_op.values()),
             aten_launches=aten_launches, aten_ms=sum(v[0] for v in aten.values()),
             aten_ops=sorted(aten),
             h2d_copies=sum(v[1] for name, v in by_op.items() if "HtoD" in name),
             h2d_ms=sum(v[0] for name, v in by_op.items() if "HtoD" in name),
             top=[{"op": name, "ms": v[0], "count": v[1]} for name, v in top[:12]])
        if rname == "fused-dense":
            # no EDS assembled by roots_device; at most Q0's one copy into the
            # EDS beside the kernels on the resident path
            limit = 0 if entry == "roots_device" else 1
            check(aten_launches <= limit, f"{entry} on {rname} launched {aten_launches} aten "
                                          f"ops ({sorted(aten)}), at most {limit} expected")

    results = {}
    for kname, b in bounds.items():
        results[kname] = (dev_ms[kname], event_ms[kname], plain_ms[kname], b)
    k3_dev = k3_event = k3_plain = k3_bytes = 0.0
    for batch, _words in k3_shapes:
        name = f"sha256_words_{batch}"
        emit(phase="timing", kernel="sha256_words", shape=[16 * DAH_BLOCKS, batch],
             device_ms=dev_ms[name], event_ms=event_ms[name], plain_ms=plain_ms[name])
        k3_dev += dev_ms[name]
        k3_event += event_ms[name]
        k3_plain += plain_ms[name]
        k3_bytes += 16 * DAH_BLOCKS * batch * 4 + 8 * batch * 4
    # one merkle tree of len(k3_shapes) levels (leaves, then nodes): the
    # larger of all its blocks at the card's rate and its chain of levels
    # (the design's one launch a level, level_floor_ms, is not the bound)
    k3_batches = [batch for batch, _w in k3_shapes]
    k3_throughput = pipe_seconds(sum(k3_batches) * DAH_BLOCKS * sha_alu,
                                 sum(k3_batches) * DAH_BLOCKS * sha_fma)
    k3_chain = tree_chain_seconds(len(k3_batches), DAH_BLOCKS, round_alu, round_fma)
    emit(phase="timing", kernel="sha256_words", k=k, shapes="one device DAH",
         launches=len(k3_shapes), device_ms=k3_dev, event_ms=k3_event, plain_ms=k3_plain,
         bound_ms=k3_throughput * 1e3, chain_floor_ms=k3_chain * 1e3,
         level_floor_ms=chain_floor_seconds(k3_batches, DAH_BLOCKS, sha_alu, sha_fma) * 1e3)
    results["sha256_words"] = (k3_dev, k3_event, k3_plain,
                               bound(max(k3_throughput, k3_chain), k3_bytes))
    # K3's merkle form: the same tree, its bound the same two terms; the
    # bytes are the roots in and the hash out
    for kk in dah_roots:
        name = f"dah_merkle_{kk}"
        levels = dah_levels(kk)
        throughput = pipe_seconds(sum(levels) * DAH_BLOCKS * sha_alu,
                                  sum(levels) * DAH_BLOCKS * sha_fma)
        chain = tree_chain_seconds(len(levels), DAH_BLOCKS, round_alu, round_fma)
        b_ms, b_by = bound(max(throughput, chain), 4 * kk * merkle_cuda.ROOT_SIZE + 32)
        emit(phase="timing", kernel="dah_merkle", k=kk, device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name], bound_ms=b_ms, bound_by=b_by,
             throughput_ms=throughput * 1e3, chain_floor_ms=chain * 1e3,
             cluster=merkle_cuda.cluster_size(4 * kk),
             k3_launches=len(levels) if kk == k else None,
             k3_device_ms=k3_dev if kk == k else None)
        if kk == k:
            results["dah_merkle"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))
    for name, (kk, fams, _a, kw) in tree_calls.items():
        throughput, chain = nmt_tree_floor(kk, fams, sha_alu, sha_fma, round_alu, round_fma)
        level_floor = chain_floor_seconds(nmt_tree_levels(kk, fams), NODE_BLOCKS,
                                          sha_alu, sha_fma)
        w = 2 * kk
        nbytes = w * w * 32 + kk * kk * NAMESPACE_SIZE + fams * w * 90
        if kw.get("keep_levels"):
            nbytes += w * (2 * w - 1) * 90
        b_ms, b_by = bound(max(throughput, chain), nbytes)
        emit(phase="timing", kernel="nmt_tree", k=kk, call=name, families=fams,
             keep_levels=bool(kw.get("keep_levels")), device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name],
             bound_ms=throughput * 1e3, chain_floor_ms=chain * 1e3,
             level_floor_ms=level_floor * 1e3, row_bound_ms=b_ms, bound_by=b_by)
        if name == f"nmt_tree_both_{k}":
            results["nmt_tree"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))
    for kname, (t_d, t_e, t_p, (b_ms, b_by)) in results.items():
        if kname not in ("leaf_digests2d", "nmt_tree", "sha256_words", "dah_merkle"):
            floors = xor_floors if kname.startswith("encode2d_xor") else {}
            emit(phase="timing", kernel=kname, k=k, device_ms=t_d, event_ms=t_e, plain_ms=t_p,
                 bound_ms=b_ms, bound_by=b_by, **floors)
    for call, kk, rows in leaf_shapes:
        b_ms, b_by = leaf_bound(rows)
        emit(phase="timing", kernel="leaf_digests2d", k=kk, shape=[rows, rows * SHARE_SIZE],
             device_ms=dev_ms[call], launch_range_ms=[min(per_launch[call]), max(per_launch[call])],
             event_ms=event_ms[call], plain_ms=plain_ms[call], bound_ms=b_ms, bound_by=b_by)
    emit(phase="xor_levers", k=k, kernel="encode2d_xor", default_ms=dev_ms["encode2d_xor"],
         **{name[len("xor_lever_"):] + "_ms": dev_ms[name] for name in levers},
         groups_8_padding=levers["xor_lever_groups_8"][0].padded_reads
         / levers["xor_lever_groups_8"][0].reads - 1)
    for kname, call in (("encode2d_hash", "table_dense_64"), ("encode2d", "encode2d_64"),
                        ("encode2d_xor", "encode2d_xor_64")):
        emit(phase="timing", kernel=kname, k=64, device_ms=dev_ms[call],
             event_ms=event_ms[call])

    for kk, (_s, _q, _plan, plan_np) in repair_timed.items():
        name = f"decode_sweep_{kk}"
        work = decode_sweep_work(rs.decode_program(2 * kk), plan_np.scale_bytes,
                                 plan_np.write)
        alu_s = pipe_seconds(work["alu_ops"], 0)
        lookup_s = work["lookups"] / LOOKUPS_PER_S
        b_ms, b_by = bound(max(alu_s, lookup_s), work["bytes"])
        emit(phase="timing", kernel="decode_sweep", k=kk, sweep="row", **work,
             device_ms=dev_ms[name],
             launch_range_ms=[min(per_launch[name]), max(per_launch[name])],
             event_ms=event_ms[name], plain_ms=plain_ms[name], alu_ms=alu_s * 1e3,
             lookup_ms=lookup_s * 1e3, bytes_ms=work["bytes"] / HBM_BYTES_PER_S * 1e3,
             bound_ms=b_ms, bound_by=b_by)
        if kk == 128:
            results["decode_sweep"] = (dev_ms[name], event_ms[name], plain_ms[name], (b_ms, b_by))

    # the ragged gather: every row read once and written once
    g_rows, g_row_bytes = len(g_case[1]), int(np.prod(g_case[0][0].shape[1:]))
    g_bound = bound(0.0, 2 * g_rows * g_row_bytes)
    emit(phase="timing", kernel="ragged_gather", k=SERVING_K, rows=g_rows,
         pages=len(g_case[0]), row_bytes=g_row_bytes, device_ms=dev_ms["ragged_gather"],
         launch_range_ms=[min(per_launch["ragged_gather"]), max(per_launch["ragged_gather"])],
         event_ms=event_ms["ragged_gather"], plain_ms=plain_ms["ragged_gather"],
         bound_ms=g_bound[0], bound_by=g_bound[1])
    results["ragged_gather"] = (dev_ms["ragged_gather"], event_ms["ragged_gather"],
                                plain_ms["ragged_gather"], g_bound)
    emit(phase="library", kernel="ragged_gather", call="torch.cat of the row views",
         device_ms=library_ms["ragged_gather"], event_ms=library_event_ms["ragged_gather"],
         kernel_device_ms=dev_ms["ragged_gather"], kernel_event_ms=event_ms["ragged_gather"])

    # the assembly: every cell written once, every blob byte and host row read once
    a_bound = bound(0.0, asm_bytes)
    emit(phase="timing", kernel="assemble_square", k=pk, blobs=len(blobs),
         host_table_rows=len(p_inputs["host_shares"]), bytes=asm_bytes,
         device_ms=dev_ms["assemble_square"],
         launch_range_ms=[min(per_launch["assemble_square"]),
                          max(per_launch["assemble_square"])],
         event_ms=event_ms["assemble_square"], plain_ms=plain_ms["assemble_square"],
         bound_ms=a_bound[0], bound_by=a_bound[1],
         copy_floor_ms=library_ms["assemble_copy_floor"],
         copy_floor_event_ms=library_event_ms["assemble_copy_floor"])
    results["assemble_square"] = (dev_ms["assemble_square"], event_ms["assemble_square"],
                                  plain_ms["assemble_square"], a_bound)

    check(set(results) == set(KERNEL_SOURCES) == set(_cuda.LAUNCHES),
          f"the kernels line has {sorted(results)}, the port {sorted(_cuda.LAUNCHES)}")
    kernels = []
    for kname, (t_d, _t_e, t_p, (b_ms, b_by)) in results.items():
        src, replaces = KERNEL_SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": t_d, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms.get(kname),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
