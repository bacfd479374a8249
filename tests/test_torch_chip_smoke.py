"""The SASS and ptxas readers of chip_smoke.py, on text in the format that
``cuobjdump -sass`` and ``nvcc -Xptxas -v`` print. Every SHA bound in the
on-card run rests on ``block_loop_mix`` and ``sha_block_ops``: one pass of
K3's block loop, split by pipe."""

import collections
import importlib.util
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN8celestia19sha256_words_kernelEPKjPjii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x21c], PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   IMAD.WIDE R2, R0, 0x4, R2 ;
        /*0040*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0050*/                   SHF.R.W.U32.HI R5, R4, 0x7, R4 ;
        /*0060*/                   LOP3.LUT R6, R5, R4, R7, 0x96, !PT ;
        /*0070*/                   IADD3 R8, R6, R5, R4 ;
        /*0080*/                   IMAD.IADD R9, R8, 0x1, R6 ;
        /*0090*/                   PRMT R10, R9, 0x3210, R8 ;
        /*00a0*/                   IMAD.MOV.U32 R11, RZ, RZ, R10 ;
        /*00b0*/                   IADD3 R12, R12, 0x1, RZ ;
        /*00c0*/                   ISETP.GE.AND P1, PT, R12, c[0x0][0x218], PT ;
        /*00d0*/              @!P1 BRA 0x30 ;
        /*00e0*/                   STG.E desc[UR4][R2.64], R11 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   BRA 0x100;
        /*0110*/                   NOP;
\t\t..........

\t\tFunction : _ZN8celestia21leaf_digests2d_kernelEPK5uint4S2_PS0_i
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LOP3.LUT R2, R2, R3, RZ, 0xc0, !PT ;
        /*0020*/                   EXIT ;
        /*0030*/                   BRA 0x30;
"""


def test_sass_lines_reads_address_opcode_and_operands():
    lines = chip_smoke.sass_lines(SASS, "sha256_words_kernel")
    assert lines[0] == (0x0, "LDC", "R1, c[0x0][0x28]")
    assert (0xd0, "BRA", "0x30") in lines  # the predicate is not the opcode
    assert len(lines) == 18
    assert [op for _a, op, _r in chip_smoke.sass_lines(SASS, "leaf_digests2d_kernel")] == [
        "LDC", "LOP3.LUT", "EXIT", "BRA"]


@pytest.mark.parametrize("fragment", ["no_such_kernel", "celestia"])
def test_sass_lines_wants_exactly_one_kernel(fragment):
    with pytest.raises(ValueError):
        chip_smoke.sass_lines(SASS, fragment)


def test_block_loop_mix_counts_one_pass_of_the_loop():
    loop = chip_smoke.block_loop_mix(SASS, "sha256_words_kernel")
    # 0x30 .. 0xd0: the backward branch at 0x100 to itself is not a loop
    assert sum(loop.values()) == 11
    assert loop["IADD3"] == 2 and loop["BRA"] == 1 and loop["LDG.E"] == 1
    assert "STG.E" not in loop and "EXIT" not in loop


def test_block_loop_mix_rejects_a_kernel_without_a_loop():
    with pytest.raises(ValueError):
        chip_smoke.block_loop_mix(SASS, "leaf_digests2d_kernel")


def test_sha_block_ops_splits_the_pipes():
    loop = chip_smoke.block_loop_mix(SASS, "sha256_words_kernel")
    alu, fma = chip_smoke.sha_block_ops(loop)
    assert alu == 5  # SHF, LOP3, 2 IADD3, PRMT
    assert fma == 2  # IMAD.IADD and IMAD.MOV; the address IMAD.WIDE is not SHA work
    assert chip_smoke.sha_block_ops(collections.Counter({"IMAD.WIDE.U32": 3})) == (0, 0)


def test_pipe_seconds_takes_the_busiest_pipe_or_the_issue_rate():
    card = chip_smoke.SMS * chip_smoke.CLOCK_HZ
    assert chip_smoke.pipe_seconds(64, 0) == pytest.approx(1 / card)
    assert chip_smoke.pipe_seconds(0, 128) == pytest.approx(1 / card)
    assert chip_smoke.pipe_seconds(64, 64) == pytest.approx(1 / card)  # issue-bound
    assert chip_smoke.pipe_seconds(96, 64) == pytest.approx(1.5 / card)  # ALU-bound


def test_ptxas_report_reads_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_ZN8celestia21leaf_digests2d_kernelE' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN8celestia21leaf_digests2d_kernelE\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 96 registers\n")
    assert chip_smoke.ptxas_report(log) == {"_ZN8celestia21leaf_digests2d_kernelE": {
        "spill_store_bytes": 8, "spill_load_bytes": 4, "registers": 96}}


ROUND_ALU = 880  # a plausible count of one block's 64 rounds alone


@pytest.mark.parametrize("k,throughput_ms,chain_ms,level_floor_ms", [
    # 130,560 inner nodes of 3 blocks at the card's ALU rate; one tree's 8
    # levels of 3 blocks' rounds; the level-at-a-time design's floor:
    # levels 1 and 2 throughput-bound, levels 3..8 one chain of 3
    # compressions each (3 x 2 x 1,265 clocks)
    (128, 0.0296, 8 * 3 * 2 * ROUND_ALU / 1.98e6, 0.0453),
    # 7 levels: the chain is the larger term, and every level of the
    # design is one chain
    (64, 0.0074, 7 * 3 * 2 * ROUND_ALU / 1.98e6, 0.0268),
])
def test_nmt_tree_floor_from_the_sass_counts(k, throughput_ms, chain_ms, level_floor_ms):
    throughput, chain = chip_smoke.nmt_tree_floor(k, 2, 1265, 118, ROUND_ALU, 0)
    assert throughput * 1e3 == pytest.approx(throughput_ms, abs=5e-5)
    assert chain * 1e3 == pytest.approx(chain_ms, rel=1e-9)
    level_floor = chip_smoke.chain_floor_seconds(chip_smoke.nmt_tree_levels(k, 2), 3, 1265, 118)
    assert level_floor * 1e3 == pytest.approx(level_floor_ms, abs=5e-5)
    # the function's bound is never above the design's floor
    assert max(throughput, chain) <= level_floor
    block = chip_smoke.chain_block_seconds(1265, 118)
    assert block == pytest.approx(2 * 1265 / chip_smoke.CLOCK_HZ)  # 16 ALU lanes a warp
    assert 3 * block * 1e6 == pytest.approx(3.83, abs=0.005)


def test_chain_floor_takes_the_larger_term_per_level():
    block = chip_smoke.chain_block_seconds(1265, 118)
    wide = chip_smoke.pipe_seconds(10**6 * 1265, 10**6 * 118)
    assert chip_smoke.chain_floor_seconds([10**6 // 2, 1], 2, 1265, 118) == pytest.approx(
        wide + 2 * block)
    # one family at k = 1: 2 trees of 2 leaves, one level of a node each, so
    # the chain is one node's 3 blocks of rounds
    assert chip_smoke.nmt_tree_levels(1, 1) == [2]
    assert chip_smoke.nmt_tree_floor(1, 1, 1265, 118, ROUND_ALU, 0)[1] == pytest.approx(
        3 * chip_smoke.chain_block_seconds(ROUND_ALU, 0))
    assert chip_smoke.tree_chain_seconds(10, 2, ROUND_ALU, 0) == pytest.approx(
        20 * 2 * ROUND_ALU / chip_smoke.CLOCK_HZ)


def _rounds_kernel(loads_in_rounds: int) -> str:
    """A tree kernel's SASS: an outer loop holding a 3-pass loop of
    ``loads_in_rounds`` shared loads with their round operations."""
    body = []
    addr = 0x40
    for _ in range(loads_in_rounds):
        for insn in ("LDS R4, [R2+0x40] ;", "SHF.R.W.U32.HI R5, R4, 0x6, R4 ;",
                     "LOP3.LUT R6, R5, R4, R7, 0x96, !PT ;", "IADD3 R8, R6, R5, R4 ;"):
            body.append(f"        /*{addr:04x}*/                   {insn}")
            addr += 0x10
    inner_end = addr
    body.append(f"        /*{addr:04x}*/              @!P1 BRA 0x40 ;")
    addr += 0x10
    body.append(f"        /*{addr:04x}*/                   STS [R3], R8 ;")
    addr += 0x10
    body.append(f"        /*{addr:04x}*/              @!P2 BRA 0x20 ;")
    assert inner_end > 0x40
    return ("\t\tFunction : _ZN8celestia15nmt_tree_kernelENS_8TreeArgsE\n"
            "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
            "        /*0010*/                   S2R R0, SR_TID.X ;\n"
            "        /*0020*/                   LDS R9, [R2] ;\n"
            "        /*0030*/                   LDS R10, [R2+0x4] ;\n"
            + "\n".join(body) + "\n        /*ffff*/                   EXIT ;\n")


def test_rounds_loop_mix_takes_the_loop_of_64_shared_loads():
    mix = chip_smoke.rounds_loop_mix(_rounds_kernel(64), "nmt_tree_kernel")
    assert mix["LDS"] == 64 and mix["SHF.R.W.U32.HI"] == 64
    assert "STS" not in mix  # the outer loop is not taken
    assert chip_smoke.sha_block_ops(mix) == (3 * 64, 0)
    # the widest loop is the outer one
    assert chip_smoke.block_loop_mix(_rounds_kernel(64), "nmt_tree_kernel")["STS"] == 1


def test_rounds_loop_mix_rejects_a_kernel_without_the_rounds_loop():
    with pytest.raises(ValueError):
        chip_smoke.rounds_loop_mix(_rounds_kernel(63), "nmt_tree_kernel")


@pytest.mark.parametrize("rows,nodes", [(True, False), (False, True)])
def test_shuffled_layout_prog_keeps_every_read(rows, nodes):
    """The lever measurement's programs undo the conflict-free order and
    nothing else: each thread keeps its row slots and its step count, each
    level its node entries (chip_smoke.py checks the parity on the card)."""
    import dataclasses

    import numpy as np

    from celestia_tpu_torch.ops import xor_cuda

    lay = xor_cuda.schedule_operands(16, "cpu").layout
    prog = chip_smoke.shuffled_layout_prog(lay, 7, rows, nodes)
    assert not np.array_equal(prog, lay.prog)
    moved = dataclasses.replace(lay, prog=prog)
    head = xor_cuda.HEADER
    for g in range(lay.groups):
        (a, words_a), (b, words_b) = lay.row_program(g), moved.row_program(g)
        assert np.array_equal(words_a, words_b)
        for t in range(xor_cuda.ENC_THREADS):
            n = int(words_a[t] >> 16)
            assert sorted(np.concatenate([a[:n, t] & 0xFFFF, a[:n, t] >> 16])) == \
                sorted(np.concatenate([b[:n, t] & 0xFFFF, b[:n, t] >> 16]))
        for lv in range(lay.n_levels):
            count, off = lay.prog[g, head + lv], lay.prog[g, head + lay.n_levels + lv]
            ea = lay.prog[g, off: off + 2 * count].reshape(-1, 2)
            eb = prog[g, off: off + 2 * count].reshape(-1, 2)
            assert sorted(map(tuple, ea)) == sorted(map(tuple, eb))


def test_decode_sweep_work_counts_the_decode_program_and_the_plan():
    """The decode sweep's bound: the core's butterflies from
    rs.decode_program's twiddles (0: no multiply) for each axis the sweep
    writes, one constant multiply per cell read or written, each byte a
    lane."""
    import numpy as np

    from celestia_tpu_torch.ops import repair, rs

    twiddles = rs.decode_program(256)
    assert chip_smoke.fft_butterflies(twiddles != 0) == (1538, 510)  # of 2,048 per lane
    # the encode's program marks a zero twiddle -1: the same count either way
    fft_group = rs.fft_program(128)[1]
    assert sum(chip_smoke.fft_butterflies(fft_group >= 0)) == 7 * 128
    k = 4
    present = np.ones((8, 8), dtype=bool)
    present[2, :] = False  # no decode in the row sweep: not counted
    present[5, [0, 6]] = False
    present[6, 1] = False
    plan = repair.plan_sweeps(present, k)[0]
    work = chip_smoke.decode_sweep_work(rs.decode_program(8), plan.scale_bytes, plan.write)
    mul, plain = chip_smoke.fft_butterflies(rs.decode_program(8) != 0)
    assert (work["axes"], work["reads"], work["written"]) == (2, 6 + 7, 3)
    lanes = chip_smoke.CELL_BYTES
    assert work["alu_ops"] == (2 * (mul * chip_smoke.FFT_MUL_OPS + plain * chip_smoke.FFT_PLAIN_OPS)
                               + 16 * chip_smoke.CONST_MUL_OPS) * lanes / 4
    assert work["lookups"] == (2 * mul + 16) * lanes
    assert work["bytes"] == 16 * lanes + 3 * 64


def test_opcode_counts_sums_each_base_opcode():
    loop = collections.Counter({"LDS.U8": 5, "LDS.128": 2, "PRMT": 7, "LOP3.LUT": 3,
                                "SHF.R.U32.HI": 1, "IADD3": 4})
    assert chip_smoke.opcode_counts(loop, ("LDS", "PRMT", "LOP3", "SHF", "STG")) == {
        "LDS": 7, "PRMT": 7, "LOP3": 3, "SHF": 1, "STG": 0}
    # one pass of the widest loop, as the decode sweep's sass_mix line reads it
    loop = chip_smoke.block_loop_mix(SASS, "sha256_words_kernel")
    assert chip_smoke.opcode_counts(loop, ("SHF", "LOP3", "PRMT", "LDG")) == {
        "SHF": 1, "LOP3": 1, "PRMT": 1, "LDG": 1}


@pytest.mark.parametrize("k,levels", [
    (1, [4, 2, 1]),
    (2, [8, 4, 2, 1]),
    (128, [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]),  # the 10 levels of K3's old launches
])
def test_dah_levels_are_the_merkle_trees_levels(k, levels):
    assert chip_smoke.dah_levels(k) == levels


def test_hashlib_merkle_is_the_plain_merkle():
    import numpy as np
    import torch

    from celestia_tpu_torch.ops import merkle_cuda

    roots = np.random.default_rng(5).integers(0, 256, size=(2, 16, 90), dtype=np.uint8)
    plain = merkle_cuda.dah_merkle_reference(torch.from_numpy(roots)).numpy()
    assert [chip_smoke.hashlib_merkle(r) for r in roots] == [p.tobytes() for p in plain]


def test_repair_masks_plan_one_row_sweep_then_a_column_sweep():
    from celestia_tpu_torch.ops import repair

    masks = chip_smoke.repair_masks(8)
    assert [label for label, _p in masks] == [
        "random_7", "random_8", "random_9", "random_10", "row_column_corner"]
    for label, present in masks:
        assert present.shape == (16, 16)
        if label.startswith("random"):
            assert (~present).sum() == 64  # 25% of the cells
    assert [p.transpose for p in repair.plan_sweeps(masks[-1][1], 8)] == [False, True]


def test_numpy_locator_is_the_ports_locator():
    import numpy as np

    from celestia_tpu_torch.ops import gf256

    erased = np.random.default_rng(3).integers(0, 2, size=(9, 256)).astype(np.int64)
    assert np.array_equal(chip_smoke.numpy_locator(erased),
                          gf256._error_locator_logs_batch(erased))


# ---- the serving phase (6b)

def _serving_source() -> str:
    src = (REPO / "chip_smoke.py").read_text()
    return src[src.index("    # ---- phase 6b"):src.index("    # ---- phase 6c")]


def _proposal_source() -> str:
    src = (REPO / "chip_smoke.py").read_text()
    return src[src.index("    # ---- phase 6c"):src.index("    # ---- phase 6d")]


def _store_source() -> str:
    src = (REPO / "chip_smoke.py").read_text()
    return src[src.index("    # ---- phase 6d"):src.index("    # ---- phase 6e")]


def _chain_source() -> str:
    src = (REPO / "chip_smoke.py").read_text()
    return src[src.index("    # ---- phase 6e"):src.index("    # ---- phase 7: timing")]


def test_kernel_sources_name_every_kernel_of_the_port():
    """The ``kernels`` line lists all twelve kernels (the tree's row-block
    mode with a row of its own): every wrapper's launch count, its source in
    the repo and the line of the JAX code it replaces."""
    from celestia_tpu_torch.ops import _cuda

    assert list(chip_smoke.KERNEL_SOURCES) == list(_cuda.LAUNCHES)
    assert len(chip_smoke.KERNEL_SOURCES) == 12
    assert "nmt_reduce_levels(" in (REPO / "celestia_tpu/parallel/__init__.py").read_text(
        ).splitlines()[337]
    for name, (source, replaces) in chip_smoke.KERNEL_SOURCES.items():
        assert (REPO / source).is_file(), name
        path, line = replaces.split(":")
        assert 0 < int(line) <= len((REPO / path).read_text().splitlines()), name
    assert chip_smoke.KERNEL_SOURCES["ragged_gather"] == (
        "celestia_tpu_torch/csrc/ragged_gather.cu", "celestia_tpu/ops/ragged.py:51")
    assert "def _jitted_gather" in (REPO / "celestia_tpu/ops/ragged.py").read_text(
        ).splitlines()[51]
    assert chip_smoke.KERNEL_SOURCES["assemble_square"] == (
        "celestia_tpu_torch/csrc/assemble_square.cu", "celestia_tpu/ops/extend_tpu.py:766")
    assert (REPO / "celestia_tpu/ops/extend_tpu.py").read_text().splitlines()[765].startswith(
        "def _assemble_square(")


def test_proposal_phase_catches_no_failure():
    """Every check of the proposal phase raises (no except clause), and it
    reports the kernel against its plain version, the main path's launches,
    the oracle DAHs through the assembly and the proposal's times."""
    import ast
    import textwrap

    src = _proposal_source()
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ('phase="kernel_vs_plain", kernel="assemble_square"',
                 'entry="assembled_proposal_dah"', 'route="assembled"', 'phase="proposal"',
                 'launches["assemble_square"]'):
        assert name in src, name
    assert src.count("check(") >= 8


def test_serving_phase_catches_no_failure():
    """Every check of the phase raises: no except clause in it (a finally
    only restores state), and each of its parts reports under its name."""
    import ast
    import textwrap

    tree = ast.parse(textwrap.dedent(_serving_source()))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    src = _serving_source()
    for name in ('part="full_width"', 'part="tight_budget"', 'part="resident"',
                 'phase="kernel_vs_plain", kernel="ragged_gather"',
                 'phase="integrity_drill", site="cache.faultin"',
                 'entry="Node.sample_batch_ragged"', 'entry="Node._row_provers"'):
        assert name in src, name
    assert src.count("check(") >= 15


def test_store_phase_catches_no_failure():
    """Every check of the store phase raises: no except clause in it (a
    finally only removes its directory), and each part reports under its
    name: the persist's launches, the restart crowd's, the store lines,
    the kernel against its plain version on store-loaded pages and both
    drills."""
    import ast
    import textwrap

    src = _store_source()
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ('entry="Node._persist_block_eds"', 'cache="store_restart"',
                 'cache="store_tight"', 'part="persist"', 'part="restart"',
                 'part="vs_paged"', 'part="tight_budget"',
                 '"ragged_gather on the store-loaded pages"',
                 'phase="integrity_drill", site="store.read"',
                 'phase="integrity_drill", site="store.reindex"',
                 '"celestia_tpu_torch.cli", "store"', "shutil.rmtree(home"):
        assert name in src, name
    assert src.count("check(") >= 20


def test_serving_crowd_is_seeded_and_uniform():
    a = chip_smoke.serving_crowd(7, (1, 2, 3, 4), 256, 4096)
    assert a == chip_smoke.serving_crowd(7, (1, 2, 3, 4), 256, 4096)
    assert a != chip_smoke.serving_crowd(8, (1, 2, 3, 4), 256, 4096)
    hs = [h for h, _i, _j in a]
    assert {hs.count(h) for h in (1, 2, 3, 4)} <= set(range(900, 1150))
    assert all(0 <= i < 256 and 0 <= j < 256 for _h, i, j in a)
    assert all(type(v) is int for t in a[:5] for v in t)


def test_gather_case_is_the_crowds_one_bucket():
    """The kernel's timed input is what ``pages_batch`` gathers for the
    crowd: each distinct (height, row) once, from its page, in order."""
    import numpy as np
    import torch

    from celestia_tpu_torch.ops import ragged_cuda

    rng = np.random.default_rng(3)
    squares = {h: torch.from_numpy(rng.integers(0, 256, size=(16, 16, 8), dtype=np.uint8))
               for h in (1, 2)}
    pages = {h: [sq[lo:lo + 4].clone() for lo in range(0, 16, 4)] for h, sq in squares.items()}
    crowd = chip_smoke.serving_crowd(5, (1, 2), 16, 40)
    case = chip_smoke.gather_case(lambda h: pages[h], crowd, 4)
    distinct = list(dict.fromkeys((h, i) for h, i, _j in crowd))
    assert len(case[1]) == len(case[2]) == len(distinct)
    assert len(case[0]) == len({(h, i // 4) for h, i in distinct})
    got = ragged_cuda.gather_rows_reference(*case)
    for t, (h, i) in enumerate(distinct):
        assert torch.equal(got[t], squares[h][i])


@pytest.mark.parametrize("family", chip_smoke.ASSEMBLY_FAMILIES)
@pytest.mark.parametrize("k", [1, 4, 16])
def test_assembly_case_is_an_input_assembled_roots_accepts(k, family):
    case = chip_smoke.assembly_case(k, 5, family)
    s = k * k
    starts, pos = case["blob_start"], case["host_pos"]
    assert all(a < b for a, b in zip(starts, starts[1:])) and all(0 <= x < s for x in starts)
    assert all(a < b for a, b in zip(pos, pos[1:])) and all(0 <= x < s for x in pos)
    assert len(case["host_row"]) == len(pos)
    assert len(pos) == 0 or 0 <= case["host_row"].min() <= case["host_row"].max() < len(
        case["host_shares"])
    n = len(starts)
    assert all(len(case[f]) == n for f in ("blob_nshares", "blob_off", "blob_len"))
    assert case["ns_table"].shape == (n, 29) and case["host_shares"].shape[1] == 512
    assert (case["blob_nshares"] >= 1).all() and (case["blob_len"] >= 1).all()
    # no blob runs into the next one's start
    assert all(st + ns <= nxt for st, ns, nxt in zip(starts, case["blob_nshares"],
                                                     list(starts[1:]) + [s]))
    past_end = case["blob_off"] + case["blob_len"] > len(case["arena"])
    assert past_end.any() if family == "arena_edge" else not past_end.any()
    if family == "no_blobs":
        assert n == 0
    if family == "one_blob":
        assert n == 1


def test_misaligned_case_covers_every_shift_whatever_the_seed():
    """The ``misaligned`` family from k = 8 on: the shift r between a share's
    arena bytes and its aligned cell takes all 16 values on first shares
    and on later shares, the last shares end at every residue mod 16 of
    the cell (one at its last byte), one-share blobs are among them, and
    the arena's size is not a multiple of 16, with a blob ending on its
    last byte."""
    import numpy as np

    def shift(off: int, j: int) -> int:
        """r of share j: the arena index its cell's byte 0 would have, mod 16
        (the data from off + doff lands at cell byte 34 or 30)."""
        return (off + (478 + (j - 1) * 482 - 30 if j else -34)) % 16

    for k in (8, 16, 128):
        for seed in (0, 1, 2, 3, 4, 12345):
            case = chip_smoke.assembly_case(k, seed, "misaligned")
            off, n, ln = (case[f].astype(int) for f in ("blob_off", "blob_nshares", "blob_len"))
            firsts = {shift(o, 0) for o in off}
            laters = {shift(o, j) for o, m in zip(off, n) for j in range(1, m)}
            assert firsts == laters == set(range(16)), (k, seed)
            last = np.where(n == 1, ln, ln - 478 - (n - 2) * 482)
            ends = np.where(n == 1, 34, 30) + last
            assert set(ends % 16) == set(range(16)) and (ends == 512).any(), (k, seed)
            assert (n == 1).sum() >= 2
            n_arena = len(case["arena"])
            assert n_arena % 16 and (off + ln == n_arena).any(), (k, seed)
    # a 4 KiB-aligned slot: 14 on the first share, 2 (j - 1) mod 16 after
    assert [shift(4096, j) for j in range(4)] == [14, 0, 2, 4]


def test_assembly_case_rejects_an_unknown_family():
    with pytest.raises(ValueError):
        chip_smoke.assembly_case(4, 0, "no_such_family")


def test_proposal_txs_fill_a_k128_square():
    """bench.py config 8b's traffic: 60 blob txs, each one blob of 120,000
    bytes in its own namespace; the port's build_ex keeps all of them in a
    k = 128 square, and the assembly's byte count is the issue's."""
    from celestia_tpu_torch import blob, square

    txs = chip_smoke.proposal_txs()
    assert len(txs) == chip_smoke.PROPOSAL_BLOBS == 60
    parsed = [blob.unmarshal_blob_tx(tx)[0] for tx in txs]
    assert all(len(p.tx) == chip_smoke.PFB_INNER_BYTES and len(p.blobs) == 1 for p in parsed)
    assert len({p.blobs[0].namespace().bytes for p in parsed}) == 60
    assert {len(p.blobs[0].data) for p in parsed} == {120_000}
    sq, kept, builder = square.build_ex(txs, 1, chip_smoke.PROPOSAL_K)
    assert kept == txs and square.square_size(len(sq)) == 128
    assert len(builder.blob_layout()) == 60
    assert chip_smoke.assembly_bytes(128, [120_000] * 60, 0) == 128 * 128 * 512 + 7_200_000


# ---- the chain phase (6e)

def _chain_block():
    """config 8b's block as phase 6e signs it, with the port alone: the
    key, the blobs and the 60 BlobTxs' bytes."""
    from celestia_tpu_torch import crypto
    from celestia_tpu_torch.x.blob.types import new_msg_pay_for_blobs

    key = crypto.PrivateKey.from_secret(chip_smoke.CHAIN_KEY_SECRET)
    blobs = chip_smoke.config_8b_blobs()
    raws = [chip_smoke.sign_chain_tx(key, new_msg_pay_for_blobs(key.bech32_address(), b), b, i)[1]
            for i, b in enumerate(blobs)]
    return key, blobs, raws


def test_chain_phase_catches_no_failure():
    """Every check of the chain phase raises (no except clause: a refused
    tx is a result code of chain_check, as in the App), and it reports the
    main path's launches and the chain line with the hashes."""
    import ast
    import textwrap

    src = _chain_source()
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ('entry="assembled_proposal_dah", block="chain"', 'phase="chain"',
                 '"account sequence mismatch"', '"invalid share commitment"',
                 '"signature verification failed"', "CHAIN_APP_HASH", "CHAIN_DAH_HASH",
                 "extend.roots_device(c_arr, dev)"):
        assert name in src, name
    assert src.count("check(") >= 11


def test_config_8b_blobs_are_bench_pys():
    """The same namespaces and bytes as bench.py:741-757 draws them."""
    from celestia_tpu import blob as jblob
    from celestia_tpu import namespace as jns

    rng = np.random.default_rng(11)
    want = [jblob.new_blob(jns.new_v0(b"arena" + i.to_bytes(5, "big")),
                           rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes(), 0)
            for i in range(60)]
    got = chip_smoke.config_8b_blobs()
    assert [(b.namespace().bytes, b.data) for b in got] == \
        [(b.namespace().bytes, b.data) for b in want]


def test_chain_constants_are_the_jax_packages_app_hash_and_dah():
    """Phase 6e's two constants, recomputed with the JAX package: the
    port-signed txs go through the JAX keepers as App.init_chain,
    check_tx, begin_block, deliver_tx and commit run them
    (celestia_tpu/app/app.py:238-267, :704-746, :890-976, :1281-1293),
    and the square the JAX build_ex makes of them through its host
    extend."""
    import dataclasses

    from celestia_tpu import blob as jblob
    from celestia_tpu import da, square
    from celestia_tpu.app.ante import AnteHandler
    from celestia_tpu.app.context import Context, ExecMode
    from celestia_tpu.shares import to_bytes
    from celestia_tpu.state import StateStore
    from celestia_tpu.tx import decode_tx
    from celestia_tpu.x.auth import AccountKeeper
    from celestia_tpu.x.bank import BLOCK_TIME_KEY, BankKeeper
    from celestia_tpu.x.blob.keeper import BlobKeeper, Params
    from celestia_tpu.x.blob.types import validate_blob_tx
    from celestia_tpu.x.distribution import DistributionKeeper
    from celestia_tpu.x.mint import MintKeeper
    from celestia_tpu.x.staking import StakingKeeper

    key, _blobs, raws = _chain_block()

    def ctx_of(store, mode, block_time):
        return Context(store=store, chain_id=chip_smoke.CHAIN_ID, block_height=1,
                       block_time=block_time, app_version=1, mode=mode)

    store = StateStore()
    bank = BankKeeper(store)
    BlobKeeper(store).set_params(Params())
    store.set(BLOCK_TIME_KEY, repr(0.0).encode())
    MintKeeper(store, bank).init_genesis(0.0)
    AccountKeeper(store).get_or_create(key.bech32_address())
    bank.mint(key.bech32_address(), chip_smoke.CHAIN_GENESIS_BALANCE)
    store.commit()
    check_store = store.branch()
    for raw in raws:
        btx, is_blob = jblob.unmarshal_blob_tx(raw)
        assert is_blob
        tx = validate_blob_tx(btx)
        branch = check_store.branch()
        AnteHandler()(ctx_of(branch, ExecMode.CHECK, 0.0), tx, len(btx.tx))
        branch.write()
    deliver = store.branch()
    block_ctx = ctx_of(deliver, ExecMode.DELIVER, chip_smoke.CHAIN_BLOCK_TIME)
    deliver.set(BLOCK_TIME_KEY, repr(chip_smoke.CHAIN_BLOCK_TIME).encode())
    bank = BankKeeper(deliver)
    MintKeeper(deliver, bank).begin_blocker(block_ctx)
    DistributionKeeper(deliver, bank, StakingKeeper(deliver, bank)).begin_blocker(block_ctx)
    for raw in raws:
        inner = jblob.unmarshal_blob_tx(raw)[0].tx
        tx = decode_tx(inner)
        ante_store = deliver.branch()
        ctx = AnteHandler()(dataclasses.replace(block_ctx, store=ante_store, events=[]),
                            tx, len(inner))
        ante_store.write()
        msg_store = deliver.branch()
        BlobKeeper(msg_store).pay_for_blobs(dataclasses.replace(ctx, store=msg_store), tx.msgs[0])
        msg_store.write()
    deliver.write()
    assert store.commit().hex() == chip_smoke.CHAIN_APP_HASH

    data_square, kept, _builder = square.build_ex(raws, 1, chip_smoke.PROPOSAL_K)
    assert kept == raws and square.square_size(len(data_square)) == 128
    eds = da.extend_shares(np.frombuffer(b"".join(to_bytes(data_square)), np.uint8)
                           .reshape(-1, 512))
    assert da.new_data_availability_header(eds).hash().hex() == chip_smoke.CHAIN_DAH_HASH


def test_chain_host_path_accepts_the_block_and_refuses_the_three():
    """chip_smoke's own host path with the port's keepers: 60 of 60
    accepted at CheckTx and DeliverTx, the reused sequence and the flipped
    blob refused with the JAX package's messages, the app hash pinned."""
    from celestia_tpu_torch import blob
    from celestia_tpu_torch.x.blob.types import new_msg_pay_for_blobs

    key, blobs, raws = _chain_block()
    store = chip_smoke.chain_genesis(key.bech32_address())
    check_store = store.branch()
    times = {}
    assert [chip_smoke.chain_check(check_store, raw, times) for raw in raws] == [(0, "")] * 60
    assert len(times["check_ante"]) == len(times["validate_blob_tx"]) == 60
    msg0 = new_msg_pay_for_blobs(key.bech32_address(), blobs[0])
    tx0, reused = chip_smoke.sign_chain_tx(key, msg0, blobs[0], 59)
    assert chip_smoke.chain_check(check_store, reused) == (
        1, "account sequence mismatch: expected 60, got 59")
    b = blobs[0]
    flipped = blob.marshal_blob_tx(tx0.marshal(), [blob.new_blob(
        b.namespace(), bytes([b.data[0] ^ 1]) + b.data[1:], 0)])
    assert chip_smoke.chain_check(check_store, flipped) == (1, "invalid share commitment")
    results, app_hash = chip_smoke.chain_deliver(store, raws, times)
    assert results == [(0, "")] * 60 and len(times["deliver"]) == 60
    assert app_hash.hex() == chip_smoke.CHAIN_APP_HASH


def test_app_phase_catches_no_failure():
    """Phase 6f holds no except clause: a refusal, a degrade or a wrong
    hash raises. It checks the launches, spans and counters after every
    App entry, both pinned app hashes and the DAH, the valset, the
    transfer, and the drill's strike, sticky disable and quarantine; and
    main runs it."""
    import ast
    import inspect
    import textwrap

    src = inspect.getsource(chip_smoke.app_phase)
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ("APP_HASH_2", "APP_HASH_3", "CHAIN_DAH_HASH", "APP_LAUNCHES[entry]",
                 'arena == {"assembled": 1, "fallback": 0}', "stats0[name]",
                 'attrs.get("backend") == "gpu"', "degrade_counts(metrics)",
                 "accepted is True", "eds.device_data is not None", "latest_valset()",
                 "escrow_address", '"device.extend", "error", times=1',
                 '"process_proposal_panics": 1', '"device.extend", "unavailable", times=1',
                 '"device.extend", "unavailable", times=3', "d_app._gpu_disabled",
                 '"device.extend.output", "bitflip"', 'last_sdc["befp_provable"] is True',
                 'integrity.configure("off")', 'phase="app"', 'phase="crossover"',
                 "crossover.save(crossover_out)"):
        assert name in src, name
    assert src.count("check(") >= 20
    main = inspect.getsource(chip_smoke.main)
    assert "app_phase(dev, emit, c_key, c_raws, args.crossover_out)" in main
    assert main.index("app_phase(") < main.index("# ---- phase 7")


def test_every_phase_is_timed():
    """Each ``# ---- phase`` of main starts its wall clock on the line
    before, in order, and the phase_seconds line comes before the kernels
    line."""
    import inspect
    import re

    main = inspect.getsource(chip_smoke.main)
    phases = re.findall(r"^    # ---- phase (\w+):", main, re.M)
    marks = re.findall(r'^    phase_start\("(\w+)"\)\n    # ---- phase (\w+):', main, re.M)
    assert len(phases) >= 12 and [m[0] for m in marks] == [m[1] for m in marks] == phases
    assert main.index('phase="phase_seconds"') < main.index('{"kernels": kernels}')


def test_app_launches_are_phase_4s_route_and_6cs_assembly():
    """ProcessProposal and ExtendBlock launch the fused dense route's set
    (K2 1, K1 3, the tree 1); PrepareProposal adds the one assembly."""
    want = chip_smoke.APP_LAUNCHES
    assert want["process_proposal"] == want["extend_block"] == {
        "leaf_digests2d": 1, "encode2d_hash": 3, "nmt_tree": 1}
    assert want["prepare_proposal"] == {**want["process_proposal"], "assemble_square": 1}


def test_app_constants_are_the_jax_apps():
    """Phase 6f's pinned hashes, recomputed with the JAX package's App on
    the CPU (native backend) fed the port-signed txs through the same
    helpers: the empty height 1, config 8b's 60 PFBs at height 2 (its
    proposal's DAH is phase 6e's CHAIN_DAH_HASH: the same square), and
    height 3's three txs over the transfer channel."""
    from celestia_tpu.app.app import App
    from celestia_tpu.x.transfer import escrow_address
    from celestia_tpu_torch import crypto

    key, _blobs, raws = _chain_block()
    v_key = crypto.PrivateKey.from_secret(chip_smoke.APP_VALIDATOR_SECRET)
    app = App(chain_id=chip_smoke.CHAIN_ID, extend_backend="native")
    chip_smoke.app_genesis(app, key.bech32_address(), v_key.bech32_address())
    p1 = app.prepare_proposal([])
    assert p1.txs == [] and app.process_proposal(p1)
    chip_smoke.app_block(app, [], chip_smoke.APP_BLOCK_TIMES[0])
    assert [app.check_tx(raw).code for raw in raws] == [0] * 60
    p2 = app.prepare_proposal(raws)
    assert p2.txs == raws and p2.square_size == chip_smoke.PROPOSAL_K
    assert p2.hash.hex() == chip_smoke.CHAIN_DAH_HASH and app.process_proposal(p2)
    results, h2 = chip_smoke.app_block(app, p2.txs, chip_smoke.APP_BLOCK_TIMES[1])
    assert [r.code for r in results] == [0] * 60
    assert h2.hex() == chip_smoke.APP_HASH_2
    chip_smoke.open_transfer_channel(app)
    t3 = chip_smoke.app_height3_txs(key, v_key)
    assert [app.check_tx(t).code for t in t3] == [0, 0, 0]
    p3 = app.prepare_proposal(t3)
    assert p3.txs == t3 and app.process_proposal(p3)
    results, h3 = chip_smoke.app_block(app, p3.txs, chip_smoke.APP_BLOCK_TIMES[2])
    assert [r.code for r in results] == [0, 0, 0]
    assert h3.hex() == chip_smoke.APP_HASH_3
    valset = app.blobstream.latest_valset()
    assert valset["height"] == 3
    assert [m["evm_address"] for m in valset["members"]] == [chip_smoke.APP_EVM_ADDRESS]
    assert app.bank.get_balance(escrow_address("transfer", chip_smoke.APP_CHANNEL)) == \
        chip_smoke.APP_TRANSFER


def test_the_drills_proposal_is_a_square_the_table_sends_to_the_card():
    """Phase 6f's drill proposes the block's first DRILL_TXS PFBs on a
    replica of height 1: a k = 32 square that the port's App accepts and
    that the committed crossover table routes to the card."""
    from celestia_tpu_torch import crypto
    from celestia_tpu_torch.app import calibration
    from celestia_tpu_torch.app.app import App

    key, _blobs, raws = _chain_block()
    v_key = crypto.PrivateKey.from_secret(chip_smoke.APP_VALIDATOR_SECRET)
    app = App(chain_id=chip_smoke.CHAIN_ID, extend_backend="native", device="cpu")
    chip_smoke.app_genesis(app, key.bech32_address(), v_key.bech32_address())
    chip_smoke.app_block(app, [], chip_smoke.APP_BLOCK_TIMES[0])
    p = app.prepare_proposal(raws[:chip_smoke.DRILL_TXS])
    assert p.txs == raws[:chip_smoke.DRILL_TXS] and p.square_size == 32
    assert app.process_proposal(p)
    assert calibration.load_default_table().winner(p.square_size) == "gpu"


# ---- the node phase (6g)

def test_node_phase_catches_no_failure():
    """Phase 6g holds no except clause: a refusal, a degrade, a retention
    failure or a wrong hash raises. It checks the launches, spans and
    counters after every block, the pinned hashes of heights 2 and 3 on
    both nodes, the blocks' bytes, the mempools and tx index, the restart's
    one batched check and its crowd's one gather with every proof
    verified, and the state sync with its refusal; and main runs it after
    phase 6f."""
    import ast
    import inspect
    import textwrap

    src = inspect.getsource(chip_smoke.node_phase)
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ("APP_HASH_2", "CHAIN_DAH_HASH", "NODE_APP_HASH_3", "NODE_DAH_HASH_3",
                 "NODE_LAUNCHES[entry]", 'a.get("backend") == "gpu"', "degrade_counts(metrics)",
                 "retention_failures(metrics)", "expected_height=1", "expected_height=2",
                 "expected_height=3", "save_snapshot()", "broadcast_tx(raw)",
                 'read_bytes() == (home / "r/blocks/2.json").read_bytes()',
                 "len(node.mempool) == 0", "get_tx(tx_hash(raw))", "Node.load(r_home, device=dev)",
                 '"batched_roots_device"', 'attrs.get("batch") == 2', "batched_launches",
                 'counts["ragged_gather"] == 1', "verify_inclusion", "block_dah(2)",
                 "state_sync_from(payload", "flip_state_byte(payload)",
                 '"snapshot app hash mismatch"', 'phase="node"', "shutil.rmtree(home"):
        assert name in src, name
    assert src.count("check(") >= 20
    main = inspect.getsource(chip_smoke.main)
    assert "node_phase(dev, emit, c_key, c_raws, batched_launches[(PROPOSAL_K, 2)])" in main
    assert main.index("app_phase(") < main.index("node_phase(") < main.index("# ---- phase 7")
    assert "crc32c=integrity.crc32c_implementation()" in main


def test_node_launches_are_derived_from_the_app_launches():
    """The node's expected launches are sums of APP_LAUNCHES and the
    persist's row levels, computed, not typed: changing APP_LAUNCHES moves
    them. The proposer's own block is PrepareProposal twice over (its
    ProcessProposal assembles from its arena too), ExtendBlock and the
    persist; a replica's is ProcessProposal, ExtendBlock and the persist."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(chip_smoke))
    node_launches = [n for n in tree.body if isinstance(n, ast.Assign)
                     and any(getattr(t, "id", None) == "NODE_LAUNCHES" for t in n.targets)]
    assert len(node_launches) == 1
    assert not [n for n in ast.walk(node_launches[0].value) if isinstance(n, ast.Constant)
                and isinstance(n.value, int) and not isinstance(n.value, bool)]
    assert chip_smoke.PERSIST_LAUNCHES == {"leaf_digests2d": 1, "nmt_tree": 1}
    app = chip_smoke.APP_LAUNCHES
    assert chip_smoke.NODE_LAUNCHES == {
        "produce_block": {"assemble_square": 2, "leaf_digests2d": 4, "encode2d_hash": 9,
                          "nmt_tree": 4},
        "apply_external_block": {"leaf_digests2d": 3, "encode2d_hash": 6, "nmt_tree": 3}}
    saved = {e: dict(c) for e, c in app.items()}
    try:
        app["extend_block"]["encode2d_hash"] = 5
        assert chip_smoke.node_launches(True)["encode2d_hash"] == 11
        assert chip_smoke.node_launches(False)["encode2d_hash"] == 8
    finally:
        app.clear()
        app.update(saved)


def test_flip_state_byte_changes_one_byte_of_a_stored_value():
    """The refused payload differs from the snapshot in one byte, still
    parses, and restores to another app hash."""
    from celestia_tpu_torch.state import StateStore

    store = StateStore()
    store.set(b"k1", b"\x01\x02")
    store.set(b"k2", b"\x33" * 8)
    store.commit()
    payload = {"state": store.snapshot().hex(), "height": 1}
    flipped = chip_smoke.flip_state_byte(payload)
    a, b = bytes.fromhex(payload["state"]), bytes.fromhex(flipped["state"])
    assert len(a) == len(b) and sum(x != y for x, y in zip(a, b)) == 1
    assert flipped["height"] == 1
    restored = StateStore.restore(b)
    assert restored.app_hashes[restored.version] != store.app_hashes[store.version]


def test_raised_returns_the_exception_or_none():
    err = chip_smoke.raised(lambda: int("x"))
    assert isinstance(err, ValueError)
    assert chip_smoke.raised(lambda: 1) is None


def test_node_constants_are_the_jax_nodes():
    """Phase 6g's pinned hashes of height 3, recomputed with the JAX
    package's Node over its App on the CPU (native backend), fed the
    port-signed txs: the empty height 1, config 8b's 60 PFBs at height 2
    (APP_HASH_2, CHAIN_DAH_HASH) and the 60 of ``node_height3_txs`` at
    height 3, each through broadcast_tx and produce_block."""
    from celestia_tpu.app.app import App
    from celestia_tpu.node.node import Node
    from celestia_tpu_torch import crypto

    key, _blobs, raws = _chain_block()
    v_key = crypto.PrivateKey.from_secret(chip_smoke.APP_VALIDATOR_SECRET)
    app = App(chain_id=chip_smoke.CHAIN_ID, extend_backend="native")
    chip_smoke.app_genesis(app, key.bech32_address(), v_key.bech32_address())
    node = Node(app)
    b1 = node.produce_block(chip_smoke.APP_BLOCK_TIMES[0])
    assert b1.txs == [] and b1.square_size == 1
    assert [node.broadcast_tx(raw).code for raw in raws] == [0] * 60
    b2 = node.produce_block(chip_smoke.APP_BLOCK_TIMES[1])
    assert b2.txs == raws and b2.square_size == chip_smoke.PROPOSAL_K
    assert b2.app_hash.hex() == chip_smoke.APP_HASH_2
    assert b2.data_hash.hex() == chip_smoke.CHAIN_DAH_HASH
    t3 = chip_smoke.node_height3_txs(key)
    assert [node.broadcast_tx(raw).code for raw in t3] == [0] * 60
    b3 = node.produce_block(chip_smoke.APP_BLOCK_TIMES[2])
    assert b3.txs == t3 and b3.square_size == chip_smoke.PROPOSAL_K
    assert [r.code for r in b3.tx_results] == [0] * 60
    assert b3.app_hash.hex() == chip_smoke.NODE_APP_HASH_3
    assert b3.data_hash.hex() == chip_smoke.NODE_DAH_HASH_3


def test_lane_phase_catches_no_failure():
    """Phase 6h holds no except clause (its try blocks only clean up): a
    byte difference, a launch count, a retrace, growing unattributed bytes,
    a wrong document, a missing shed, a degrade, a pinned view in a retired
    block or a pipeline leg off the dispatcher's thread raises. main runs it after
    phase 6g with phase 6b's squares and crowd, and phase 7 prints the XOR
    crossover beside its table."""
    import ast
    import inspect
    import textwrap

    src = inspect.getsource(chip_smoke.lane_phase)
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ("PIPELINE_LAUNCHES", "same_block(b, refs[b.height])", 'shed.reason == "draining"',
                 "depth=1", "devledger.end_warmup()", "strict_retraces()",
                 "retrace_count() == 0", 'after["unattributed_bytes"] <= before["unattributed_bytes"]',
                 "debug_doc()", "extend_pipeline(k)", "block_dah(h).hash()", "read_levels(h)",
                 "read_page(h, 0)", "_prover_cache[h][0] is not None", "read_counts[h] == zero",
                 "node.dispatcher = disp", "register_device_executor(disp.run_device)",
                 "crowd_through(disp, node.sample_batch_ragged", "docs == direct",
                 'counts["ragged_gather"] == batches', "busy > 0", '"dispatch.run", "delay"',
                 'full.reason == "queue_full"', "DeadlineExceeded", "CodecBackend(device=\"cpu\")",
                 "call_in_process(gpu, method, raw)", "CODEC_EXTEND_LAUNCHES",
                 "plan_sweeps(present, kk)", "fallbacks() == fallbacks0",
                 'find_spec("grpc")', 'part="pipeline"', 'part="ledger"', 'part="dispatcher"',
                 'part="codec"', "shutil.rmtree(home", "np.shares_memory(a, h.numpy())",
                 "extend_pipeline(k, depth=depth)", "dnode.dispatcher = disp",
                 "dcounts == want", "same_block(b, refs[b.height]) for b in dblocks",
                 "leg_threads == {disp_thread}", 'host_pool["reused"] > 0'):
        assert name in src, name
    assert src.count("check(") >= 25
    main = inspect.getsource(chip_smoke.main)
    assert "lane_phase(dev, emit, [bench_square(sk, seed) for seed in LANE_SEEDS], crowd0," \
        in main
    assert main.index("node_phase(") < main.index("lane_phase(") < main.index("# ---- phase 7")
    assert main.index('emit(phase="xor_table"') < main.index("measure_xor_crossover(device=dev)")


def test_lane_constants():
    """Six of bench.py's squares (seeds 42-47, build_square's); the launches
    of a pipelined block and of the codec's extend are derived from the App's
    ExtendBlock and the persist's row levels, not typed."""
    import ast
    import inspect

    assert chip_smoke.LANE_SEEDS == (42, 43, 44, 45, 46, 47)
    assert chip_smoke.CODEC_KS == (32, 128) and chip_smoke.LANE_THREADS == 8
    assert chip_smoke.CODEC_EXTEND_LAUNCHES == {"leaf_digests2d": 1, "encode2d_hash": 3,
                                                "nmt_tree": 1}
    assert chip_smoke.PIPELINE_LAUNCHES == {"encode2d": 3, "leaf_digests2d": 1,
                                            "nmt_tree": 2, "dah_merkle": 1}
    tree = ast.parse(inspect.getsource(chip_smoke))
    assigns = [n for n in tree.body if isinstance(n, ast.Assign) and any(
        getattr(t, "id", None) == "PIPELINE_LAUNCHES" for t in n.targets)]
    assert len(assigns) == 1
    assert not [n for n in ast.walk(assigns[0].value) if isinstance(n, ast.Constant)
                and isinstance(n.value, int) and n.value > 1]


def _lane_square(k: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    sq = r.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    sq[..., :29] = 0
    sq[..., 28] = 7  # one namespace: the push order holds
    return sq


@pytest.mark.parametrize("keep", [True, False])
def test_stream_blocks_feeds_consecutive_heights_and_drains(keep):
    from celestia_tpu_torch.node.pipeline import BlockPipeline
    from celestia_tpu_torch.ops import extend

    squares = [_lane_square(2, s) for s in range(3)]
    out, wall = chip_smoke.stream_blocks(BlockPipeline(2, depth=2, device="cpu"), squares,
                                         first_height=5, keep=keep)
    assert wall > 0
    if not keep:
        assert out == [5, 6, 7]
        return
    assert [b.height for b in out] == [5, 6, 7]
    for b, sq in zip(out, squares):
        eds, rows, cols, dah = extend.extend_and_root_device(sq, "cpu")
        ref = (eds, rows, cols, dah, extend.eds_row_levels_device(eds, "cpu"))
        assert chip_smoke.same_block(b, ref)
        bad = (eds, rows, cols, dah[::-1].copy(), ref[4])
        assert not chip_smoke.same_block(b, bad)


def test_crowd_through_answers_every_payload_in_order():
    from celestia_tpu_torch.node.dispatch import DeviceDispatcher
    from celestia_tpu_torch.telemetry import Registry

    reg = Registry()
    d = DeviceDispatcher(registry=reg).start()
    groups = []

    def exec_fn(payloads):
        groups.append(len(payloads))
        return [h * 10000 + i * 100 + j for h, i, j in payloads]

    try:
        crowd = chip_smoke.serving_crowd(3, (1, 2), 16, 40)
        out = chip_smoke.crowd_through(d, exec_fn, crowd, 4)
    finally:
        d.drain()
    assert out == [h * 10000 + i * 100 + j for h, i, j in crowd]
    assert sum(groups) == 40 and reg.get_counter("dispatch_batched_jobs_total") == 40


def test_lane_docs_are_the_nodes_documents():
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.eds_cache import ResidentEdsCache
    from celestia_tpu_torch.ops import extend

    k = 2
    eds = extend.extend_and_root_device(_lane_square(k, 4), "cpu")[0]
    node = Node(device="cpu")
    node._eds_cache = ResidentEdsCache()
    node._eds_cache.put(1, eds)
    coords = [(0, 1), (3, 3), (2, 0)]
    assert chip_smoke.lane_docs(eds, coords, k) == node.sample_batch(1, coords)


# ---- the multi-GPU phase (6i)


def test_mesh_phase_catches_no_failure():
    """Phase 6i holds no except clause (its try blocks only clean up and
    stop the processes it starts): a byte difference, a launch count, a
    routed mesh, a fallback, a pipelined block or a rank's DAH raises. main
    runs it after phase 6h, and its pipeline's launches feed the kernels
    line's row-block mode."""
    import ast
    import inspect
    import textwrap

    src = inspect.getsource(chip_smoke.mesh_phase)
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ("nmt_tree_rows_reference", "row_blocks(kk)", "MESH_SHAPES",
                 "n_cards > 1", "configure_mesh(mesh)", "ref_entries.items()",
                 'mesh_launches(sp, "row_c")', 'mesh_launches(sp, "roots")', "xor=True",
                 "make_mesh(1, 3", "sharded == [False]", "same_block(b, ref_stream[b.height])",
                 'backend == "nccl"', '"--multihost-worker"', "host_dahs", "p.kill()",
                 "shutil.rmtree(tmp", 'part="multihost"'):
        assert name in src, name
    assert src.count("check(") >= 12
    main = inspect.getsource(chip_smoke.main)
    assert 'launches["nmt_tree_rows"] = mesh_phase(' in main
    assert main.index("lane_phase(") < main.index("mesh_phase(") < main.index("# ---- phase 7")
    assert "multihost_worker(int(rank), int(world), int(port), path)" in main
    worker = inspect.getsource(chip_smoke.multihost_worker)
    assert 'backend="gloo"' in worker and "multihost.shutdown()" in worker


def test_mesh_only_runs_phase_6i_alone_after_the_build():
    """``--mesh-only`` (the cross-card reading on a machine of several
    cards) returns from main after the build, before phase 2, through
    ``mesh_only``, which runs phase 6i on its squares, prints the card's
    line and no ``ok`` line; with no arguments main runs every phase."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    branch = main.index("return mesh_only(")
    assert main.index("lib = _cuda.library()") < main.index("if args.mesh_only:") < branch
    assert branch < main.index("# ---- phase 2")
    assert main.index("def tree_square(") < branch and main.index("def bench_square(") < branch
    src = inspect.getsource(chip_smoke.mesh_only)
    assert "mesh_phase(dev, emit, same," in src and "MESH_SEEDS" in src and "LANE_SEEDS" in src
    assert "print(smi_line" in src and '"ok"' not in src
    assert "--mesh-only" in chip_smoke.__doc__
    assert chip_smoke.main.__code__.co_argcount == 1


def test_mesh_launches_are_the_single_device_routes_per_shard():
    """A mesh of sp shards launches K2 once and K1 three times a shard; at
    sp = 1 a roots call is the App's ExtendBlock set, and Row C hashes each
    shard's rows and the transpose with the row-block mode."""
    assert chip_smoke.mesh_launches(1, "roots") == chip_smoke.APP_LAUNCHES["extend_block"]
    assert chip_smoke.mesh_launches(2, "row_c") == {
        "leaf_digests2d": 2, "encode2d_hash": 6, "nmt_tree_rows": 3, "dah_merkle": 1}
    assert chip_smoke.mesh_launches(4, "extend") == {
        "leaf_digests2d": 4, "encode2d_hash": 12, "nmt_tree": 1, "dah_merkle": 1}
    assert chip_smoke.MESH_MAIN in chip_smoke.MESH_SHAPES
    assert chip_smoke.MESH_SEEDS == chip_smoke.LANE_SEEDS[:4]


@pytest.mark.parametrize("k", [1, 2, 8, 128])
def test_row_blocks_are_blocks_of_the_grid(k):
    """Every block is top rows below k and bottom rows from k, at least one
    row, and the shard blocks of the (1, 2) and (1, 4) meshes are there."""
    blocks = chip_smoke.row_blocks(k)
    for (a, b), (c, d) in blocks:
        assert 0 <= a <= b <= k <= c <= d <= 2 * k and (b - a) + (d - c) >= 1
    for sp in (2, 4):
        if k % sp == 0:
            rp = k // sp
            assert ((0, rp), (k, k + rp)) in blocks
            assert (((sp - 1) * rp, k), (k + (sp - 1) * rp, 2 * k)) in blocks


# ---- phase 6j: the network surface


def test_rpc_phase_catches_no_failure():
    """Phase 6j holds no except clause (its try block only stops its
    servers and the CLI node and removes its directory): a refused tx, a
    wrong DAH, a launch count, a document over HTTP that differs from the
    in-process one, an unverified sample, a light client that accepts the
    proven bad encoding, a failed probe, a readiness or metrics answer, a
    gRPC reply or a CLI answer raises. main runs it after phase 6i."""
    import ast
    import inspect
    import textwrap

    src = inspect.getsource(chip_smoke.rpc_phase)
    tree = ast.parse(textwrap.dedent(src))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    for name in ('"/produce_block"', 'NODE_LAUNCHES["produce_block"]', "CHAIN_DAH_HASH",
                 "NODE_DAH_HASH_3", "p_rpc.broadcast_tx(raw)", "apply_external_block(",
                 "client.dah(2)", "p_rpc.eds(2)", "FraudAwareLightClient(",
                 "sample_availability(2, n=RPC_LC_SAMPLES", "MaliciousApp(",
                 "corrupt_extension=True", "fraud.find_befp(m_eds)", "fraud.verify_befp(",
                 "add_fraud_proof(2", "isinstance(fraud_err, FraudDetected)",
                 "http_crowd(c_url, crowd, RPC_THREADS)", "== direct",
                 'counts["ragged_gather"] == needs.count(True)', "len(needs) == batches",
                 'entry="RpcServer /sample"',
                 "host_crosscheck=True", 'c["crosscheck_ok"] == 1', "RPC_PROBE_CYCLES",
                 '"/readyz"', "begin_drain()", "status == 503", "prometheus_series(",
                 '"rpc_stage_ms_seconds_count"', 'find_spec("grpc")', "GrpcClient(",
                 "chain_send(", '"celestia_tpu_torch.cli"', '"start", "--device"',
                 '"query", "/header/2"', '"light", "--primary"', "signal.SIGINT",
                 'r"^node stopped"', 'phase="rpc"', "sample_http_ms", "sample_inprocess_ms",
                 "produce_block_http_ms", "shutil.rmtree(home", "proc.kill()", "srv.stop()",
                 "transfers._device_executor() == c_srv.dispatcher.run_device",
                 '"dispatch.run"', "funnel_runs == f_counts", "servers.remove(c_srv)",
                 "tx_proof_doc(p_node", "namespace_data_doc(p_node", '"absence" in ns_doc',
                 '"tx", "pfb"', "cli_k >= GPU_MIN_SQUARE", 'site="eds.ragged"'):
        assert name in src, name
    assert src.count("check(") >= 30
    # the crowd runs first, its server the only one: the dispatcher is the
    # process's device executor only then
    assert src.index("http_crowd(c_url") < src.index("servers.remove(c_srv)") < src.index(
        "serve(p_node)")
    main = inspect.getsource(chip_smoke.main)
    assert ("rpc_phase(dev, emit, c_key, c_raws, [bench_square(sk, seed) for seed in "
            "LANE_SEEDS[:4]],") in main
    assert main.index("mesh_phase(") < main.index("rpc_phase(") < main.index("# ---- phase 7")
    assert "6j. The network surface" in chip_smoke.__doc__


def test_rpc_constants():
    assert chip_smoke.RPC_THREADS == chip_smoke.LANE_THREADS == 8
    assert chip_smoke.RPC_LC_SAMPLES == 16 and chip_smoke.RPC_PROBE_CYCLES == 3
    assert chip_smoke.LANE_SEEDS[:4] == (42, 43, 44, 45)  # 6b's four heights
    assert 0 <= chip_smoke.RPC_PROOF_TX < chip_smoke.PROPOSAL_BLOBS
    # the CLI node's PFB needs more shares than a k = 8 square holds
    assert chip_smoke.RPC_CLI_PFB_BYTES // 512 > 8 * 8


def test_prometheus_series_reads_the_ports_export():
    from celestia_tpu_torch.telemetry import Registry

    reg = Registry()
    reg.incr_counter("rpc_shed_total", reason="queue_full")
    reg.set_gauge("process_rss_bytes", 4096.0)
    reg.observe("rpc_stage_ms", 0.002, exemplar="ab" * 16, stage="serialize")
    series = chip_smoke.prometheus_series(reg.prometheus_text())
    assert series["rpc_shed_total"] == [1.0] and series["process_rss_bytes"] == [4096.0]
    assert series["rpc_stage_ms_seconds_count"] == [1.0]
    assert series["rpc_stage_ms_seconds_bucket"][-1] == 1.0
    for bad in ("orphan_total 1", "# TYPE x summary\nx 1", "# TYPE x gauge\nx one"):
        with pytest.raises(SystemExit):
            chip_smoke.prometheus_series(bad)


def test_http_crowd_answers_every_sample_in_order():
    """The crowd over a port server's /sample from several threads: the
    documents of sample_batch_ragged, in the crowd's order."""
    from celestia_tpu_torch import da
    from celestia_tpu_torch.node import Node
    from celestia_tpu_torch.node.rpc import RpcServer

    node = Node(device="cpu")
    for h in (1, 2):
        node._eds_cache.put(h, da.extend_shares(_lane_square(2, h).reshape(-1, 512), "cpu"))
    crowd = chip_smoke.serving_crowd(5, (1, 2), 4, 20)
    srv = RpcServer(node, port=0)
    srv.start()
    try:
        docs = chip_smoke.http_crowd(f"http://127.0.0.1:{srv.port}", crowd, 3)
        status, body = chip_smoke.http_get(f"http://127.0.0.1:{srv.port}", "/sample/9/0/0")
    finally:
        srv.stop()
    assert [s for s, _d in docs] == [200] * 20
    assert [d for _s, d in docs] == node.sample_batch_ragged(crowd)
    assert status == 404 and b"block not found" in body


def test_chain_send_is_checked_like_a_signed_send():
    from celestia_tpu_torch import crypto
    from celestia_tpu_torch.app.app import App

    key = crypto.PrivateKey.from_secret(chip_smoke.CHAIN_KEY_SECRET)
    val = crypto.PrivateKey.from_secret(chip_smoke.APP_VALIDATOR_SECRET).bech32_address()
    app = App(chain_id=chip_smoke.CHAIN_ID, device="cpu")
    chip_smoke.app_genesis(app, key.bech32_address(), val)
    res = app.check_tx(chip_smoke.chain_send(key, val, 0))
    assert res.code == 0, res.log
    assert app.check_tx(chip_smoke.chain_send(key, val, 5)).code != 0  # a future sequence


def test_line_reader_matches_and_gives_up():
    import io

    reader = chip_smoke.LineReader(io.StringIO("node started: rpc http://127.0.0.1:4321 x\n"
                                               "height 1 txs 0\nheight 2 txs 0\n"))
    assert reader.until(r"rpc http://127\.0\.0\.1:(\d+)").group(1) == "4321"
    assert reader.until(r"^height 2 ").group(0) == "height 2 "
    with pytest.raises(SystemExit, match="no line matching"):
        reader.until(r"^node stopped", timeout=5.0)


def test_cli_out_runs_the_ports_cli_in_process(tmp_path):
    code, out = chip_smoke.cli_out(["--home", str(tmp_path), "addrbook", "add", "http://a:1"])
    assert code == 0 and out == "added http://a:1 (1 peers)\n"
    code, _out = chip_smoke.cli_out(["--home", str(tmp_path), "addrbook", "remove", "x"])
    assert code == 1
