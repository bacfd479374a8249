"""The SASS and ptxas readers of chip_smoke.py, on text in the format that
``cuobjdump -sass`` and ``nvcc -Xptxas -v`` print. Every SHA bound in the
on-card run rests on ``block_loop_mix`` and ``sha_block_ops``: one pass of
K3's block loop, split by pipe."""

import collections
import importlib.util
import pathlib

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
    return src[src.index("    # ---- phase 6d"):src.index("    # ---- phase 7: timing")]


def test_kernel_sources_name_every_kernel_of_the_port():
    """The ``kernels`` line lists all eleven kernels: every wrapper's launch
    count, its source in the repo and the line of the JAX code it replaces."""
    from celestia_tpu_torch.ops import _cuda

    assert list(chip_smoke.KERNEL_SOURCES) == list(_cuda.LAUNCHES)
    assert len(chip_smoke.KERNEL_SOURCES) == 11
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
