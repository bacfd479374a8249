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
