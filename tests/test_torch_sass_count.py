"""tools/sass_count.py on listings written out here (cuobjdump's format):
loops are found from backward branches, the innermost loops holding the
marker are counted, NOPs are left out, and a loop nested in a marker loop
without a marker of its own does not hide it."""
import pytest

from ai_path_tracer_denoiser_tpu_torch.tools import sass_count

HEADER = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_111pair_kernelEv
\t.headerflags\t@"EF_CUDA_SM90"
"""


def listing(lines):
    """cuobjdump-style lines from (address, instruction) pairs."""
    out = [HEADER]
    for addr, text in lines:
        out.append(f"        /*{addr:04x}*/                   {text} ;"
                   f"                 /* 0x000fe20000000800 */")
        out.append("                                                  /* 0x000fc80000000000 */")
    return "\n".join(out)


FACE_LOOP = [
    (0x00, "S2R R0, SR_TID.X"),
    (0x10, "LDS.128 R4, [R2]"),            # loop head
    (0x20, "FMUL R8, R4, R5"),
    (0x30, "MUFU.RCP R9, R8"),
    (0x40, "FFMA R10, R9, R8, -1"),
    (0x50, "NOP"),
    (0x60, "MUFU.RCP R11, R10"),
    (0x70, "@P0 BRA 0x10"),                # back to the head: 6 instructions, 2 tests
    (0x80, "EXIT"),
    (0x90, "BRA 0x90"),                    # the trailing self-loop
]


def test_face_loop_counts_instructions_per_reciprocal():
    funcs = sass_count.parse(listing(FACE_LOOP))
    (name, insns), = funcs.items()
    assert name.endswith("pair_kernelEv") and len(insns) == len(FACE_LOOP)
    (loop,) = sass_count.count_loops(insns, "face")
    assert loop["first_address"] == 0x10
    assert (loop["instructions"], loop["tests"]) == (6, 2)
    assert loop["instructions_per_test"] == 3
    assert loop["by_opcode"]["MUFU"] == 2 and "NOP" not in loop["by_opcode"]


def test_slab_loops_are_the_innermost_with_the_marker():
    lines = [(0x00, "MOV R1, c[0x0][0x28]")]
    # outer chunk loop 0x10-0xd0 holds a word loop 0x20-0xb0 (12 FMUL = 2
    # slab tests) that holds a peel loop 0x80-0x90 without FMUL
    lines += [(0x10, "SYNCS.ARRIVE.TRANS64 RZ, [UR4], RZ")]
    lines += [(0x20 + 0x10 * k, "FMUL R2, R3, R4") for k in range(6)]   # 0x20-0x70
    lines += [(0x80, "POPC R5, R6"), (0x90, "@P1 BRA 0x80")]
    lines += [(0xa0 + 0x10 * k, "FMUL R2, R3, R4") for k in range(6)]   # 0xa0-0xf0
    lines += [(0x100, "@P2 BRA 0x20"), (0x110, "@P3 BRA 0x10"), (0x120, "EXIT")]
    insns = sass_count.parse(listing(lines))["_ZN12_GLOBAL__N_111pair_kernelEv"]
    (loop,) = sass_count.count_loops(insns, "slab")
    assert loop["first_address"] == 0x20
    assert (loop["instructions"], loop["tests"]) == (15, 2)
    assert loop["instructions_per_test"] == 7.5


@pytest.mark.parametrize("text,op", [("@!P0 BRA 0x10", "BRA"), ("FMUL R1, R2, R3", "FMUL"),
                                     ("@P4 MUFU.RCP R1, R2", "MUFU.RCP")])
def test_opcode_drops_the_predicate(text, op):
    assert sass_count.opcode(text) == op


def test_labelled_branches_are_followed():
    text = HEADER + """
        /*0000*/                   MOV R1, R2 ;
.L_x_3:
        /*0010*/                   MUFU.RCP R3, R4 ;
        /*0020*/                   FADD R5, R3, R3 ;
        /*0030*/              @P0 BRA `(.L_x_3) ;
        /*0040*/                   EXIT ;
"""
    insns = sass_count.parse(text)["_ZN12_GLOBAL__N_111pair_kernelEv"]
    (loop,) = sass_count.count_loops(insns, "face")
    assert (loop["first_address"], loop["instructions"], loop["tests"]) == (0x10, 3, 1)


def test_geom_loops_count_one_test_per_body_of_a_shared_memory_loop():
    """``geom``: the innermost loops that read shared memory, one geom test
    per pass; a loop without LDS (ray generation) is not counted."""
    lines = [(0x00, "S2R R0, SR_TID.X")]
    lines += [(0x10, "LDS.128 R4, [R2]"), (0x20, "FMUL R8, R4, R5"), (0x30, "MUFU.RSQ R9, R8"),
              (0x40, "LDS R10, [R2+0x10]"), (0x50, "NOP"), (0x60, "@P0 BRA 0x10")]
    lines += [(0x70, "MUFU.RSQ R1, R2"), (0x80, "FADD R3, R1, R1"), (0x90, "@P1 BRA 0x70")]
    lines += [(0xa0, "@P2 BRA 0x10"), (0xb0, "EXIT")]
    insns = sass_count.parse(listing(lines))["_ZN12_GLOBAL__N_111pair_kernelEv"]
    (loop,) = sass_count.count_loops(insns, "geom")
    assert (loop["first_address"], loop["instructions"], loop["tests"]) == (0x10, 5, 1.0)
    assert loop["by_opcode"]["LDS"] == 2


def test_resource_usage_reads_registers_per_function():
    text = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_113render_kernelENS_4ArgsE:
  REG:90 STACK:8 SHARED:0 LOCAL:0 CONSTANT[0]:664 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z5otherv:
  REG:32 STACK:0 SHARED:1024 LOCAL:4 CONSTANT[0]:352 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    usage = sass_count.parse_resource_usage(text)
    assert usage == {"_ZN12_GLOBAL__N_113render_kernelENS_4ArgsE":
                     {"REG": 90, "STACK": 8, "SHARED": 0, "LOCAL": 0},
                     "_Z5otherv": {"REG": 32, "STACK": 0, "SHARED": 1024, "LOCAL": 4}}
