"""sass_bound.py, the tick kernel's operation bound from its SASS, on a
listing written in cuobjdump's format (the card's toolkit disassembles
the real library; a host without the CUDA toolkit cannot).

The substep loop is the backward branch of widest span; the counted path
is the shortest one from its head through its first shared-memory load
to its back branch, so a branch around the rule lookup (a kind without
rules) is not taken, while a branch around a re-arm is.
"""

from __future__ import annotations

import pytest

import sass_bound

LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_117fused_tick_kernelENS_12DispatchArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R2, 0x1, PT ;
        /*0020*/               @P0 BRA 0x40 ;
        /*0030*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0040*/                   FADD R4, R4, R5 ;
        /*0050*/              @!P2 BRA 0xa0 ;
        /*0060*/                   LDS R6, [R7] ;
        /*0070*/                   LOP3.LUT R8, R6, R9, RZ, 0xc0, !PT ;
        /*0080*/              @!P3 BRA 0xa0 ;
        /*0090*/                   MUFU.LG2 R10, R10 ;
        /*00a0*/                   IMAD R11, R11, 0x3, RZ ;
        /*00b0*/              @!P1 BRA 0x40 ;
        /*00c0*/                   BRA 0x20 ;
        /*00d0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_111tick_kernelEiiiffj
        /*0000*/                   FADD R4, R4, R5 ;
        /*0010*/                   LDS R6, [R7] ;
        /*0020*/                   FSETP.GE.AND P0, PT, R4, R6, PT ;
        /*0030*/              @!P0 BRA 0x0 ;
        /*0040*/                   EXIT ;
"""


def test_substep_path_takes_the_rule_lookup_and_skips_what_it_can():
    got = sass_bound.substep_counts(LISTING)
    fused = got["fused_tick_kernel"]
    # back branches 0xb0 -> 0x40 and 0xc0 -> 0x20: the wider is the loop
    assert fused["loop"] == ["0x20", "0xc0"]
    # 0x20 (taken to 0x40), FADD, the branch around the lookup not taken,
    # LDS, LOP3, the branch around MUFU taken, IMAD, the inner back branch
    # not taken, the loop's back branch: 9 issued
    assert fused["path"] == {"issue": 9, "fp32": 1, "int32": 2, "mufu": 0}
    per_kind = got["tick_kernel"]
    assert per_kind["loop"] == ["0x0", "0x30"]
    assert per_kind["path"] == {"issue": 4, "fp32": 2, "int32": 0, "mufu": 0}


def test_bound_is_the_slowest_unit():
    kernel = {"path": {"issue": 64, "fp32": 0, "int32": 64, "mufu": 0}}
    ms, unit = sass_bound.bound_ms(kernel, rows=132 * 1000, steps=2)
    # int32 at half the issue rate: 64 ops x 132,000 rows x 2 / (64 x 132 x 1.98e9)
    assert unit == "int32"
    assert ms == pytest.approx(64 * 132_000 * 2 / (64 * 132 * 1.98e9) * 1e3)


def test_a_listing_without_the_kernel_is_refused():
    with pytest.raises(ValueError, match="fused_tick_kernel"):
        sass_bound.substep_counts(LISTING.split("\t\tFunction : _ZN12_GLOBAL__N_111")[0]
                                  .replace("117fused_tick_kernel", "117other_kernel"))
