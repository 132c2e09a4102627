"""flash_q_probe.py's source variants and SASS reading, on the CPU.

The probe builds and runs its variants only on a card; here its variants
must still apply to the committed kernel source, and its reading of a SASS
listing must find a loop-carried A fragment that the loop overwrites
without a reload, and nothing where the loop reloads it.
"""

import pytest

import flash_q_probe as probe

FN = "_ZN12_GLOBAL__N_115flash_fwd_wgmmaI13__nv_bfloat16Li128ELi1EEEv14CUtensorMap_st"


def _listing(rows):
    body = "\n".join(f"        /*{addr:04x}*/                   {text} ;  /* 0x0 */" for addr, text in rows)
    return f"\n\tcode for sm_90a\n        Function : {FN}\n{body}\n"


def _tile_loop(reload_at_top: bool):
    rows = [(0x10, "LDS.128 R152, [R1]")]
    if reload_at_top:
        rows.append((0x30, "LDS.128 R152, [R2]"))
    rows += [
        (0x40, "WARPGROUP.ARRIVE"),
        (0x50, "HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR4], R24"),
        (0x60, "F2FP.BF16.F32.PACK_AB R152, R24, R25"),
        (0x70, "@P0 F2FP.BF16.F32.PACK_AB R155, R26, R27"),
        (0x80, "HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR4].tnspB, R88"),
        (0x90, "@P1 BRA 0x30"),
    ]
    return _listing(rows)


def test_variants_apply_to_the_committed_kernel():
    src = probe.SRC.read_text()
    variants = probe.variants(src)
    assert variants["reread"] == src
    assert len(set(variants.values())) == len(variants) == 5
    assert "qa[kk][r] = Pack<T>::pack(f.x * scale, f.y * scale);" in variants["held"]
    assert "wgmma_rs<T, BK, 0>(sc, qc[kk]" in variants["held_xor"]


@pytest.mark.parametrize("reload_at_top, clobbered", [(False, 2), (True, 0)])
def test_clobbered_q_registers(reload_at_top, clobbered):
    (rows,) = probe.sass_functions(_tile_loop(reload_at_top)).values()
    assert probe.clobbered_q_registers(rows) == clobbered


def test_clobbered_q_registers_needs_a_tile_loop():
    rows = [(0x10, "HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR4], R24"),
            (0x20, "HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR4].tnspB, R88")]
    (parsed,) = probe.sass_functions(_listing(rows)).values()
    assert probe.clobbered_q_registers(parsed) is None


@pytest.mark.parametrize("text, regs", [
    ("LDS.128 R152, [R1]", {152, 153, 154, 155}),
    ("LDL.64 R8, [R1+0x10]", {8, 9}),
    ("IMAD.WIDE.U32 R4, R2, R3, RZ", {4, 5}),
    ("F2FP.BF16.F32.PACK_AB R160, R1, R2", {160}),
    ("STS [R1], R152", set()),
    ("HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR4], R24", set()),
])
def test_registers_written(text, regs):
    (rows,) = probe.sass_functions(_listing([(0x10, text)])).values()
    ((_, op, operands),) = rows
    assert probe._written(op, operands) == regs


def test_ptxas_report_keys_each_bf16_body():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{FN}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    88 bytes stack frame, 132 bytes spill stores, 136 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_Z13flash_fwd_f32ILi64EEv' for 'sm_90a'",
        "ptxas info    : Used 56 registers",
    ])
    assert probe.ptxas_report(log) == {
        ("128", "1"): "88 bytes stack frame, 132 bytes spill stores, 136 bytes spill loads "
                      "Used 168 registers, used 16 barriers"}


F32 = "_ZN51_GLOBAL__N__0dbd0e32_18_flash_attention_cu_2c13897913flash_fwd_f32ILi64ELi8EEEvPKfS2_S2_PfNS_7StridesEiiifi"


def test_ptxas_report_keys_each_f32_body():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{FN}' for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{F32}' for 'sm_90a'",
        f"ptxas info    : Function properties for {F32}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 159 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{F32.replace('Li64ELi8E', 'Li128ELi4E')}' for 'sm_90a'",
        "    112 bytes stack frame, 136 bytes spill stores, 144 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
    ])
    assert probe.ptxas_report_f32(log) == {
        ("64", "8"): "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads Used 159 registers, used 1 barriers",
        ("128", "4"): "112 bytes stack frame, 136 bytes spill stores, 144 bytes spill loads "
                      "Used 255 registers, used 1 barriers"}
    assert list(probe.ptxas_report(log)) == [("128", "1")]
