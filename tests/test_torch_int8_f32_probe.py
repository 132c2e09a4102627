"""int8_f32_probe.py's source variants, on the CPU: the probe builds and
runs them only on a card, but each must still apply to the committed
kernel source and change only what it says it changes."""

import pytest

import int8_f32_probe as probe


def test_variants_apply_to_the_committed_kernel():
    src = probe.SRC.read_text()
    variants = probe.variants(src)
    assert variants["committed"] == src
    assert len(set(variants.values())) == len(variants) == 4
    before = variants["split_before"]
    assert probe.AHEAD_SPLIT not in before and probe.AHEAD_HANDOVER not in before
    assert probe.BEFORE_PROLOGUE in before
    mma = variants["mma_sync"]
    assert mma.count("cudaError_t launch_tf32x2(") == 1 and "launch_tf32x2_mma_tile<64>" in mma
    assert "tf32x2_mma_body<BM><<<" in mma and "tf32x2_body<<<" not in mma
    assert probe.SPLITK_CH_16 in variants["splitk_16byte"] and probe.SPLITK_CH not in variants["splitk_16byte"]


@pytest.mark.parametrize("marker", ["AHEAD_SPLIT", "HOST_MARK", "LAUNCH_START", "SPLITK_CHUNKS"])
def test_a_variant_that_no_longer_applies_is_refused(marker):
    with pytest.raises(ValueError, match="one occurrence"):
        probe.variants(probe.SRC.read_text().replace(getattr(probe, marker), ""))
