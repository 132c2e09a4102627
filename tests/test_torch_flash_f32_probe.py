"""flash_f32_probe.py's source variants, on the CPU: the probe builds and
runs them only on a card, but each must still apply to the committed
float32 body, and each must change what it says it changes."""

import flash_f32_probe as probe


def test_variants_apply_to_the_committed_kernel():
    src = probe.SRC.read_text()
    variants = probe.variants(src)
    assert variants["committed"] == src
    assert len(set(variants.values())) == len(variants) == 3
    assert probe.S_FRESH not in variants["s_chained"] and probe.O_FRESH in variants["s_chained"]
    assert probe.S_FRESH not in variants["s_o_chained"] and probe.O_FRESH not in variants["s_o_chained"]
    assert probe.O_ADD not in variants["s_o_chained"]


def test_a_variant_that_no_longer_applies_is_refused():
    import pytest

    with pytest.raises(ValueError, match="one occurrence"):
        probe.variants(probe.SRC.read_text().replace(probe.S_FRESH, ""))
