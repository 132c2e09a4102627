"""int8_rounding_probe.py's variant of the W8A16 kernel, on the CPU.

The probe builds and times its variant only on a card; here the variant
must still apply to the committed kernel source: the weights enter the
fragments unscaled and both epilogue stores scale the sums.
"""

import int8_rounding_probe as probe


def test_variant_applies_to_the_committed_kernel():
    src = probe.SRC.read_text()
    variant = probe.scaled_in_epilogue(src)
    assert variant != src
    assert probe.KEPT_BUILD not in variant and variant.count(probe.SCALED_BUILD) == 1
    for kept, scaled in zip(probe.KEPT_STORES, probe.SCALED_STORES):
        assert kept not in variant and variant.count(scaled) == 1
