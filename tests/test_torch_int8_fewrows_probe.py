"""int8_fewrows_probe.py's source variants, on the CPU: the probe builds
and runs them only on a card, but each must still apply to the committed
kernel source and change only the constant it names."""

import difflib

import pytest

import int8_fewrows_probe as probe


@pytest.mark.parametrize("name, old, new", [
    ("rows128", probe.MAX_ROWS, "constexpr int FR_MAX_ROWS = 128;"),
    ("ch64", probe.JB, "constexpr int FR_JB = 4;"),
    ("steps1", probe.STEPS, "constexpr int FR_WARP_STEPS = 1;"),
])
def test_each_variant_changes_one_constant_of_the_committed_kernel(name, old, new):
    src = probe.SRC.read_text()
    variants = probe.variants(src)
    assert variants["committed"] == src and len(set(variants.values())) == len(variants) == 4
    changed = [line for line in difflib.ndiff(src.splitlines(), variants[name].splitlines())
               if line[:2] in ("- ", "+ ")]
    assert len(changed) == 2 and old in changed[0] and changed[1] == "+ " + changed[0][2:].replace(old, new)


@pytest.mark.parametrize("marker", ["MAX_ROWS", "JB", "STEPS"])
def test_a_variant_that_no_longer_applies_is_refused(marker):
    with pytest.raises(ValueError, match="one occurrence"):
        probe.variants(probe.SRC.read_text().replace(getattr(probe, marker), ""))
