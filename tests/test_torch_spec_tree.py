"""The port's speculation tree layout (seldon_core_tpu_torch/models/spec_tree.py)
against the JAX package's (seldon_core_tpu/models/spec_tree.py): the same
parse results and errors, and equal layout arrays for every tree shape the
deployments and the scheduler use."""

import numpy as np
import pytest

from seldon_core_tpu.models import spec_tree as jst
from seldon_core_tpu_torch.models import spec_tree as tst

TREES = ["4,2,1", "2,2,1,1", "1,1,1,1", "2", "3,1,2"]
ARRAYS = ("parent_block", "block_depth", "ancestor_mask", "child_table")
SCALARS = ("branching", "depth", "level_counts", "n_tree", "width", "level_starts")


def _assert_same_tree(ours, theirs):
    for name in SCALARS:
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("text", TREES)
def test_layout_matches_jax(text):
    _assert_same_tree(tst.SpecTree.from_text(text), jst.SpecTree.from_text(text))


@pytest.mark.parametrize("k", [1, 4])
def test_chain_matches_jax_and_is_lower_triangular(k):
    ours = tst.SpecTree.chain(k)
    _assert_same_tree(ours, jst.SpecTree.chain(k))
    np.testing.assert_array_equal(ours.ancestor_mask, np.tril(np.ones((k + 1, k + 1), bool)))
    assert ours == tst.SpecTree.from_text(",".join(["1"] * k))  # hashable on branching alone
    assert hash(ours) == hash(tst.SpecTree((1,) * k))


@pytest.mark.parametrize("text,min_branch", [
    ("", 1), ("4,x", 1), ("4,0", 1), ("-1", 0), (" , ", 1), ("2.5", 1),
    ("4, 2,1", 1), ("2,0,5", 0), ("0", 0),
])
def test_parse_matches_jax_including_errors(text, min_branch):
    try:
        want = jst.parse_spec_tree(text, min_branch=min_branch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tst.parse_spec_tree(text, min_branch=min_branch)
        assert str(got.value) == str(e)
    else:
        assert tst.parse_spec_tree(text, min_branch=min_branch) == want


@pytest.mark.parametrize("widths", [(2, 1, 1), (9, 9, 9), (2,), (0,), (1, 0, 5), ()])
def test_tighten_and_nodes_for_widths_match_jax(widths):
    ours, theirs = tst.SpecTree.from_text("4,2,1"), jst.SpecTree.from_text("4,2,1")
    assert ours.tighten(widths) == theirs.tighten(widths)
    assert ours.nodes_for_widths(widths) == theirs.nodes_for_widths(widths)


def test_node_cap_matches_jax():
    assert tst.MAX_TREE_NODES == jst.MAX_TREE_NODES
    assert tst.SpecTree.from_text("9,9").n_tree > tst.MAX_TREE_NODES  # 90 nodes
