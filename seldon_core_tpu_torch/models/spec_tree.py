"""Static token-tree layout for multi-candidate (tree) speculation.

Port of ``seldon_core_tpu/models/spec_tree.py`` (pure numpy; the port keeps
its own copy). A speculation round generalizes from a single k-token chain
to a token TREE (Medusa / EAGLE / SpecInfer style): the draft proposes
``branching[d]`` candidate continuations at each depth ``d`` under every
surviving branch, the flattened tree is scored in ONE widened target
dispatch, and acceptance walks the longest valid PATH. This module owns the
pure-host structure: parsing the ``tpu.decode_spec_tree`` knob (``"4,2,1"``
— per-depth top-b branching), the flattened block layout, the ancestor mask
the widened attention uses as its in-block causal mask, and the child
tables the acceptance walk gathers through.

Block-index convention (shared by every tree program): the widened dispatch
carries ``width = 1 + n_tree`` queries per slot; block 0 is the round's root
(the slot's last emitted token, exactly the chain verify's query 0) and
block ``1 + i`` is flattened tree node ``i``. Nodes are laid out
depth-major, parent-major: depth-1 nodes first (the root's ``branching[0]``
children in branch order), then each depth advances with every depth-(d-1)
node's ``branching[d-1]`` children contiguous. A node at depth ``d`` sits at
position ``pos + d`` (position EMBEDDING — its cache address is only decided
after acceptance, when the chosen path is committed to ``pos+1..pos+n_acc``
and every other node's write is redirected to the junk page).

The dataclass is frozen and hashable on ``branching`` alone: one tree shape
is one (program, shape) dispatch key of the scheduler.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

# Verify-width headroom: the widened target dispatch materializes
# [n_slots, 1 + n_tree, vocab] logits and an O(width^2) in-block ancestor
# mask — past this many flattened nodes the dispatch stops amortizing and
# the config is almost certainly a typo'd branching ("44" for "4,4").
# Validation rejects larger trees at deployment build; the scheduler ctor
# enforces it as a hard error (scheduler_for_executor pre-checks and
# warn-disables).
MAX_TREE_NODES = 64


def parse_spec_tree(text: str, min_branch: int = 1) -> tuple[int, ...]:
    """Parse a ``decode_spec_tree`` knob (``"4,2,1"``) into a per-depth
    branching tuple. Raises ValueError with the validation wording on
    anything malformed — both validation and the scheduler call this, so
    the two layers cannot drift. ``min_branch=0`` relaxes the floor for the
    per-request TIGHTEN string (``meta.tags.spec_tree``), where a 0 width
    is the documented opt-out — the deployment knob itself must describe a
    real tree (every depth >= 1)."""
    parts = [p.strip() for p in str(text).split(",") if p.strip()]
    if not parts:
        raise ValueError("decode_spec_tree must name at least one depth (e.g. '4,2,1')")
    branching = []
    for p in parts:
        try:
            b = int(p)
        except ValueError:
            raise ValueError(
                f"decode_spec_tree entry {p!r} is not an integer (want e.g. '4,2,1')"
            ) from None
        if b < min_branch:
            raise ValueError(
                f"decode_spec_tree branching must be >= {min_branch}, got {b}"
            )
        branching.append(b)
    return tuple(branching)


@dataclass(frozen=True)
class SpecTree:
    """One deployment's speculation tree shape. ``branching[d]`` is the
    number of candidate children every depth-``d`` node proposes (the root
    counts as depth 0). All derived tables are cached numpy."""

    branching: tuple[int, ...]

    @staticmethod
    def from_text(text: str) -> "SpecTree":
        return SpecTree(parse_spec_tree(text))

    @staticmethod
    def chain(k: int) -> "SpecTree":
        """The degenerate tree the chain path is a special case of: ``k``
        depths of branching 1."""
        return SpecTree((1,) * int(k))

    @property
    def depth(self) -> int:
        return len(self.branching)

    @cached_property
    def level_counts(self) -> tuple[int, ...]:
        """Nodes per depth: cumulative branching products."""
        counts, c = [], 1
        for b in self.branching:
            c *= b
            counts.append(c)
        return tuple(counts)

    @property
    def n_tree(self) -> int:
        """Flattened tree node count (blocks 1..n_tree)."""
        return sum(self.level_counts)

    @property
    def width(self) -> int:
        """Widened verify dispatch width: root block + every tree node."""
        return 1 + self.n_tree

    @cached_property
    def level_starts(self) -> tuple[int, ...]:
        """Block index of each depth's first node (depth d -> blocks
        ``level_starts[d-1] .. level_starts[d-1] + level_counts[d-1])``)."""
        starts, s = [], 1
        for c in self.level_counts:
            starts.append(s)
            s += c
        return tuple(starts)

    @cached_property
    def parent_block(self) -> np.ndarray:
        """``parent_block[j]`` for block j: 0 for depth-1 nodes (the root),
        else the parent node's block index; ``parent_block[0]=0``."""
        parent = np.zeros(self.width, np.int32)
        for d in range(2, self.depth + 1):
            start = self.level_starts[d - 1]
            pstart = self.level_starts[d - 2]
            b = self.branching[d - 1]
            for g in range(self.level_counts[d - 1]):
                parent[start + g] = pstart + g // b
        return parent

    @cached_property
    def block_depth(self) -> np.ndarray:
        """Position offset of each block: 0 for the root, else the node's
        tree depth (a depth-d node embeds at ``pos + d``)."""
        depth = np.zeros(self.width, np.int32)
        for d in range(1, self.depth + 1):
            start = self.level_starts[d - 1]
            depth[start : start + self.level_counts[d - 1]] = d
        return depth

    @cached_property
    def ancestor_mask(self) -> np.ndarray:
        """``[width, width]`` bool: ``mask[q, j]`` — may block-query q attend
        to block j's fresh K/V? True iff j is q's ancestor-or-self (the root
        is everyone's ancestor). This is the in-block causal mask of the
        widened dispatch: composed with the strictly-before-``pos`` cache
        mask it makes every tree query see exactly its own path's context,
        and reduces to the lower-triangular chain mask on a branching-1
        tree."""
        m = np.zeros((self.width, self.width), bool)
        parent = self.parent_block
        for q in range(self.width):
            j = q
            m[q, j] = True
            while j != 0:
                j = int(parent[j])
                m[q, j] = True
        return m

    @cached_property
    def child_table(self) -> np.ndarray:
        """``[width, max_branching]`` int32: block j's children's block
        indices in branch order, padded with 0 (never read past a depth's
        true branching — the acceptance walk slices ``[:branching[d]]`` per
        depth)."""
        table = np.zeros((self.width, max(self.branching)), np.int32)
        nxt = {j: 0 for j in range(self.width)}
        parent = self.parent_block
        for j in range(1, self.width):
            p = int(parent[j])
            table[p, nxt[p]] = j
            nxt[p] += 1
        return table

    def nodes_for_widths(self, widths) -> int:
        """Flattened node count of the SUB-TREE a per-depth width mask
        induces (``sum_d prod_{e<=d} min(widths[e], branching[e])``; a 0
        width truncates the depths below it) — the effective tree the
        acceptance walk can actually traverse. The verify dispatch still
        scores the full static layout (widths are data, not shape)."""
        total, level = 0, 1
        for d, b in enumerate(self.branching):
            w = min(int(widths[d]), b) if d < len(widths) else 0
            if w <= 0:
                break
            level *= w
            total += level
        return total

    def tighten(self, widths) -> tuple[int, ...]:
        """Element-wise clamp of a per-request branching request against
        this (deployment) tree: per depth ``min(req, deployment)``, depths
        the request omits get width 0 (= depth tightening). Tighten-only:
        a request can narrow or shorten the tree, never widen it."""
        widths = tuple(int(w) for w in widths)
        return tuple(
            min(max(widths[d], 0), self.branching[d]) if d < len(widths) else 0
            for d in range(self.depth)
        )
