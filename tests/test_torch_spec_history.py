"""The speculation controller's history across requests, in both packages.

A served scheduler keeps one accept controller (``_TreeAutoTuner``) for all
its requests, in the JAX package and in the port: the rate estimate one
request leaves behind decides the next request's rounds. These tests replay
the rounds of two requests for one greedy prompt on one server, an SSE
stream and then its buffered twin, as their flight frames were logged on an
H100 (``chip_smoke.py`` phase 10's distilled GPT-2-small feature head at
300 distillation steps, tree "4,3,2,1", accept floor 0.3, the first pair of
``serve_speculative``; the two replies agreed): the stream began below the
floor and ran plain rounds with periodic depth-1 probes, the buffered twin
began at full depth. Both packages' controllers make the same decision in
every round, so in both packages two requests for the same prompt may run
different programs. Whether that is what once parted a stream from its
buffered reply on the card is not shown: that divergence was not
reproduced.
"""

import pytest

from seldon_core_tpu.models.spec_tree import SpecTree as JaxTree
from seldon_core_tpu.serving.decode_scheduler import _TreeAutoTuner as JaxTuner
from seldon_core_tpu_torch.models.spec_tree import SpecTree
from seldon_core_tpu_torch.serving.decode_scheduler import _TreeAutoTuner

TREE, FLOOR = "4,3,2,1", 0.3

# per round: (effective depth, probe, accepted, proposed); depth 0 is a plain
# round, which observes nothing. The controller's state before each request
# is the flight recorder's spec_state then. A round whose slot has one token
# of budget left runs plain whatever the controller decides, so each
# request's final round is left out (the stream's last round proposed 2 of
# its depth 4 for the same reason).
SSE_BEFORE = {"rate": 0.2595393628714983, "probes": 1, "plain_rounds": 8, "spec_rounds": 0}
SSE_ROUNDS = (
    [(0, False, 0, 0)] * 7 + [(1, True, 0, 1)] + [(0, False, 0, 0)] * 15
    + [(1, True, 1, 1), (1, False, 1, 1), (2, False, 1, 2), (2, False, 2, 2), (2, False, 2, 2), (3, False, 3, 3),
       (3, False, 3, 3), (3, False, 3, 3), (4, False, 3, 4), (3, False, 3, 3), (4, False, 4, 4), (4, False, 2, 2)]
)
BUFFERED_BEFORE = {"rate": 0.9065270778311394, "probes": 3, "plain_rounds": 0, "spec_rounds": 0}
BUFFERED_ROUNDS = (
    [(4, False, 0, 4), (3, False, 0, 3), (2, False, 0, 2), (1, False, 0, 1), (1, False, 0, 1)]
    + [(0, False, 0, 0)] * 15
    + [(1, True, 1, 1), (1, False, 1, 1), (2, False, 2, 2), (2, False, 1, 2), (2, False, 1, 2), (2, False, 1, 2),
       (2, False, 2, 2), (3, False, 3, 3), (3, False, 3, 3), (3, False, 3, 3), (3, False, 3, 3), (4, False, 4, 4),
       (4, False, 4, 4)]
)


def _tuners(state):
    ours = _TreeAutoTuner(FLOOR, 4, SpecTree.from_text(TREE))
    theirs = JaxTuner(FLOOR, 4, JaxTree.from_text(TREE))
    for t in (ours, theirs):
        for k, v in state.items():
            setattr(t, k, v)
    return ours, theirs


def _replay(state, rounds):
    """Each package's decisions over the logged rounds; the one riding slot's
    path is its accepted count under its depth."""
    ours, theirs = _tuners(state)
    decided = []
    for i, (depth, probe, accepted, proposed) in enumerate(rounds):
        mine, ref = ours.decide(), theirs.decide()
        assert mine == ref, f"round {i}: port {mine}, JAX {ref}"
        decided.append((mine[0], mine[2]))
        if mine[0]:
            for t in (ours, theirs):
                t.update(accepted, proposed, paths=[(accepted, mine[0])])
        assert ours.rate == pytest.approx(theirs.rate, abs=0, rel=1e-15)
    return decided


@pytest.mark.parametrize("label,state,rounds", [("sse", SSE_BEFORE, SSE_ROUNDS),
                                               ("buffered", BUFFERED_BEFORE, BUFFERED_ROUNDS)])
def test_both_packages_replay_the_logged_rounds(label, state, rounds):
    """Fed the logged observations from the logged state, both controllers
    decide every round's depth and probe flag as the card's scheduler did."""
    assert _replay(state, rounds) == [(d, p) for d, p, _, _ in rounds], label


def test_the_stream_and_its_buffered_twin_run_different_rounds():
    """The same prompt's first generated tokens: plain rounds (one probe) on
    the stream, full-depth tree rounds on the buffered twin — in both
    packages, since their decisions agree round for round."""
    sse = _replay(SSE_BEFORE, SSE_ROUNDS)
    buffered = _replay(BUFFERED_BEFORE, BUFFERED_ROUNDS)
    assert [d for d, _ in sse[:5]] == [0] * 5
    assert [d for d, _ in buffered[:3]] == [4, 3, 2]
