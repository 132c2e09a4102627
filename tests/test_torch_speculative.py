"""The port's speculation functions (seldon_core_tpu_torch/models/decoder.py)
against the JAX package's on the same parameters and inputs, float32 on the
CPU.

Logits and K/V agree within TOL (rtol 1e-4 / atol 1e-5, the bound of
tests/test_torch_decoder.py); greedy tokens, accept counts and accepted
paths are equal. The sampled acceptance rules draw from torch generators,
not jax.random, so they are held to the target distribution itself: the
first emitted token's empirical marginal over many independent rows must be
the target's softmax, whatever the draft proposes (mirroring
tests/test_spec_tree.py::test_accept_tree_sampled_marginal_preserved).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_core_tpu.models import decoder as jd
from seldon_core_tpu.models import spec_tree as jst
from seldon_core_tpu_torch.models import decoder as td
from seldon_core_tpu_torch.models import spec_tree as tst
from seldon_core_tpu_torch.models.convert import params_to_torch

TOL = dict(rtol=1e-4, atol=1e-5)
# total variation between the first emitted token's empirical marginal over
# 4096 rows and the target's distribution (8 tokens): sampling noise gives
# 0.017-0.020 here, while the draft's distribution lies 0.41 from it
TV_LIMIT = 0.04
CPU = torch.device("cpu")
TINY = dict(vocab=128, hidden=64, layers=2, ffn=128, max_len=64, resid_scale=0.1)
SEQ, K = 8, 3


def _pair(seed=3, **kw):
    p = jd.init_decoder(seed=seed, **{**TINY, **kw})
    return p, params_to_torch(p, CPU)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(n, seq=SEQ, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab"], (n, seq)).astype(np.int32)


def _slot_caches(jp, tp, ids, n, ctx):
    """Both packages' slot caches [L, n, h, ctx, hd] with ids[i] prefilled
    into slot i (slot n-1 left free when ids has fewer rows)."""
    jck, jcv = jd.init_slot_cache(jp, n, ctx)
    tck, tcv = td.init_slot_cache(tp, n, ctx)
    for i, row in enumerate(ids):
        _, jk, jv = jax.jit(jd.prefill)(jp, jnp.asarray(row[None]))
        jck, jcv = jd.write_prefill(jck, jcv, jk, jv, i)
        with torch.inference_mode():
            _, tk, tv = td.prefill(tp, _t(row[None]))
            td.write_prefill(tck, tcv, tk, tv, i)
    return (jck, jcv), (tck, tcv)


def _paged_pools(jp, tp, ids, kv_dtype, ps=4, ctx=SEQ + 12):
    """Both packages' pools with ids[i] prefilled into slot i + 1 (slot 0
    free, its block table all zero), and the block tables."""
    n = len(ids) + 1
    pps = -(-ctx // ps)
    bt = np.zeros((n, pps), np.int32)
    for i in range(1, n):
        bt[i] = np.arange(1 + (i - 1) * pps, 1 + i * pps)
    toks = np.zeros((n, SEQ), np.int32)
    toks[1:] = ids
    counts = np.full(n, SEQ, np.int32)
    counts[0] = 0
    zero = np.zeros(n, np.int32)
    jpool = jd.paged_kv_init(jp, 1 + (n - 1) * pps, ps, kv_dtype=kv_dtype)
    _, _, jpool = jax.jit(jd.paged_chunk_prefill)(jp, jpool, *(jnp.asarray(a) for a in (bt, toks, zero, counts)))
    with torch.inference_mode():
        tpool = td.paged_kv_init(tp, 1 + (n - 1) * pps, ps, kv_dtype=kv_dtype)
        td.paged_chunk_prefill(tp, tpool, *(_t(a) for a in (bt, toks, zero, counts)))
    return jpool, tpool, bt


def _assert_pools_close(tpool, jpool):
    for a, b in zip(tpool, jpool):
        a, b = _np(a)[:, 1:], np.asarray(b)[:, 1:]  # page 0 holds junk in both
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            assert (a != b).mean() < 0.01
        else:
            np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------- chain


def test_verify_step_matches_jax_and_sequential_steps():
    """The widened slot verify: logits and both caches equal the JAX
    package's, and logits[:, j] equal j+1 sequential port decode steps."""
    jp, tp = _pair()
    n, ctx = 3, SEQ + 12
    (jck, jcv), (tck, tcv) = _slot_caches(jp, tp, _ids(2, seed=4), n, ctx)
    queries = np.random.default_rng(5).integers(0, TINY["vocab"], (n, K + 1)).astype(np.int32)
    pos = np.array([SEQ, SEQ, 0], np.int32)
    seq_k, seq_v = tck.clone(), tcv.clone()
    jl, jck, jcv = jax.jit(jd.verify_step)(jp, jck, jcv, jnp.asarray(queries), jnp.asarray(pos))
    with torch.inference_mode():
        tl, _, _ = td.verify_step(tp, tck, tcv, _t(queries), _t(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        np.testing.assert_allclose(_np(tck), np.asarray(jck), **TOL)
        np.testing.assert_allclose(_np(tcv), np.asarray(jcv), **TOL)
        for j in range(K + 1):
            sl, _, _ = td.decode_step(tp, seq_k, seq_v, _t(queries[:, j]), _t(pos + j))
            np.testing.assert_allclose(_np(sl[:2]), _np(tl[:2, j]), **TOL)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_verify_step_matches_jax_and_sequential_steps(kv_dtype):
    jp, tp = _pair()
    jpool, tpool, bt = _paged_pools(jp, tp, _ids(2, seed=6), kv_dtype)
    n = bt.shape[0]
    queries = np.random.default_rng(7).integers(0, TINY["vocab"], (n, K + 1)).astype(np.int32)
    pos = np.array([0, SEQ, SEQ], np.int32)
    seq_pool = tuple(a.clone() for a in tpool)
    jl, _, jpool = jax.jit(jd.paged_verify_step)(jp, jpool, jnp.asarray(bt), jnp.asarray(queries), jnp.asarray(pos))
    with torch.inference_mode():
        tl, th, _ = td.paged_verify_step(tp, tpool, _t(bt), _t(queries), _t(pos))
        assert th.shape == (n, K + 1, TINY["hidden"])
        np.testing.assert_allclose(_np(tl[1:]), np.asarray(jl[1:]), **TOL)
        _assert_pools_close(tpool, jpool)
        for j in range(K + 1):
            sl, _, _ = td.paged_decode_step(tp, seq_pool, _t(bt), _t(queries[:, j]), _t(pos + j))
            np.testing.assert_allclose(_np(sl[1:]), _np(tl[1:, j]), **TOL)


def test_draft_propose_greedy_matches_jax():
    """k greedy draft steps plus the cache-fill step at pos + k: the
    proposals are equal, logits and caches within TOL."""
    jp, tp = _pair(layers=1)
    n, ctx = 3, SEQ + 12
    (jck, jcv), (tck, tcv) = _slot_caches(jp, tp, _ids(3, seed=8), n, ctx)
    toks = np.array([3, 50, 7], np.int32)
    pos = np.array([SEQ, SEQ, SEQ - 2], np.int32)
    zf, zi = np.zeros(n, np.float32), np.zeros(n, np.int32)
    prop = jax.jit(jd.draft_propose, static_argnums=8)
    jt, jl, jck, jcv = prop(jp, jck, jcv, *(jnp.asarray(a) for a in (toks, pos, zf, zi)), jax.random.key(0), K)
    with torch.inference_mode():
        tt, tl, _, _ = td.draft_propose(tp, tck, tcv, *(_t(a) for a in (toks, pos, zf, zi)), None, K)
    assert tt.dtype == torch.int32 and tt.shape == (n, K)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(tck), np.asarray(jck), **TOL)
    np.testing.assert_allclose(_np(tcv), np.asarray(jcv), **TOL)


def _accept_inputs(seed, n, k, vocab=16):
    """Random target/draft logits and proposals, most proposals forced onto
    the target's argmax so that acceptances of every length happen."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((n, k + 1, vocab)).astype(np.float32)
    draft = rng.standard_normal((n, k, vocab)).astype(np.float32)
    drafts = np.argmax(target[:, :k], axis=-1).astype(np.int32)
    flip = rng.random((n, k)) < 0.3
    drafts = np.where(flip, (drafts + 1 + rng.integers(0, vocab - 1, (n, k))) % vocab, drafts).astype(np.int32)
    limits = rng.integers(0, k + 1, n).astype(np.int32)
    return target, draft, drafts, limits


def test_speculative_accept_greedy_equals_jax():
    n, k = 64, 4
    target, draft, drafts, limits = _accept_inputs(0, n, k)
    zf, zi = np.zeros(n, np.float32), np.zeros(n, np.int32)
    jo, ja = jd.speculative_accept(*(jnp.asarray(a) for a in (target, drafts, draft, limits, zf, zi)),
                                   jax.random.key(0))
    to, ta = td.speculative_accept(*(_t(a) for a in (target, drafts, draft, limits, zf, zi)), None)
    assert to.dtype == torch.int32 and ta.dtype == torch.int32
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    for i in range(n):  # only out[:n_acc + 1] is emitted
        np.testing.assert_array_equal(_np(to)[i, : ja[i] + 1], np.asarray(jo)[i, : ja[i] + 1])
    assert 0 < _np(ta).mean() < k and (_np(ta) <= limits).all()
    # top_k = 1 at any temperature samples the argmax: the sampled rule
    # through one-hot distributions gives the greedy answer
    hot, one = np.full(n, 3.0, np.float32), np.ones(n, np.int32)
    so, sa = td.speculative_accept(*(_t(a) for a in (target, drafts, draft, limits, hot, one)),
                                   td.sampling_generator(0, 1, "cpu", td.STREAM_VERIFY))
    np.testing.assert_array_equal(_np(sa), _np(ta))
    for i in range(n):
        np.testing.assert_array_equal(_np(so)[i, : ja[i] + 1], _np(to)[i, : ja[i] + 1])


def test_speculative_accept_sampled_marginal_is_the_target():
    """temperature 1: draft tokens drawn from q, the first emitted token's
    empirical marginal over 4096 rows equals p (accept plus residual
    resample is a perfect sampler of p), and a limit-0 row samples p too."""
    n, vocab, k = 4096, 8, 2
    rng = np.random.default_rng(7)
    p_logits = rng.normal(size=vocab).astype(np.float32) * 1.5
    q_logits = rng.normal(size=vocab).astype(np.float32) * 1.5
    q = np.exp(q_logits) / np.exp(q_logits).sum()
    p = np.exp(p_logits) / np.exp(p_logits).sum()
    target = np.tile(p_logits, (n, k + 1, 1))
    draft = np.tile(q_logits, (n, k, 1))
    drafts = rng.choice(vocab, size=(n, k), p=q).astype(np.int32)
    for limit in (k, 0):
        out, acc = td.speculative_accept(
            *(_t(a) for a in (target, drafts, draft, np.full(n, limit, np.int32), np.ones(n, np.float32),
                              np.zeros(n, np.int32))),
            td.sampling_generator(3, limit, "cpu", td.STREAM_VERIFY),
        )
        emp = np.bincount(_np(out)[:, 0], minlength=vocab) / n
        np.testing.assert_allclose(emp, p, atol=0.04)  # 4 sigma at n=4096 is ~0.031
        assert 0.5 * np.abs(emp - p).sum() < TV_LIMIT  # total variation
        assert (_np(acc).sum() > 0) == (limit > 0)


# ----------------------------------------------------------------- tree


def _jtree(text):
    return jst.SpecTree.from_text(text), tst.SpecTree.from_text(text)


def test_accept_tree_greedy_sibling_catch_unit():
    """One-hot logits on a '2,1' tree: the target's argmax at the root is
    the SECOND depth-1 candidate, which the walk takes; width 0 at depth 2
    ends row 1's walk as a limit clamp with the target's own bonus."""
    _, tree = _jtree("2,1")
    n, vocab = 2, 16
    block_tokens = np.tile(np.array([5, 7, 9, 11, 13], np.int32), (n, 1))

    def one_hot(tokens):
        lg = np.full((n, tree.width, vocab), -10.0, np.float32)
        for j, t in enumerate(tokens):
            lg[:, j, t] = 10.0
        return lg

    target = draft = one_hot([9, 1, 13, 2, 3])
    wl = np.array([[2, 1], [2, 0]], np.int32)
    out, n_acc, path = td.speculative_accept_tree(
        *(_t(a) for a in (target, block_tokens, draft, wl, np.zeros(n, np.float32), np.zeros(n, np.int32))),
        None, tree,
    )
    out, n_acc, path = _np(out), _np(n_acc), _np(path)
    assert n_acc.tolist() == [2, 1]
    np.testing.assert_array_equal(path[0], [0, 2, 4])
    np.testing.assert_array_equal(out[0], [9, 13, 3])
    assert out[1][:2].tolist() == [9, 13]


@pytest.mark.parametrize("text", ["2,2,1", "1,1,1,1", "3"])
def test_speculative_accept_tree_greedy_equals_jax(text):
    jtree, tree = _jtree(text)
    n, vocab = 64, 16
    rng = np.random.default_rng(11)
    target = rng.standard_normal((n, tree.width, vocab)).astype(np.float32)
    draft = rng.standard_normal((n, tree.width, vocab)).astype(np.float32)
    # node tokens: each node is its parent's target argmax half the time
    block = rng.integers(0, vocab, (n, tree.width)).astype(np.int32)
    for j in range(1, tree.width):
        hit = rng.random(n) < 0.5
        block[:, j] = np.where(hit, np.argmax(target[:, tree.parent_block[j]], -1), block[:, j])
    wl = np.stack([rng.integers(0, b + 1, n) for b in tree.branching], axis=1).astype(np.int32)
    zf, zi = np.zeros(n, np.float32), np.zeros(n, np.int32)
    jo, ja, jpath = jd.speculative_accept_tree(*(jnp.asarray(a) for a in (target, block, draft, wl, zf, zi)),
                                               jax.random.key(0), jtree)
    to, ta, tpath = td.speculative_accept_tree(*(_t(a) for a in (target, block, draft, wl, zf, zi)), None, tree)
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(tpath), np.asarray(jpath))
    for i in range(n):
        np.testing.assert_array_equal(_np(to)[i, : ja[i] + 1], np.asarray(jo)[i, : ja[i] + 1])
    assert _np(ta).max() > 0


def test_accept_tree_sampled_marginal_preserved():
    """Two i.i.d. candidates from q per row (what draft_propose_tree emits),
    4096 rows: the first emitted token's marginal is the target's p."""
    _, tree = _jtree("2")
    n, vocab = 4096, 8
    rng = np.random.default_rng(7)
    p_logits = rng.normal(size=vocab).astype(np.float32) * 1.5
    q_logits = rng.normal(size=vocab).astype(np.float32) * 1.5
    q = np.exp(q_logits) / np.exp(q_logits).sum()
    p = np.exp(p_logits) / np.exp(p_logits).sum()
    target = np.tile(p_logits, (n, tree.width, 1))
    draft = np.tile(q_logits, (n, tree.width, 1))
    block = np.concatenate([np.zeros((n, 1), np.int32), rng.choice(vocab, size=(n, 2), p=q).astype(np.int32)], 1)
    out, n_acc, _ = td.speculative_accept_tree(
        *(_t(a) for a in (target, block, draft, np.full((n, 1), 2, np.int32), np.ones(n, np.float32),
                          np.zeros(n, np.int32))),
        td.sampling_generator(11, 0, "cpu", td.STREAM_VERIFY), tree,
    )
    emp = np.bincount(_np(out)[:, 0], minlength=vocab) / n
    np.testing.assert_allclose(emp, p, atol=0.04)
    assert 0.5 * np.abs(emp - p).sum() < TV_LIMIT  # total variation
    assert _np(n_acc).sum() > 0


def test_draft_propose_tree_greedy_matches_jax():
    jtree, tree = _jtree("2,2,1")
    jp, tp = _pair(layers=1)
    n, ctx = 3, SEQ + 12
    (jck, jcv), (tck, tcv) = _slot_caches(jp, tp, _ids(2, seed=9), n, ctx)
    toks = np.array([3, 50, 0], np.int32)
    pos = np.array([SEQ, SEQ, 0], np.int32)
    zf, zi = np.zeros(n, np.float32), np.zeros(n, np.int32)
    prop = jax.jit(functools.partial(jd.draft_propose_tree, tree=jtree))
    jt, jl, jnk, jnv, jck, jcv = prop(jp, jck, jcv, *(jnp.asarray(a) for a in (toks, pos, zf, zi)),
                                      jax.random.key(0))
    with torch.inference_mode():
        tt, tl, tnk, tnv, _, _ = td.draft_propose_tree(tp, tck, tcv, *(_t(a) for a in (toks, pos, zf, zi)), None,
                                                       tree)
    assert tt.shape == (n, tree.n_tree) and tl.shape == (n, tree.width, TINY["vocab"])
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    for a, b in ((tl, jl), (tnk, jnk), (tnv, jnv), (tck, jck), (tcv, jcv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def _tree_verify_inputs(tree, seed=12):
    n = 3
    queries = np.random.default_rng(seed).integers(0, TINY["vocab"], (n, tree.width)).astype(np.int32)
    return queries, np.array([0, SEQ, SEQ], np.int32)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_tree_verify_and_commits_match_jax(kv_dtype):
    """The widened tree verify (logits, fresh K/V; the pool untouched), then
    the accepted-path commits into the pool and into the flat draft cache,
    against the JAX package's on the same path."""
    jtree, tree = _jtree("2,2,1")
    jp, tp = _pair()
    jpool, tpool, bt = _paged_pools(jp, tp, _ids(2, seed=13), kv_dtype)
    queries, pos = _tree_verify_inputs(tree)
    before = [a.clone() for a in tpool]
    jl, _, jnk, jnv = jax.jit(functools.partial(jd.paged_tree_verify, tree=jtree))(
        jp, jpool, jnp.asarray(bt), jnp.asarray(queries), jnp.asarray(pos))
    with torch.inference_mode():
        tl, th, tnk, tnv = td.paged_tree_verify(tp, tpool, _t(bt), _t(queries), _t(pos), tree)
    assert all(torch.equal(a, b) for a, b in zip(tpool, before))
    assert th.shape == (3, tree.width, TINY["hidden"])
    np.testing.assert_allclose(_np(tl[1:]), np.asarray(jl[1:]), **TOL)
    np.testing.assert_allclose(_np(tnk[:, 1:]), np.asarray(jnk[:, 1:]), **TOL)
    np.testing.assert_allclose(_np(tnv[:, 1:]), np.asarray(jnv[:, 1:]), **TOL)
    # commit one path per slot: full depth, one node, nothing accepted
    path = np.array([[0, 2, 6, 10], [0, 1, 3, 7], [0, 2, 5, 9]], np.int32)
    n_acc = np.array([3, 1, 0], np.int32)
    jpool = jd.paged_tree_commit(jpool, jnp.asarray(bt), jnk, jnv, *(jnp.asarray(a) for a in (path, pos, n_acc)))
    with torch.inference_mode():
        td.paged_tree_commit(tpool, _t(bt), tnk, tnv, *(_t(a) for a in (path, pos, n_acc)))
    _assert_pools_close(tpool, jpool)
    # the draft side: node K/V [L, n, h, n_tree, hd] into a flat cache
    n, ctx = 3, SEQ + 12
    (jck, jcv), (tck, tcv) = _slot_caches(jp, tp, _ids(2, seed=14), n, ctx)
    node_k = np.random.default_rng(15).standard_normal(_np(tnk[:, :, :, 1:]).shape).astype(np.float32)
    node_v = node_k[..., ::-1].copy()
    cache_before = tck.clone()
    jck, jcv = jd.draft_tree_commit(jck, jcv, *(jnp.asarray(a) for a in (node_k, node_v, path, pos, n_acc)))
    td.draft_tree_commit(tck, tcv, *(_t(a) for a in (node_k, node_v, path, pos, n_acc)))
    np.testing.assert_allclose(_np(tck), np.asarray(jck), **TOL)  # the prefilled rows: float32 noise
    np.testing.assert_allclose(_np(tcv), np.asarray(jcv), **TOL)
    for i in range(n):  # the committed columns: exact copies of the chosen nodes
        for j in range(n_acc[i]):
            np.testing.assert_array_equal(_np(tck[:, i, :, pos[i] + 1 + j]), node_k[:, i, :, path[i, j + 1] - 1])
            np.testing.assert_array_equal(_np(tcv[:, i, :, pos[i] + 1 + j]), node_v[:, i, :, path[i, j + 1] - 1])
    assert torch.equal(tck[:, 2], cache_before[:, 2])  # a zero-accept slot changes nothing


def test_tree_verify_logits_match_sequential_paged_decode():
    """Every flattened node's logits from the one widened dispatch equal a
    sequential paged decode down that node's path (the property greedy path
    acceptance is exact because of)."""
    _, tree = _jtree("2,2")
    _, tp = _pair()
    jp = jd.init_decoder(seed=3, **TINY)
    _, tpool, bt = _paged_pools(jp, tp, _ids(2, seed=16), "")
    queries, pos = _tree_verify_inputs(tree, seed=17)
    with torch.inference_mode():
        logits, _, _, _ = td.paged_tree_verify(tp, tpool, _t(bt), _t(queries), _t(pos), tree)
        for blk in range(tree.width):
            path = [blk]
            while path[0] != 0:
                path.insert(0, int(tree.parent_block[path[0]]))
            walk = tuple(a.clone() for a in tpool)
            for d, b in enumerate(path):
                lg, _, _ = td.paged_decode_step(tp, walk, _t(bt), _t(queries[:, b]), _t(pos + d))
            np.testing.assert_allclose(_np(logits[1:, blk]), _np(lg[1:]), rtol=2e-4, atol=2e-5)
            np.testing.assert_array_equal(_np(logits[1:, blk].argmax(-1)), _np(lg[1:].argmax(-1)))


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_tree_commit_live_pages_never_receive_duplicate_writes(kv_dtype):
    """paged_tree_commit with slots accepting 0..depth nodes, a free slot
    and a slot whose path runs past its virtual length: every (page,
    offset) of a live page is written by at most one column and holds the
    accepted node's K/V; every other column lands on junk page 0; no other
    page moves."""
    tree = tst.SpecTree.from_text("2,2,1")
    ps, pps, h, hd, L = 4, 4, 2, 8, 2
    n, width = 5, tree.width
    bt = torch.tensor([[0, 0, 0, 0],  # free
                       [1, 2, 3, 4],
                       [5, 6, 7, 8],
                       [9, 10, 11, 12],
                       [13, 14, 15, 16]])
    pos = torch.tensor([0, 5, 2, 14, 7])  # slot 3's path runs past 16
    path = torch.tensor([[0, 1, 3, 7], [0, 2, 6, 10], [0, 1, 4, 8], [0, 2, 5, 9], [0, 1, 3, 7]])
    n_acc = torch.tensor([3, 3, 1, 3, 0])
    g = torch.Generator().manual_seed(0)
    new_k, new_v = torch.randn(L, n, h, width, hd, generator=g), torch.randn(L, n, h, width, hd, generator=g)
    shell = {"tok_emb": torch.zeros(1, h * hd), "pos_emb": torch.zeros(1, 1),
             "layers": [{"qkv": {"w": torch.zeros(h * hd, 1)}}] * L}
    pool = td.paged_kv_init(shell, 17, ps, kv_dtype=kv_dtype)
    before = [a.clone() for a in pool]
    td.paged_tree_commit(pool, bt, new_k, new_v, path, pos, n_acc)
    writers = {}
    for i in range(n):
        for j in range(int(n_acc[i]) + 1):
            gp = int(pos[i]) + j
            if gp < pps * ps and int(bt[i, gp // ps]) != 0:
                writers.setdefault((int(bt[i, gp // ps]), gp % ps), []).append((i, int(path[i, j])))
    assert writers and all(len(w) == 1 for w in writers.values()), writers
    for li in range(L):
        payload = pool[0][li].float()
        if kv_dtype:
            payload = payload * pool[1][li][:, None, :, None] + pool[2][li][:, None, :, None]
        for (page, off), [(i, blk)] in writers.items():
            want = new_k[li, i, :, blk]
            tol = 0 if not kv_dtype else float(want.max() - want.min()) / 254 * 0.51
            assert (payload[page, :, off] - want).abs().max() <= tol + 1e-7
    written = {page for page, _ in writers}
    for page in range(1, 17):
        if page not in written:
            assert all(torch.equal(a[:, page], b[:, page]) for a, b in zip(pool, before)), page


def test_sequence_logits_match_jax_and_prefill():
    jp, tp = _pair()
    ids = _ids(2, seq=12, seed=18)
    jl, jh = jax.jit(jd.sequence_hidden)(jp, jnp.asarray(ids))
    with torch.inference_mode():
        tl, th = td.sequence_hidden(tp, _t(ids))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
        np.testing.assert_allclose(_np(td.sequence_logits(tp, _t(ids))[:, -1]),
                                   _np(td.prefill(tp, _t(ids))[0]), **TOL)


def test_sampling_streams_are_deterministic_and_independent():
    """Step, draft and verify streams of one (seed, tick): each repeats
    itself, and no two give the same draws; stream 0 keeps its seed."""
    draws = {}
    for stream in (td.STREAM_STEP, td.STREAM_DRAFT, td.STREAM_VERIFY):
        a = torch.rand(32, generator=td.sampling_generator(5, 9, "cpu", stream))
        b = torch.rand(32, generator=td.sampling_generator(5, 9, "cpu", stream))
        assert torch.equal(a, b)
        draws[stream] = a
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    assert td.sampling_generator(5, 9, "cpu").initial_seed() == (5 << 32) | 9
