"""Distill a speculative draft against its serving target.

Port of ``seldon_core_tpu/training/distill_draft.py``. The ``zoo://draft``
entry ships as a seed-shared layer truncation of its target, and the
feature head (``zoo://draft?features=1``) as an untrained fuse: neither
has learned the target's conditionals. This recipe teaches them: the
target's teacher-forced logits at every position (``models/decoder.
sequence_logits``; for the head also its hidden states, ``sequence_hidden``)
-> KL into the draft, on a mix of on-policy rows (a prompt and the target's
own greedy continuation, the context verify rounds score the draft in) and
uniform-random rows.

Run (on the card unless ``--device cpu``):

    python -m seldon_core_tpu_torch.training.distill_draft \\
        --hidden 256 --layers 4 --ffn 1024 --draft-layers 1 \\
        --steps 300 --out draft_distilled.npz

and serve the result through the checkpoint-loading draft:

    tpu.decode_draft_model: "zoo://draft?layers=1&...&distilled=draft_distilled.npz"

``--features`` trains the EAGLE-style feature head instead: the loss adds
feature-regression MSE (``--feat-weight``) and input-feature noise
(``--feat-noise``). Serve it via
``zoo://draft?features=1&distilled=draft_feat.npz``.

The checkpoint is the JAX package's flat ``.npz`` (dotted tree paths as
keys), so either package serves the other's. The data draws, the pool's
refresh schedule and the report's keys are the reference's; training runs
in float32 on the device, the pool's teacher outputs stay there. The
report's accept proxy is the greedy per-position acceptance along the
target's own greedy continuations (for the head, on the target's true
features: the serving root's conditioning), before and after.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# ------------------------------------------------------- checkpoint format
# A flat .npz keyed by dotted tree paths ("layers.0.qkv.w", "ln_f.scale",
# ...): plain numpy, no pickle, geometry checked on load against the
# receiving build's own init.


def flatten_params(params) -> dict:
    flat: dict = {}

    def walk(p, prefix):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(v, f"{prefix}{i}.")
        elif isinstance(p, torch.Tensor):
            flat[prefix[:-1]] = p.detach().float().cpu().numpy()
        else:
            flat[prefix[:-1]] = np.asarray(p)

    walk(params, "")
    return flat


def save_draft_checkpoint(path: str, params) -> None:
    np.savez(path, **flatten_params(params))


def load_draft_checkpoint(path: str, like):
    """Rebuild ``like``'s tree (numpy leaves) from the checkpoint, raising
    on any missing key or shape mismatch: the load is an architecture
    assertion, not a best-effort merge."""
    data = np.load(path)

    def walk(p, prefix):
        if isinstance(p, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(p)]
        key = prefix[:-1]
        if key not in data:
            raise ValueError(f"distilled checkpoint {path!r} is missing {key!r}")
        arr = data[key]
        want = np.shape(p)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"distilled checkpoint {path!r} {key!r} has shape "
                f"{tuple(arr.shape)}, the draft build wants {tuple(want)} — "
                "the checkpoint was trained for a different geometry"
            )
        return arr.astype(np.asarray(p).dtype)

    return walk(like, "")


# ------------------------------------------------------------- the recipe


def _ids(a, device) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.int32)).to(device)


@torch.no_grad()
def greedy_accept_proxy(target, draft, prompts, max_new: int) -> float:
    """Along the target's greedy continuation of each prompt, the fraction
    of generated positions where the draft's argmax equals the target's:
    what the chain walk accepts per depth."""
    from seldon_core_tpu_torch.models.decoder import generate, sequence_logits

    dev = target["tok_emb"].device
    full = generate(target, _ids(prompts, dev), max_new)
    # row j's logits predict token j + 1: compare the generated span only
    tl = sequence_logits(target, full[:, :-1])
    dl = sequence_logits(draft, full[:, :-1])
    gen = slice(prompts.shape[1] - 1, full.shape[1] - 1)
    return float((tl[:, gen].argmax(-1) == dl[:, gen].argmax(-1)).float().mean())


@torch.no_grad()
def greedy_accept_proxy_features(target, head, prompts, max_new: int) -> float:
    """``greedy_accept_proxy`` for a feature head, run teacher-forced on the
    target's own hidden states: the serving root step's conditioning."""
    from seldon_core_tpu_torch.models.decoder import feature_sequence_logits, generate, sequence_hidden

    dev = target["tok_emb"].device
    full = generate(target, _ids(prompts, dev), max_new)
    tl, tf = sequence_hidden(target, full[:, :-1])
    dl, _ = feature_sequence_logits(head, full[:, :-1], tf)
    gen = slice(prompts.shape[1] - 1, full.shape[1] - 1)
    return float((tl[:, gen].argmax(-1) == dl[:, gen].argmax(-1)).float().mean())


def distill(
    *,
    seed: int = 0,
    vocab: int = 512,
    hidden: int = 256,
    layers: int = 4,
    ffn: int = 1024,
    max_len: int = 80,
    resid_scale: float = 1.0,
    draft_layers: int = 1,
    seq: int = 16,
    horizon: int = 48,
    batch: int = 16,
    steps: int = 300,
    lr: float = 1e-3,
    teacher_temp: float = 0.5,
    on_policy_frac: float = 0.5,
    eval_prompts: int = 16,
    out: str = "",
    log_every: int = 50,
    data_seed: int = 1234,
    features: bool = False,
    feat_weight: float = 1.0,
    feat_noise: float = 0.2,
    self_cond: float = 0.0,
    draft_ffn: int = 0,
    device=None,
) -> dict:
    """Distill a draft against its target; returns the report dict (accept
    proxy before and after, final KL) and writes the checkpoint to ``out``
    when set. ``features=False`` trains the seed-shared layer-truncation
    draft, ``features=True`` the feature head (``draft_ffn`` sizes its FFN,
    0 = the target's ``ffn``). ``device``: the card unless named (the
    port's entry-point rule: it raises where there is no card)."""
    from seldon_core_tpu_torch.core.tensor import resolve_device
    from seldon_core_tpu_torch.models.convert import params_to_torch
    from seldon_core_tpu_torch.models.decoder import (
        generate, init_decoder, init_feature_draft, sequence_hidden, sequence_logits,
    )
    from seldon_core_tpu_torch.training.steps import (
        adam, init_state, make_distill_step, make_feature_distill_step,
    )

    dev = resolve_device(device)
    target = params_to_torch(
        init_decoder(seed, vocab=vocab, hidden=hidden, layers=layers, ffn=ffn, max_len=max_len,
                     resid_scale=resid_scale),
        dev,
    )
    if features:
        draft = init_feature_draft(seed, vocab=vocab, hidden=hidden, ffn=draft_ffn or ffn, max_len=max_len)
        proxy = greedy_accept_proxy_features
    else:
        draft = init_decoder(seed, vocab=vocab, hidden=hidden, layers=draft_layers, ffn=ffn, max_len=max_len,
                             resid_scale=resid_scale)
        proxy = greedy_accept_proxy

    rng = np.random.default_rng(data_seed)
    eval_ids = rng.integers(0, vocab, (eval_prompts, seq)).astype(np.int32)
    state = init_state(draft, adam(lr), dev)
    accept_before = proxy(target, state.params, eval_ids, horizon - seq)

    if features:
        step = make_feature_distill_step(teacher_temp, feat_weight, feat_noise, self_cond)
    else:
        step = make_distill_step(sequence_logits, teacher_temp)

    # the teacher is frozen: a pool row's logits (and features) are
    # computed once per refresh, on the device, and gathered per step
    @torch.no_grad()
    def teach(ids):
        if features:
            return sequence_hidden(target, ids)
        return sequence_logits(target, ids), None

    def on_policy_batch(n):
        p = rng.integers(0, vocab, (n, seq)).astype(np.int32)
        with torch.no_grad():
            ids = generate(target, _ids(p, dev), horizon - seq)
        return (ids, *teach(ids))

    def cat(a, b):
        return a if b is None else torch.cat([a, b])

    pool, pool_t, pool_f = on_policy_batch(max(batch * 4, 32))
    kl = agree = fmse = float("nan")
    history = []
    for i in range(steps):
        n_on = int(round(batch * on_policy_frac))
        idx = rng.integers(0, len(pool), n_on) if n_on else None
        rand = rng.integers(0, vocab, (batch - n_on, horizon)).astype(np.int32)
        rand = _ids(rand, dev) if len(rand) else None
        rand_t, rand_f = teach(rand) if rand is not None else (None, None)
        if idx is not None:
            it = torch.from_numpy(idx).to(dev)
            ids, t = cat(pool[it], rand), cat(pool_t[it], rand_t)
            f = cat(pool_f[it], rand_f) if features else None
        else:
            ids, t, f = rand, rand_t, rand_f
        batch_d = {"x": ids, "t": t}
        if features:
            batch_d["f"] = f
        state, m = step(state, batch_d)
        kl, agree = float(m["kl"]), float(m["top1_agreement"])
        if features:
            fmse = float(m["feat_mse"])
        if log_every and (i + 1) % log_every == 0:
            row = {"step": i + 1, "kl": round(kl, 4), "top1": round(agree, 4)}
            line = f"step {i+1:5d}  kl {kl:.4f}  top1 {agree:.4f}"
            if features:
                row["feat_mse"] = round(fmse, 4)
                line += f"  fmse {fmse:.4f}"
            history.append(row)
            print(line, flush=True)
        if (i + 1) % max(1, steps // 4) == 0:
            # refresh as the draft moves
            pool, pool_t, pool_f = on_policy_batch(len(pool))

    accept_after = proxy(target, state.params, eval_ids, horizon - seq)
    if out:
        save_draft_checkpoint(out, state.params)
    report = {
        "accept_proxy_before": round(accept_before, 4),
        "accept_proxy_after": round(accept_after, 4),
        "final_kl": round(kl, 4),
        "final_top1": round(agree, 4),
        "steps": steps,
        "features": bool(features),
        "history": history,
        "checkpoint": out or None,
        "geometry": {
            "seed": seed, "vocab": vocab, "hidden": hidden, "layers": layers,
            "ffn": ffn, "max_len": max_len, "resid_scale": resid_scale,
            "draft_layers": draft_layers,
        },
    }
    if features:
        report["final_feat_mse"] = round(fmse, 4)
        report["geometry"]["draft_ffn"] = draft_ffn or ffn
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4, help="TARGET layers")
    ap.add_argument("--ffn", type=int, default=1024)
    ap.add_argument("--max-len", type=int, default=80)
    ap.add_argument("--resid-scale", type=float, default=1.0)
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=16, help="prompt length")
    ap.add_argument("--horizon", type=int, default=48,
                    help="full training-sequence length (prompt + on-policy span)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--teacher-temp", type=float, default=0.5,
                    help="sharpen the teacher before the KL (<1 weights its argmax; 1.0 is pure "
                    "distribution-matching)")
    ap.add_argument("--on-policy-frac", type=float, default=0.5,
                    help="fraction of each batch drawn from target-greedy continuations")
    ap.add_argument("--out", default="", help="checkpoint path (.npz)")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--features", action="store_true",
                    help="train the EAGLE-style feature draft HEAD instead of the layer-truncation "
                    "draft; serve via zoo://draft?features=1&distilled=...")
    ap.add_argument("--feat-weight", type=float, default=1.0,
                    help="feature-regression MSE weight beside the KL (features mode)")
    ap.add_argument("--feat-noise", type=float, default=0.2,
                    help="input-feature noise std fraction during training (features mode); 0 disables")
    ap.add_argument("--self-cond", type=float, default=0.0,
                    help="weight of a self-conditioned second pass (features mode)")
    ap.add_argument("--draft-ffn", type=int, default=0, help="feature head FFN width (0 = the target's --ffn)")
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    report = distill(
        seed=args.seed, vocab=args.vocab, hidden=args.hidden, layers=args.layers,
        ffn=args.ffn, max_len=args.max_len, resid_scale=args.resid_scale,
        draft_layers=args.draft_layers, seq=args.seq, horizon=args.horizon,
        batch=args.batch, steps=args.steps, lr=args.lr, teacher_temp=args.teacher_temp,
        on_policy_frac=args.on_policy_frac, out=args.out, log_every=args.log_every,
        features=args.features, feat_weight=args.feat_weight, feat_noise=args.feat_noise,
        self_cond=args.self_cond, draft_ffn=args.draft_ffn, device=args.device,
    )
    print(json.dumps(report))


if __name__ == "__main__":
    main()
