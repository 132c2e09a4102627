#!/usr/bin/env python3
"""How many draft tokens a seed-shared truncated draft gets accepted, by
draft depth, against a 12-layer ``tiny_gpt`` target (resid_scale 0.1), the
way ``gpt2_small_speculative`` pairs them: a k=4 chain through the port's
decode scheduler, 8 prompts on 8 slots, greedy.

    python3 spec_depth_probe.py --device cpu --vocab 8192 --hidden 256 --ffn 1024

Prints, per draft depth, the accept rate (accepted / proposed), the mean
accepted draft tokens per riding slot and round, and the tokens per
speculative round. The draft is built from the target's seed, so it is the
target's embeddings and leading layers.
"""

from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np
import torch

from seldon_core_tpu_torch.core.tensor import resolve_device
from seldon_core_tpu_torch.models.convert import params_to_torch
from seldon_core_tpu_torch.models.decoder import init_decoder
from seldon_core_tpu_torch.serving.decode_scheduler import DecodeScheduler


async def probe(args) -> None:
    dev = resolve_device(args.device)
    max_len = args.seq + args.max_new
    geometry = dict(vocab=args.vocab, hidden=args.hidden, ffn=args.ffn, max_len=max_len, resid_scale=0.1)
    target = params_to_torch(init_decoder(0, layers=args.layers, **geometry), dev)
    prompts = np.random.default_rng(9).integers(0, args.vocab, (8, args.seq)).astype(np.int32)
    for depth in args.draft_layers:
        draft = params_to_torch(init_decoder(0, layers=depth, **geometry), dev)
        sched = DecodeScheduler(target, seq_len=args.seq, max_new_tokens=args.max_new, n_slots=8,
                                draft_params=draft, spec_k=4)
        await asyncio.gather(*(sched.submit(p) for p in prompts))
        await sched.close()
        print(json.dumps(dict(
            device=str(dev), geometry=geometry, target_layers=args.layers, draft_layers=depth,
            accept_rate=sched.stat_spec_accepted / sched.stat_spec_proposed,
            mean_accepted_per_round=sched.stat_spec_accepted / sched.stat_spec_rides,
            tokens_per_spec_round=sched.stat_spec_emitted / sched.stat_spec_dispatches,
        )), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vocab", type=int, default=50257)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--ffn", type=int, default=3072)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--draft-layers", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    with torch.inference_mode():
        asyncio.run(probe(args))


if __name__ == "__main__":
    main()
