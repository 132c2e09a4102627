#!/usr/bin/env python3
"""Drive the PyTorch port (``seldon_core_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card visible

Phases, each of which raises on failure (no phase catches its own):

1. build every CUDA kernel under ``seldon_core_tpu_torch/csrc/`` with nvcc
   for sm_90a (into the git-ignored ``build/kernels/``, one nvcc per source,
   all started together), and count the Hopper instructions in the built
   libraries (``HGMMA``, ``UTMALDG``): the flash kernel must hold both,
   the W8A16 kernel both and ``HMMA`` (its mma.sync body for ragged shapes);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, as contiguous tensors and as the views
   of one fused QKV projection that BERT hands it (plus the causal and
   ragged cases), with limits scaled to each case's output, show that two
   planted faults fail the same check, and time kernel, plain version and
   the library call that computes the same function (CUDA events, median of
   25 single calls, each queued behind a device sleep so host launch time is
   not counted; inputs stay warm in L2, as they are when the attention
   follows the QKV projection; the bucket-8 cases are also timed with a cold
   L2, and the host cost of a call is measured);
3. serve BERT-base (hidden 768, 12 layers, 12 heads, seq 512, bfloat16,
   random weights from seed 0) through the port's REST ingress from
   ``seldon_core_tpu_torch/deployments/bert_base_flash.json``, with the
   launch counter proving the attention ran through the kernel, the answers
   held against the same weights run with blockwise attention and with the
   kernel's plain version, and three wrong attentions shown to fail that
   check; then one request at seq 4096 under the ``auto`` policy, which
   must launch it too;
4. serve the five BASELINE deployments from
   ``seldon_core_tpu_torch/deployments/`` through REST: iris, MNIST and the
   iris A/B test as JSON (answers against the port's own forward on the
   CPU; the A/B routing against ``random.Random(1337)``); the 3x ResNet50
   average ensemble as one FusedUnit fed uint8 npy bodies at batch 1 and
   128 (answers against the same bf16 weights walked unfused; per member,
   bf16 logits against float32 on the card and float32 against the CPU,
   with a stem padded (3, 3) and a max-pool padded (1, 1) shown to fail;
   fused, sequential and unfused forwards timed); the transformer ->
   epsilon-greedy -> 2x BERT-base DAG at seq 128 as JSON ids (12 kernel
   launches per request, answers against blockwise attention, and a
   feedback that moves only the routed arm).
5. serve the four decoder deployments of
   ``seldon_core_tpu_torch/deployments/`` through REST: ``tiny_gpt`` (the
   fused greedy ``generate``, buckets 2 and 8) against the port's forward and
   ``reference_generate`` on the CPU; ``gpt_continuous_batching`` (8 slots)
   under 16 staggered requests with mixed ``max_new_tokens`` against the
   fused ``generate`` on the card (float32, TF32 off), one SSE stream
   against its buffered reply, no new dispatch key after warmup, an EOS
   deployment retiring early, and the per-step device time;
   ``tiny_gpt_paged_kv`` (int8 pages, prefix reuse, chunked prefill) under
   shared-prefix traffic, with the int8 pool's teacher-forced logits against
   an fp pool's and the allocator's audit; ``gpt2_small_long_prompt``
   (GPT-2-small widths, a 4096-token prompt, bf16), whose prefill must
   launch the causal flash kernel once per layer, with its prompt (and
   first-token) logits and greedy ids held against blockwise causal attention and the
   kernel's plain version, two wrong attentions shown to fail, and the
   request's time split into prefill, kernel and decode.
   Greedy ids of two paths may part only at a near-tie: at the first
   token where a row diverges, the reference path's top logit must be
   within the tie margin of the served token's.
6. serve the three speculative deployments of
   ``seldon_core_tpu_torch/deployments/`` through REST — ``tiny_gpt_speculative``
   (a 1-layer draft, k=4), ``tiny_gpt_tree_speculation`` (tree "2,2,1,1",
   accept floor 0.3, prefix reuse) and ``gpt2_small_speculative``
   (GPT-2-small widths, a 2-layer draft, k=4, bf16), plus a tree copy of
   the last ("2,2,1,1": a verify 15 wide) and a float32 copy: 16 staggered
   requests with mixed budgets, one opted out (``spec_k=0``), served by the
   speculative server and by a copy with speculation off in turns; every
   greedy row held to the plain scheduler's and to the fused ``generate``'s
   under the tie rule, one SSE stream against its buffered reply, no new
   dispatch key after warmup; per deployment the rounds, tokens per target
   dispatch, accept rate, mean accepted per round, ms per token against the
   plain scheduler, and one round's wall, device time (draft and verify)
   and host share. Three planted faults: a draft from another seed (ids
   unchanged, accept rate lower), an acceptance that keeps one draft token
   past the first mismatch and a tree commit that writes a sibling's K/V
   (both must fail the id check). The speculation path launches no flash
   kernel (counted).
7. int8 weights and the resilience layer: the W8A16 kernel
   (``csrc/int8_matmul.cu``) against its plain version in bf16 and float32
   at BERT-base's served projections at bucket 32 and bucket 1, iris's (M,
   4 -> 3), the wgmma body's edges (M % 128 != 0, K % 64 != 0, N not a
   multiple of the tile) and three stacked members (through the vmap rule,
   a shared input and per-member rows, at K 768 and 776), each case on the
   body ``select_body`` must name for it (counted per body), with scales
   applied per row and one dropped K tile shown to fail every case, each
   case timed beside its plain version, ``torch.addmm`` /
   ``torch.baddbmm`` on the pre-dequantized weights and, where it took
   the wgmma body, the mma.sync body on the same inputs; the wrapper's host
   cost per call; the ``bert_int8`` deployment through REST (49 launches
   per forward, counted: 48 on the wgmma body, the head on the mma body;
   probabilities against the bf16 deployment and the CPU; resident
   parameter bytes; a profiler breakdown at bucket 32);
   ``iris_fallback_breaker`` on the card with faults
   installed (fallback and breaker, a deadline tag's 504, a breakered node
   without fallback answering 500 then 503 with Retry-After, and
   ``batch_across_requests`` false walking each request alone).
8. telemetry, which every phase ran with at its defaults: 50 one-row
   requests each on ``bert_base_flash`` and the DAG, each with its own W3C
   ``traceparent`` and the ``trace`` tag, every ``/traces/{puid}`` a tree
   (an ingress root continuing the header, one batcher span, one span per
   unit call, children inside their parents) and ``/metrics`` counts rising
   by exactly the requests and unit calls (and one DAG feedback);
   ``iris_fallback_breaker`` with a failing primary, its retry, fault,
   degraded and breaker metrics against the traces and the fault schedule;
   ``gpt_continuous_batching``'s ``/decode/flight`` frames against the
   served tokens, ``/decode/health``, ``/decode/profile`` (``?hz`` capped
   at 200), an SLO copy's attainment counters; the decode round's split
   (busy against gap, enqueue against readback per family, the gap by
   phase) with ``ENGINE_FLIGHT_SYNC_TIMING`` off and on, also for
   ``gpt2_small_speculative``; the step's wall with the recorder on and
   off, and an idle step direct, through the worker and the hop alone;
   iris and the DAG under the load generator at 16 users with telemetry on
   and off, in turns. A dropped span, a metric off by one and a frame that
   loses a token must each fail their check.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the port beside it, it exits non-zero and prints no result.
TF32 is off for every matmul and convolution here (the plain versions and
the model's projections run in full float32 where they are float32).
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
# Kernel vs plain version, scaled to each case's output: the max abs error
# may reach ULPS ulps (in the dtype) of max|ref|, and ||out - ref|| / ||ref||
# may reach REL_L2. float32 sums in another order (measured: 2 ulps). bf16
# and f16 also round p per 128-key tile against the running max instead of
# once per row, which at most flips the rounding of an output element
# (measured: 1 ulp of max|ref| at every shape). A 5% error in the softmax
# normaliser or one dropped KV tile fails both limits; phase 2 shows that on
# every run.
KERNEL_TOL = {"float32": (64, 1e-5), "float16": (4, 1e-2), "bfloat16": (4, 1e-2)}
MANTISSA_BITS = {"float32": 23, "float16": 10, "bfloat16": 7}
# Served bf16 probabilities vs the same weights with blockwise attention, or
# with the kernel's plain version in its place: measured 0.0048 and 0.0050
# (ulp flips carried through 12 bf16 layers; the run is deterministic), while
# a uniform attention, a 5% normaliser error or one dropped 128-key KV tile
# moves them by 0.026 to 0.040 (chip_smoke.py on an H100, PERF.md). The limit sits
# between, and phase 3 checks on every run that the three stay outside it.
SERVE_ATOL = 1.5e-2
ROW_SUM_ATOL = 1e-3
SEQ_LONG = 4096  # the auto policy takes the kernel from PALLAS_MIN_SEQ
L2_FLUSH_BYTES = 128 << 20  # written before a cold-L2 call: over twice the 50 MB L2
KV_TILE = 128  # keys per KV tile of the bf16/f16 kernel
BASELINE_DIR = ROOT / "seldon_core_tpu_torch" / "deployments"
DEVICE = "cuda"  # where phases 4 and 5 serve
# Phase 4 limits (measured numbers: chip_smoke.py on an H100, PERF.md).
# Small models against the port's own forward on the CPU on the same
# weights: float32 sums 4 to 512 terms in another order (measured 1.2e-7);
# the bf16 MNIST deployment rounds each layer to bf16 on both sides, after
# sums taken in other orders (measured 2.2e-8; one flipped bf16 rounding of
# a logit could move a probability by a few 1e-3).
SMALL_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
AB_REQUESTS = 12
# The fused ensemble (members vmapped: grouped convolutions) against the same
# bf16 weights walked unfused (one convolution per member). Random-init
# ResNet50 logits reach 3e5, where one bf16 ulp is 2048: two top logits
# that tie in one path and not in the other move that member's probability
# by 0.5, the ensemble's by 1/6 (measured on some rows). So each row agrees
# within ENSEMBLE_ATOL, or differs by a tie: a multiple of 1/6 of a
# 3-member ensemble, in at most ENSEMBLE_TIE_ROWS of the rows.
ENSEMBLE_ATOL = 1e-2
ENSEMBLE_TIE_ROWS = 0.1
# Per member, logits (not probabilities: random-init ResNets saturate their
# softmax, so a probability check cannot see a padding fault): bf16 on the
# card against float32 on the card (measured 0.0046-0.0055; the JAX package
# 0.0046 on the CPU), and float32 on the card against float32 on the CPU
# (measured 4.5e-7). A stem padded (3, 3) or a max-pool padded (1, 1) moved
# them by 0.0110-0.0149 in bf16 and in float32: at least 2x the bf16 noise,
# so both faults must fail both checks.
RESNET_BF16_REL_L2 = 8e-3
RESNET_F32_REL_L2 = 1e-4
# Phase 5 limits (measured numbers: chip_smoke.py on an H100, PERF.md).
# Greedy ids of two paths (the card against the CPU, the scheduler against
# the fused generate, the kernel against blockwise attention) may part only
# at a near-tie: at the first diverging token the other path's top logit
# must be within GEN_TIE_MARGIN of its logit for the served token.
# No tie row showed in the first card run (32 GPT-2-small bf16 tokens
# against blockwise and the plain version; every float32 row equal).
GEN_TIE_MARGIN = {"float32": 1e-3, "bfloat16": 0.1}
# GPT-2-small prefill logits at every prompt position (the last row gives
# the first generated token), kernel against blockwise attention and against
# the plain version, relative L2: measured 0.0099-0.0124 (bf16 rounding
# through 12 layers), while a mask shifted by one key moved them by 0.076
# over the whole prompt (0.037 at the last row, whose own attention has no
# key past it to see) and a dropped 128-key tile by 0.32. The limit sits
# between, 2.4x above the noise and 2.5x below the shifted mask; both wrong
# attentions must land outside it over the whole prompt on every run.
LONG_LOGITS_REL_L2 = 0.03
INT8_KV_ATOL = 0.25  # the JAX package's own bound (tests/test_kv_pool.py)
CB_REQUESTS = 16
# Phase 6: requests per deployment, and the least mean number of draft
# tokens the GPT-2-small chain (k=4) must accept per riding slot and round
SPEC_REQUESTS = 16
SPEC_MIN_ACCEPTED = 1.0
# Phase 7: the W8A16 kernel against its plain version under KERNEL_TOL, as
# the flash kernel is held: bf16 rounds y once where the plain version rounds
# the product and then its sum with the bias (an ulp of y apart at most);
# every body forms the plain version's W bit for bit; float32 sums in
# another order. Scales applied per row instead of per column, or one K
# tile dropped, must fail every case (PERF.md has the measured margins). The bert_int8 deployment's
# probabilities against the same seed's bf16 deployment without weight_quant
# are held to the JAX package's own int8 bound (tests/test_quant.py:94);
# against the port's int8 forward on the CPU to SERVE_ATOL (bf16 rounding
# flips through 12 layers).
# K columns per tile: 64 for the wgmma and mma bodies (bf16), 32 for fma
INT8_K_TILE = {"bfloat16": 64, "float32": 32}
INT8_SERVE_ATOL = 3e-2
INT8_LAUNCHES = 12 * 4 + 1  # qkv, attn_out, mlp_in, mlp_out per layer, and the head
INT8_LAUNCHES_BY_BODY = {"wgmma": 12 * 4, "mma": 1, "fma": 0}  # the head has N = 2


def require_launches(label: str, deltas: list, want: int) -> None:
    """Launches per request on a served path, as the kernels' counters read
    them: on a captured path each replay credits the launches its capture
    counted, so 0 means the replays credit nothing, not that no kernel ran."""
    if any(d == 0 for d in deltas):
        raise AssertionError(f"{label}: a captured path reports 0 launches per request {deltas}: its graph replays "
                             f"credit no launches to the counter (want {want} each)")
    if deltas != [want] * len(deltas):
        raise AssertionError(f"{label}: launches per request {deltas}, want {want} each")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 25, warmup: int = 3, cold_l2: bool = False) -> float:
    """Median device time of one call, from CUDA events around the call. A
    device sleep ahead of each call keeps the queue full, so the events see
    only the call's own kernels, not the host's launch path. ``cold_l2``
    writes L2_FLUSH_BYTES between the sleep and the call, outside the
    events, so the call finds none of its inputs in L2."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def attention_bound(b, h, sq, sk, d, dtype_name, causal):
    """Least time for the call on an H100 SXM: each input read once and the
    output written once at HBM rate, against the multiply-adds the unmasked
    (row, key) pairs need at the dtype's peak."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = elem * b * h * d * (2 * sq + 2 * sk)
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    ops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def agreement(out, ref, dtype_name: str) -> dict:
    """How far ``out`` is from ``ref``, against the KERNEL_TOL limits scaled
    to this output: atol is ULPS ulps of max|ref| in the dtype."""
    import math

    import torch

    ulps, rel_limit = KERNEL_TOL[dtype_name]
    o, r = out.double(), ref.double()
    ref_max = r.abs().max().item()
    atol = ulps * 2.0 ** (math.floor(math.log2(max(ref_max, 1e-30))) - MANTISSA_BITS[dtype_name])
    max_abs = (o - r).abs().max().item()
    rel_l2 = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    ok = bool(torch.isfinite(out).all()) and max_abs <= atol and rel_l2 <= rel_limit
    return dict(max_abs_err=max_abs, atol=atol, rel_l2=rel_l2, rel_l2_limit=rel_limit, ok=ok)


def qkv_views(b, h, s, d, dtype, g):
    """q, k, v as models/bert.py cuts them from one fused QKV projection
    [b, s, 3*h*d]: [b, h, s, d] views, batch stride 3*h*d*s, head stride d,
    seq stride 3*h*d."""
    import torch

    fused = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2) for t in fused.split(h * d, dim=-1))


def drop_kv_tile(k, v):
    """k, v without their second KV tile (KV_TILE keys, or half of a KV
    shorter than two tiles): what a kernel that skipped one stage of its
    ring would attend over."""
    import torch

    sk = k.shape[2]
    t = min(KV_TILE, sk // 2)
    keep = torch.cat([torch.arange(t), torch.arange(2 * t, sk)]).to(k.device)
    return k[:, :, keep].contiguous(), v[:, :, keep].contiguous()


def check_flash(case, card):
    """One kernel-vs-plain case on the card; returns its numbers. Two
    planted faults — the softmax normaliser 5% large, one KV tile dropped —
    must fail the same check, or the check is too loose for this case."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    name, (b, h, sq, sk, d), dtype, causal, layout = case
    g = torch.Generator(device="cuda").manual_seed(len(name) * 7919 + sq)
    if layout == "qkv_views":
        q, k, v = qkv_views(b, h, sq, d, dtype, g)
    else:
        q = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(b, h, sk, d, generator=g, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    dtype_name = str(dtype).removeprefix("torch.")
    agree = agreement(out, ref, dtype_name)
    planted = {
        "l_x1.05": agreement((out.float() / 1.05).to(dtype), ref, dtype_name),
        "kv_tile_dropped": agreement(
            fa.flash_attention_reference(q, *drop_kv_tile(k, v), causal=causal), ref, dtype_name),
    }
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    ms_cold_l2 = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), cold_l2=True) if b == 8 else None
    plain_ms = device_ms(lambda: fa.flash_attention_reference(q, k, v, causal=causal))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    bound_ms, bound_by = attention_bound(b, h, sq, sk, d, dtype_name, causal)
    row = dict(
        case=name, shape=[b, h, sq, sk, d], dtype=dtype_name, causal=causal, layout=layout,
        max_abs_err=agree["max_abs_err"], atol=agree["atol"], rel_l2=agree["rel_l2"],
        rel_l2_limit=agree["rel_l2_limit"],
        planted_faults={k_: dict(max_abs_err=a["max_abs_err"], rel_l2=a["rel_l2"], caught=not a["ok"])
                        for k_, a in planted.items()},
        ms=ms, ms_cold_l2=ms_cold_l2, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by,
    )
    print(f"[{card}] flash_attention {json.dumps(row)}", flush=True)
    if not agree["ok"]:
        raise AssertionError(f"flash_attention {name}: kernel disagrees with its plain version: {agree}")
    for fault, a in planted.items():
        if a["ok"]:
            raise AssertionError(f"flash_attention {name}: the check passes a planted fault ({fault}): {a}")
    return row


async def _request(port: int, body: bytes, ctype: str = "application/json",
                   path: str = "/api/v0.1/predictions", headers: dict | None = None,
                   method: str = "POST") -> tuple[int, dict, bytes, float]:
    """One request through the port's REST ingress (a POST unless told):
    (status, lower-case headers, body, wall ms from connect to the last
    byte)."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items()).encode()
    writer.write(
        b"%s %s HTTP/1.1\r\nHost: localhost\r\nContent-Type: %s\r\nContent-Length: %d\r\n%s"
        b"Connection: close\r\n\r\n" % (method.encode(), path.encode(), ctype.encode(), len(body), extra) + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    ms = (time.perf_counter() - t0) * 1e3
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split(" ", 2)[1]), headers, payload, ms


async def _post(port: int, body: bytes) -> tuple[int, dict, float]:
    status, _, payload, ms = await _request(port, body)
    return status, json.loads(payload), ms


def _model_runtime(server):
    return server.executor.root.unit.runtime


def _check_probs(out, n: int, classes: int = 2) -> "np.ndarray":
    """Served probabilities (a JSON response, or the array of an npy one):
    finite, [n, classes], every row summing to 1."""
    import numpy as np

    data = out["data"]["ndarray"] if isinstance(out, dict) else out
    probs = np.asarray(data, dtype=np.float64)
    if probs.shape != (n, classes) or not np.isfinite(probs).all():
        raise AssertionError(f"served probabilities have shape {probs.shape}, want ({n}, {classes})")
    worst = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if worst > ROW_SUM_ATOL:
        raise AssertionError(f"probability rows sum to 1 +- {worst} > {ROW_SUM_ATOL}")
    return probs


def plain_attention(q, k, v):
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return flash_attention_reference(q, k, v)


def wrong_attentions() -> dict:
    """Attentions that are wrong in ways a broken kernel could be: every key
    weighted alike, the softmax normaliser 5% large, one KV tile dropped."""
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return {
        "uniform": lambda q, k, v: v.mean(dim=2, keepdim=True).expand(q.shape),
        "l_x1.05": lambda q, k, v: flash_attention_reference(q, k, v) / 1.05,
        "kv_tile_dropped": lambda q, k, v: flash_attention_reference(q, *drop_kv_tile(k, v)),
    }


def check_served_bert(card, label: str, served) -> dict:
    """Served bf16 probabilities against the same weights run another way:
    with blockwise attention (no kernel) and with the kernel's plain version
    in its place, both within SERVE_ATOL; three wrong attentions on the same
    weights must land outside it. Float32 blockwise is a yardstick of the
    bf16 noise. ``served``: (runtime, ids, probabilities) per request."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.bert import apply_for_kernel, make_apply_bert
    from seldon_core_tpu_torch.models.convert import params_to_torch

    blockwise = apply_for_kernel("blockwise")
    plain = make_apply_bert(plain_attention)
    controls = {name: make_apply_bert(fn) for name, fn in wrong_attentions().items()}
    worst = dict.fromkeys(["blockwise", "plain_version", "blockwise_f32", *controls], 0.0)
    params32 = {}
    with torch.inference_mode():
        for runtime, ids, probs in served:
            if id(runtime) not in params32:
                params32[id(runtime)] = params_to_torch(runtime.params, runtime.device, torch.float32)
            x = torch.from_numpy(ids.astype(np.int32)).to(runtime.device)
            ref = blockwise(runtime.params, x).float().cpu().numpy()
            for name, (apply, params) in {"blockwise": (blockwise, runtime.params),
                                          "plain_version": (plain, runtime.params),
                                          "blockwise_f32": (blockwise, params32[id(runtime)])}.items():
                got = apply(params, x).float().cpu().numpy()
                worst[name] = max(worst[name], float(np.abs(probs - got).max()))
            for name, apply in controls.items():
                got = apply(runtime.params, x).float().cpu().numpy()
                worst[name] = max(worst[name], float(np.abs(got - ref).max()))
    del params32
    print(f"[{card}] {label} served vs blockwise: max_abs_diff={worst['blockwise']}; vs the kernel's plain "
          f"version: {worst['plain_version']} (atol {SERVE_ATOL} each); vs blockwise float32: "
          f"{worst['blockwise_f32']}", flush=True)
    print(f"[{card}] {label} wrong attentions vs blockwise (each must exceed {SERVE_ATOL}): "
          + " ".join(f"{name}={worst[name]}" for name in controls), flush=True)
    if max(worst["blockwise"], worst["plain_version"]) > SERVE_ATOL:
        raise AssertionError(f"{label}: served probabilities disagree with the same weights run another way: {worst}")
    for name in controls:
        if worst[name] <= SERVE_ATOL:
            raise AssertionError(f"{label}: the serving check cannot see a wrong attention ({name}: {worst[name]})")
    return worst


async def serve_bert(card, deployment: Path):
    """Phase 3: BERT-base at seq 512 through REST, then the auto arm."""
    import numpy as np

    from seldon_core_tpu_torch.graph.defaulting import default_deployment
    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES
    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, dep_name = load_predictor(str(deployment))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=dep_name, device="cuda")
    runtime = _model_runtime(server)
    t1 = time.perf_counter()
    server.warmup()
    t2 = time.perf_counter()
    layers = len(runtime.params["layers"])
    seq = runtime.feature_shape[0]
    vocab = runtime.params["tok_emb"].shape[0]
    print(f"[{card}] serve: {deployment.name} layers={layers} seq={seq} vocab={vocab} "
          f"dtype={runtime.dtype} buckets={runtime.buckets} build_s={t1 - t0:.3f} "
          f"warmup_s={t2 - t1:.3f} offload_compute={runtime.offload_compute} "
          f"warmup_forward_ms={runtime.stat_forward_ms}", flush=True)

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, vocab, size=(n, seq)) for n in (1, 8, 1, 8)]
    await server.start("127.0.0.1", 0)
    try:
        served, deltas, latencies = [], [], []
        LAUNCHES.reset()  # the main path's run starts here
        for ids in batches:
            before = LAUNCHES.count
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"predict returned HTTP {status}: {out}")
            served.append(_check_probs(out, len(ids)))
            deltas.append(LAUNCHES.count - before)
            latencies.append(ms)
        main_launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    for ids, ms, delta in zip(batches, latencies, deltas):
        print(f"[{card}] request batch={len(ids)} seq={seq} latency_ms={ms:.3f} kernel_launches={delta}", flush=True)
    require_launches("bert_base_flash flash_attention", deltas, layers)

    check_served_bert(card, "bert_base_flash", [(runtime, ids, probs) for ids, probs in zip(batches, served)])
    forward_breakdown(card, runtime, rng)

    # auto policy at long sequence: must take the kernel on the card
    auto_dep = {"spec": {"name": "bert-base-auto", "predictors": [{
        "name": "main",
        "graph": {"name": "bert", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "model_uri", "value": f"zoo://bert_base?seq={SEQ_LONG}&max_len={SEQ_LONG}", "type": "STRING"}]},
        "tpu": {"max_batch": 1, "batch_buckets": [1], "dtype": "bfloat16"}}]}}
    auto_pred = default_deployment(SeldonDeployment.from_dict(auto_dep)).spec.predictors[0]
    long_server = PredictorServer(auto_pred, deployment_name="bert-base-auto", device="cuda")
    long_layers = len(_model_runtime(long_server).params["layers"])
    long_server.warmup()
    await long_server.start("127.0.0.1", 0)
    try:
        ids = rng.integers(0, vocab, size=(1, SEQ_LONG))
        LAUNCHES.reset()
        status, out, ms = await _post(long_server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
        auto_launches = LAUNCHES.count
    finally:
        await long_server.stop()
    if status != 200:
        raise AssertionError(f"auto predict returned HTTP {status}: {out}")
    _check_probs(out, 1)
    print(f"[{card}] request auto batch=1 seq={SEQ_LONG} latency_ms={ms:.3f} kernel_launches={auto_launches}", flush=True)
    require_launches(f"bert-base auto policy at seq {SEQ_LONG} flash_attention", [auto_launches], long_layers)
    return main_launches


def forward_breakdown(card, runtime, rng, reps: int = 3):
    """Where a served forward's time goes, per batch bucket: the host wall
    time of ``runtime.predict`` (ids in, probabilities back on the host),
    the device's busy time inside it as torch.profiler's CUDA activity sums
    it, the flash kernel's part of that, and the costliest kernels."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vocab, seq = runtime.params["tok_emb"].shape[0], runtime.feature_shape[0]
    for n in runtime.buckets:
        ids = rng.integers(0, vocab, size=(n, seq))
        runtime.predict(ids)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            runtime.predict(ids)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[len(walls) // 2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                runtime.predict(ids)
        kernels, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
                launches += e.count
        busy = sum(kernels.values())
        flash = sum(t for k, t in kernels.items() if "flash_fwd" in k)
        copies = sum(t for k, t in kernels.items() if "copy" in k.lower())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        if busy > 0:
            device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f} "
                      f"flash_ms={flash:.4f} flash_share_of_busy={flash / busy:.3f} copy_ms={copies:.4f}")
        else:
            device = "device time: not measured (the profiler saw no device activity)"
        print(f"[{card}] breakdown bucket={n} seq={seq} predict_wall_ms={wall:.3f} "
              f"device_ops_per_forward={launches / reps:g} {device}", flush=True)
        for name, t in top:
            print(f"    {t:.4f} ms  {name[:110]}")


def profile_device(fn, reps: int = 3) -> tuple[dict, float]:
    """Device time per call of each kernel ``fn`` runs (torch.profiler's CUDA
    activity, averaged over ``reps`` calls) and device operations per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
            launches += e.count
    return kernels, launches / reps


def wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` (which must end on the host)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


async def _start(path: Path, cuda_graphs: bool = True, **server_kw):
    """A warmed PredictorServer for one deployment file, serving REST on a
    free port on the card; returns it with its build and warmup seconds.
    ``cuda_graphs=False`` builds the eager twin; ``server_kw`` goes to the
    server (``metrics_enabled=False``). The server's
    ``warmup_reserved_bytes`` is the growth of torch.cuda.memory_reserved()
    over its warmup (from an emptied cache): on the captured server, the
    graph pool."""
    import torch

    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, name = load_predictor(str(path))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=name, device=DEVICE, cuda_graphs=cuda_graphs, **server_kw)
    t1 = time.perf_counter()
    on_card = DEVICE == "cuda"
    if on_card:
        torch.cuda.synchronize()
        gc.collect()  # earlier servers' graphs and buffers leave the cache first
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
    server.warmup()
    if on_card:
        torch.cuda.synchronize()
    server.warmup_reserved_bytes = torch.cuda.memory_reserved() - reserved if on_card else 0
    t2 = time.perf_counter()
    await server.start("127.0.0.1", 0)
    return server, t1 - t0, t2 - t1


def cpu_forward(runtime, x, cache: dict) -> "np.ndarray":
    """The runtime's own apply on the CPU, on the weights it holds on the
    card (copied over in their dtype)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch

    if id(runtime) not in cache:
        cache[id(runtime)] = params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)
    with torch.inference_mode():
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(runtime.dtype)
        return runtime.apply_fn(cache[id(runtime)], xt).float().numpy()


async def serve_small(card) -> None:
    """Phase 4a: iris, MNIST and the iris A/B test as JSON, each answer held
    against the port's own forward on the CPU; the A/B test's routing
    against the sequence random.Random(1337) gives."""
    import random

    import numpy as np

    rng = np.random.default_rng(1)
    cases = (("iris", 4, 8.0, (1, 4, 1)), ("mnist", 784, 1.0, (1, 4, 1)),
             ("iris_abtest", 4, 8.0, (1,) * AB_REQUESTS))
    for name, features, scale, sizes in cases:
        server, build_s, warmup_s = await _start(BASELINE_DIR / f"{name}.json")
        try:
            results = []
            for n in sizes:
                x = rng.uniform(0, scale, size=(n, features)).round(2)
                status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": x.tolist()}}).encode())
                if status != 200:
                    raise AssertionError(f"{name} predict returned HTTP {status}: {out}")
                results.append((x, out, ms))
        finally:
            await server.stop()
        root = server.executor.root
        routes = [out["meta"].get("routing", {}).get(root.name) for _, out, _ in results]
        cache, worst, dtype = {}, 0.0, None
        for (x, out, _), route in zip(results, routes):
            runtime = (root if route is None else root.children[route]).unit.runtime
            dtype = str(runtime.dtype).removeprefix("torch.")
            probs = _check_probs(out, len(x), len(runtime.class_names))
            worst = max(worst, float(np.abs(probs - cpu_forward(runtime, x, cache)).max()))
        lat = " ".join(f"{ms:.3f}" for _, _, ms in results)
        print(f"[{card}] {name}: dtype={dtype} build_s={build_s:.3f} warmup_s={warmup_s:.3f} "
              f"request_ms=[{lat}] vs the CPU forward: max_abs_diff={worst} (atol {SMALL_ATOL[dtype]})", flush=True)
        if worst > SMALL_ATOL[dtype]:
            raise AssertionError(f"{name}: served probabilities disagree with the CPU forward by {worst}")
        if name == "iris_abtest":
            draws = random.Random(1337)
            want = [0 if draws.random() < root.unit.ratio_a else 1 for _ in routes]
            print(f"[{card}] iris_abtest routing {routes}", flush=True)
            if routes != want:
                raise AssertionError(f"A/B routing {routes}, random.Random(1337) gives {want}")


def _member_params(predictor, dtype, device):
    """Each ensemble member's parameters, from its zoo URI, in ``dtype``."""
    from seldon_core_tpu_torch.graph.spec import parameters_dict
    from seldon_core_tpu_torch.models import zoo
    from seldon_core_tpu_torch.models.convert import params_to_torch

    out = []
    for child in predictor.graph.children:
        name, kwargs = zoo._parse_zoo_uri(parameters_dict(child.parameters)["model_uri"])
        ms = zoo.get_model(name, **kwargs)
        out.append(params_to_torch(ms.params, device, dtype, ms.layout))
    return out


class planted:
    """Replace one function of a module for the duration of a ``with``."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def resnet_padding_faults() -> dict:
    """The two shape-preserving padding faults of a port of XLA's SAME:
    the 7x7/2 stem padded (3, 3), the 3x3/2 max-pool padded (1, 1)."""
    import torch.nn.functional as F

    from seldon_core_tpu_torch.models import resnet

    same = resnet._same_pads
    return {
        "stem_3_3": planted(resnet, "_same_pads", lambda n, k, s: (3, 3) if k == 7 else same(n, k, s)),
        "max_pool_1_1": planted(resnet, "_max_pool_same", lambda h: F.max_pool2d(h, 3, 2, padding=1)),
    }


def check_resnet_logits(card, predictor, image) -> dict:
    """Per member: bf16 logits on the card against float32 logits on the
    card (TF32 off), and float32 logits on the card against float32 logits
    on the CPU; the two planted padding faults must fail both checks."""
    import torch

    from seldon_core_tpu_torch.models import resnet

    cuda, cpu = torch.device(DEVICE), torch.device("cpu")
    x = torch.from_numpy(image).to(cuda)
    rows = []
    with torch.inference_mode():
        for i, (p16, p32, pcpu) in enumerate(zip(_member_params(predictor, torch.bfloat16, cuda),
                                                 _member_params(predictor, torch.float32, cuda),
                                                 _member_params(predictor, torch.float32, cpu))):
            l32 = resnet.resnet_logits(p32, x.float()).cpu()
            row = {"member": i, "max_abs_logit": float(l32.abs().max()),
                   "bf16_vs_f32": rel_l2(resnet.resnet_logits(p16, x.to(torch.bfloat16)).float().cpu(), l32)}
            lcpu = resnet.resnet_logits(pcpu, x.cpu().float())
            row["f32_vs_cpu"] = rel_l2(l32, lcpu)
            for fault, ctx in resnet_padding_faults().items():
                with ctx:
                    row[f"{fault}_bf16"] = rel_l2(resnet.resnet_logits(p16, x.to(torch.bfloat16)).float().cpu(), l32)
                    row[f"{fault}_f32"] = rel_l2(resnet.resnet_logits(p32, x.float()).cpu(), lcpu)
            rows.append(row)
            print(f"[{card}] resnet50 member logits (relative L2): {json.dumps(row)}", flush=True)
    for row in rows:
        if row["bf16_vs_f32"] > RESNET_BF16_REL_L2 or row["f32_vs_cpu"] > RESNET_F32_REL_L2:
            raise AssertionError(f"resnet50 member logits disagree: {row}")
        for fault in resnet_padding_faults():
            if row[f"{fault}_bf16"] <= RESNET_BF16_REL_L2 or row[f"{fault}_f32"] <= RESNET_F32_REL_L2:
                raise AssertionError(f"the resnet logits check passes a planted fault ({fault}): {row}")
    return rows


def serve_resnet_ensemble(card) -> None:
    """Phase 4b: the 3x ResNet50 average ensemble as one FusedUnit, fed uint8
    npy bodies at batch 1 and 128, answered in npy; the answers against the
    same bf16 weights walked unfused; each member's logits checked; fused,
    sequential and unfused forwards timed."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from seldon_core_tpu_torch.core.message import SeldonMessage
    from seldon_core_tpu_torch.engine.executor import build_executor
    from seldon_core_tpu_torch.engine.fused import FusedUnit
    from seldon_core_tpu_torch.models.resnet import apply_resnet

    loop = asyncio.new_event_loop()
    try:
        server, build_s, warmup_s = loop.run_until_complete(_start(BASELINE_DIR / "resnet_ensemble.json"))
        try:
            fused = server.executor.root.unit
            if not isinstance(fused, FusedUnit) or server.executor.root.children:
                raise AssertionError(f"the ensemble's root is {type(fused).__name__}, not one FusedUnit")
            runtime = fused.runtime
            print(f"[{card}] resnet_ensemble: root {fused.image} dtype={runtime.dtype} buckets={runtime.buckets} "
                  f"build_s={build_s:.3f} warmup_s={warmup_s:.3f} offload_compute={runtime.offload_compute}",
                  flush=True)
            rng = np.random.default_rng(3)
            shape, classes = runtime.feature_shape, len(runtime.class_names)
            images = {n: rng.integers(0, 256, size=(n, *shape), dtype=np.uint8) for n in (1, max(runtime.buckets))}
            served = {}
            for n, x in list(images.items()) * 2:
                buf = io.BytesIO()
                np.save(buf, x)
                status, headers, body, ms = loop.run_until_complete(
                    _request(server.port, buf.getvalue(), "application/x-npy"))
                if status != 200 or headers.get("content-type") != "application/x-npy":
                    raise AssertionError(f"npy predict returned HTTP {status} {headers}: {body[:200]!r}")
                served[n] = _check_probs(np.load(io.BytesIO(body)), n, classes)
                print(f"[{card}] request resnet_ensemble npy uint8 batch={n} body_bytes={len(buf.getvalue())} "
                      f"latency_ms={ms:.3f} seldon_meta={headers.get('seldon-meta')}", flush=True)
        finally:
            loop.run_until_complete(server.stop())

        predictor = server.predictor
        unfused_spec = dataclasses.replace(predictor, tpu=dataclasses.replace(predictor.tpu, fuse_graph=False))
        unfused = build_executor(unfused_spec, context={"device": torch.device(DEVICE)})
        for node in unfused.root.walk():
            if getattr(node.unit, "runtime", None) is not None:
                node.unit.runtime.warmup()

        def walk_unfused(x):
            return np.asarray(loop.run_until_complete(unfused.execute(SeldonMessage.from_array(x))).array)

        gaps = np.concatenate([np.abs(served[n] - walk_unfused(x)).max(axis=1) for n, x in images.items()])
        ties = gaps > ENSEMBLE_ATOL
        tie_steps = gaps[ties] * 6  # a tie in one member moves a 3-member mean by 1/6
        print(f"[{card}] resnet_ensemble fused vs unfused (same bf16 weights): rows={len(gaps)} "
              f"within {ENSEMBLE_ATOL}: {int((~ties).sum())}, max_abs_diff of those={float(gaps[~ties].max(initial=0.0))}; "
              f"bf16 logit ties: {int(ties.sum())} rows, diffs {sorted(float(g) for g in gaps[ties])}", flush=True)
        if ties.mean() > ENSEMBLE_TIE_ROWS or np.abs(tie_steps - np.round(tie_steps)).max(initial=0) > 6 * ENSEMBLE_ATOL:
            raise AssertionError(f"the fused ensemble disagrees with the unfused walk: {sorted(gaps[ties])}")
        check_resnet_logits(card, predictor, images[1])

        members = [_unstack(runtime.params["members"], i) for i in range(len(predictor.graph.children))]

        def sequential(x):
            with torch.inference_mode():
                y = torch.stack([apply_resnet(m, x.to(runtime.dtype)) for m in members]).mean(dim=0)
            return y

        for n, x in images.items():
            xdev = torch.from_numpy(x).to(DEVICE)
            rows = {
                "fused_vmap": lambda: runtime.predict(x),
                "fused_sequential": lambda: sequential(xdev).cpu(),
                "unfused_walk": lambda: walk_unfused(x),
            }
            for label, host_fn in rows.items():
                wall = wall_ms(host_fn)
                kernels, ops = profile_device(host_fn)
                busy = sum(kernels.values())
                top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
                device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f}" if busy > 0
                          else "device time: not measured (the profiler saw no device activity)")
                print(f"[{card}] resnet_ensemble breakdown bucket={n} {label} wall_ms={wall:.3f} "
                      f"device_ops_per_forward={ops:g} {device}", flush=True)
                for name, t in top:
                    print(f"    {t:.4f} ms  {name[:110]}")
    finally:
        loop.close()


def _unstack(tree, i):
    """Member ``i`` of a tree stacked on a leading ensemble axis."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unstack(v, i) for v in tree)
    return tree[i]


async def serve_dag(card) -> int:
    """Phase 4c: transformer -> epsilon-greedy -> 2x BERT-base (seq 128,
    attn_kernel=pallas) as JSON ids. The flash kernel must launch 12 times
    per request; the answers are held against blockwise attention on the
    routed arm's weights; one feedback of reward 1 must move only the routed
    arm's counts and rewards. Returns the kernel launches of the path."""
    import numpy as np

    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    server, build_s, warmup_s = await _start(BASELINE_DIR / "full_dag_bert.json")
    router_node = server.executor.root.children[0]
    router = router_node.unit
    arms = [c.unit.runtime for c in router_node.children]
    seq, vocab = arms[0].feature_shape[0], arms[0].params["tok_emb"].shape[0]
    layers = len(arms[0].params["layers"])
    print(f"[{card}] full_dag_bert: {server.executor.root.name} -> {router_node.name} -> "
          f"{[c.name for c in router_node.children]} seq={seq} layers={layers} dtype={arms[0].dtype} "
          f"buckets={arms[0].buckets} build_s={build_s:.3f} warmup_s={warmup_s:.3f}", flush=True)
    rng = np.random.default_rng(4)
    try:
        served, deltas, latencies, responses = [], [], [], []

        async def ask(ids):
            before = LAUNCHES.count
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"DAG predict returned HTTP {status}: {out}")
            route = out["meta"]["routing"][router_node.name]
            served.append((arms[route], ids, _check_probs(out, len(ids))))
            deltas.append(LAUNCHES.count - before)
            latencies.append((len(ids), route, ms))
            responses.append(out)

        LAUNCHES.reset()  # the path's run starts here
        for n in (1, 8, 1, 64, 1):
            await ask(rng.integers(0, vocab, size=(n, seq)))
        route = responses[0]["meta"]["routing"][router_node.name]
        counts, rewards = list(router.counts), list(router.rewards)
        fb = json.dumps({"response": responses[0], "reward": 1.0}).encode()
        status, _, body, _ = await _request(server.port, fb, path="/api/v0.1/feedback")
        if status != 200:
            raise AssertionError(f"feedback returned HTTP {status}: {body[:200]!r}")
        want_counts = [c + (i == route) for i, c in enumerate(counts)]
        want_rewards = [r + (1.0 if i == route else 0.0) for i, r in enumerate(rewards)]
        print(f"[{card}] feedback reward=1 on arm {route}: counts {counts} -> {router.counts}, "
              f"rewards {rewards} -> {router.rewards}", flush=True)
        if router.counts != want_counts or router.rewards != want_rewards:
            raise AssertionError(f"feedback moved the router to {router.counts} {router.rewards}, "
                                 f"want {want_counts} {want_rewards}")
        for n in (1, 8):
            await ask(rng.integers(0, vocab, size=(n, seq)))
        launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    for (n, route, ms), delta in zip(latencies, deltas):
        print(f"[{card}] request full_dag_bert batch={n} seq={seq} arm={route} latency_ms={ms:.3f} "
              f"kernel_launches={delta}", flush=True)
    require_launches("full_dag_bert flash_attention", deltas, layers)
    check_served_bert(card, "full_dag_bert", served)
    return launches


def _ids_post(port: int, ids, tags: dict | None = None, path: str = "/api/v0.1/predictions"):
    body = {"data": {"ndarray": ids.tolist()}}
    if tags:
        body["meta"] = {"tags": tags}
    return _request(port, json.dumps(body).encode(), path=path)


def next_logits(params, seq) -> "torch.Tensor":
    """Float32 next-token logits after ``seq`` (one prefill forward)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import prefill

    with torch.inference_mode():
        return prefill(params, torch.from_numpy(np.asarray(seq, np.int64)[None]))[0][0].float()


def tie_rule(label, served, ref, params, prompt_len: int, dtype_name: str) -> list:
    """Rows of ``served`` against ``ref`` (int arrays, prompt included):
    equal, or parting first at a near-tie of the reference path, whose
    parameters are ``params`` (its attention as currently planted). Returns
    the tie rows as (row, generated index, gap)."""
    import numpy as np

    margin = GEN_TIE_MARGIN[dtype_name]
    ties = []
    for r, (a, b) in enumerate(zip(np.asarray(served), np.asarray(ref))):
        n = min(len(a), len(b))
        diff = np.nonzero(a[prompt_len:n] != b[prompt_len:n])[0]
        if not len(diff):
            continue
        t = prompt_len + int(diff[0])
        logits = next_logits(params, a[:t].astype(np.int64)).cpu()
        gap = float(logits.max() - logits[int(a[t])])
        ties.append((r, t - prompt_len, gap))
        if gap > margin:
            raise AssertionError(f"{label}: row {r} parts from the reference at generated token {t - prompt_len} "
                                 f"({a[t]} vs {b[t]}) with a top-logit gap of {gap} > {margin}")
    return ties


def _cpu_params(runtime):
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch

    return params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)


async def serve_tiny_gpt(card) -> None:
    """Phase 5a: the fused greedy generate through REST at buckets 2 and 8
    (float32), held against the port's own generate and reference_generate
    on the CPU on the same weights."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import generate, reference_generate

    server, build_s, warmup_s = await _start(BASELINE_DIR / "tiny_gpt.json")
    runtime = _model_runtime(server)
    seq, max_new = runtime.generative["seq"], runtime.generative["max_new_tokens"]
    vocab = runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(5)
    try:
        served = []
        for n in (2, 8):
            ids = rng.integers(0, vocab, size=(n, seq))
            status, _, body, ms = await _ids_post(server.port, ids)
            if status != 200:
                raise AssertionError(f"tiny_gpt predict returned HTTP {status}: {body[:300]!r}")
            out = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)
            if out.shape != (n, seq + max_new) or not (out[:, :seq] == ids).all():
                raise AssertionError(f"tiny_gpt served ids of shape {out.shape}, want ({n}, {seq + max_new}) "
                                     "with the prompt echoed")
            served.append((ids, out, ms))
    finally:
        await server.stop()
    cpu = _cpu_params(runtime)
    ties = []
    for ids, out, ms in served:
        with torch.inference_mode():
            want = generate(cpu, torch.from_numpy(ids), max_new).numpy()
        ref = reference_generate(cpu, ids, max_new)
        if not (ref == want).all():
            raise AssertionError("tiny_gpt: the CPU generate disagrees with reference_generate")
        ties += tie_rule("tiny_gpt", out, want, cpu, seq, "float32")
        print(f"[{card}] request tiny_gpt batch={len(ids)} latency_ms={ms:.3f} rows equal to the CPU "
              f"forward: {int((out == want).all(axis=1).sum())}/{len(ids)}", flush=True)
    print(f"[{card}] tiny_gpt: build_s={build_s:.3f} warmup_s={warmup_s:.3f} tie rows {ties} "
          f"(margin {GEN_TIE_MARGIN['float32']})", flush=True)


def _fused_oracle(runtime, ids):
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.decoder import generate

    with torch.inference_mode():
        return generate(runtime.params, torch.from_numpy(np.asarray(ids)).to(runtime.device),
                        runtime.generative["max_new_tokens"]).cpu().numpy()


def _deployment_copy(name: str, tpu_update: dict, graph_update: dict | None = None) -> Path:
    """A copy of a deployment file with its tpu block (and its graph's
    parameter values) updated, under the git-ignored build/."""
    dep = json.loads((BASELINE_DIR / f"{name}.json").read_text())
    pred = dep["spec"]["predictors"][0]
    pred["tpu"].update(tpu_update)
    for p in pred["graph"]["parameters"]:
        p["value"] = (graph_update or {}).get(p["name"], p["value"])
    path = ROOT / "build" / f"{name}_{'_'.join([*tpu_update, *(graph_update or {})])}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


async def _read_sse(port: int, ids) -> tuple[int, list]:
    """One POST to the SSE route: (status, the data events in order)."""
    status, headers, body, _ = await _ids_post(port, ids, path="/api/v0.1/predictions/stream")
    if status != 200 or headers.get("transfer-encoding") != "chunked":
        raise AssertionError(f"stream returned HTTP {status} {headers}: {body[:300]!r}")
    raw, rest = b"", body
    while True:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            break
        raw, rest = raw + rest[:size], rest[size + 2:]
    return status, [json.loads(f[6:]) for f in raw.split(b"\n\n") if f.startswith(b"data: ")]


async def serve_continuous_batching(card) -> None:
    """Phase 5b: gpt_continuous_batching under 16 staggered requests with
    mixed per-request max_new_tokens, every row against the fused generate
    on the card; one SSE stream against its buffered reply; no new dispatch
    key after warmup; an EOS copy of the deployment retiring early; the
    per-step device time and host share."""
    import numpy as np

    path = BASELINE_DIR / "gpt_continuous_batching.json"
    server, build_s, warmup_s = await _start(path)
    twin, _, twin_warm = await _start(path, cuda_graphs=False)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, vocab, size=(CB_REQUESTS, seq))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=CB_REQUESTS)]

    async def traffic(port):
        async def one(i):
            await asyncio.sleep(0.004 * i)  # staggered arrival: later rows admit mid-stream
            return await _ids_post(port, prompts[i : i + 1], {"max_new_tokens": budgets[i]})

        t0 = time.perf_counter()
        replies = await asyncio.gather(*(one(i) for i in range(CB_REQUESTS)))
        return replies, time.perf_counter() - t0

    try:
        replies, wall = await traffic(server.port)
        twin_replies, twin_wall = await traffic(twin.port)
        status, events = await _read_sse(server.port, prompts[:1])
        _, _, body, _ = await _ids_post(server.port, prompts[:1])
        buffered = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        recompiles = (sched.recompiles_since_warmup(), twin.decode_scheduler.recompiles_since_warmup())
        steps, peak = sched.stat_steps, sched.stat_peak_active
    finally:
        await server.stop()
        await twin.stop()
    served = _served_rows("gpt_continuous_batching", replies, budgets, seq)
    twin_rows = _served_rows("gpt_continuous_batching eager twin", twin_replies, budgets, seq)
    hold_twin_rows("gpt_continuous_batching", served, twin_rows)
    want = _fused_oracle(runtime, prompts)
    ties = []
    for r, (out, b) in enumerate(zip(served, budgets)):
        ties += [(r, *t[1:]) for t in tie_rule("gpt_continuous_batching", [out], [want[r][: seq + b]],
                                               runtime.params, seq, "float32")]
    lat = sorted(ms for _, _, _, ms in replies)
    tokens = [e["token"] for e in events if "token" in e]
    done = events[-1]
    print(f"[{card}] gpt_continuous_batching: slots={sched.n_slots} build_s={build_s:.3f} warmup_s={warmup_s:.3f} "
          f"requests={CB_REQUESTS} tokens={sum(budgets)} wall_s={wall:.3f} steps={steps} peak_active={peak} "
          f"latency_ms p50={lat[len(lat) // 2]:.3f} max={lat[-1]:.3f} rows equal to the fused generate: "
          f"{sum(int((o == w[: len(o)]).all()) for o, w in zip(served, want))}/{CB_REQUESTS} tie rows {ties} "
          f"recompiles_since_warmup (captured, eager)={recompiles}; eager twin wall_s={twin_wall:.3f} "
          f"warmup_s={twin_warm:.3f}; compile_counts {sched.compile_counts()} captures={sched.graphs.stat_captures}; "
          f"warmup memory_reserved growth bytes captured={server.warmup_reserved_bytes} "
          f"eager={twin.warmup_reserved_bytes}", flush=True)
    print(f"[{card}] gpt_continuous_batching stream: {len(tokens)} token events, done={done.get('done')} "
          f"gen_lens={done.get('gen_lens')}", flush=True)
    if recompiles != (0, 0):
        raise AssertionError(f"the schedulers (captured, eager) built {recompiles} new keys after warmup")
    if tokens != buffered[seq:].tolist() or done.get("ids") != [buffered.tolist()]:
        raise AssertionError("the SSE stream's tokens differ from the buffered reply for the same prompt")
    step_breakdown(card, {"captured": sched, "eager": twin.decode_scheduler})

    # EOS: a copy of the deployment whose eos id is the 3rd greedy token of
    # a prompt must stop that row there
    eos = int(want[1][seq + 2])
    server, _, _ = await _start(_deployment_copy("gpt_continuous_batching", {"decode_eos_id": eos}))
    try:
        status, _, body, ms = await _ids_post(server.port, prompts[1:2])
    finally:
        await server.stop()
    out = json.loads(body)
    gen_len = out["meta"]["tags"]["gen_lens"][0]
    cut = seq + want[1][seq:].tolist().index(eos) + 1
    print(f"[{card}] gpt_continuous_batching eos={eos}: gen_lens={gen_len} latency_ms={ms:.3f}", flush=True)
    row = np.asarray(out["data"]["ndarray"], np.int64)[0]
    if status != 200 or gen_len != cut - seq or not (row[:cut] == want[1][:cut]).all() or not (row[cut:] == eos).all():
        raise AssertionError(f"the EOS deployment did not retire the row at its first eos: {body[:300]!r}")


def hold_twin_rows(label: str, rows, twin_rows) -> None:
    """Greedy ids of the captured scheduler against its eager twin's: bit for
    bit (the same kernels, launch configurations and order run either
    way)."""
    differ = [r for r, (a, b) in enumerate(zip(rows, twin_rows)) if a.shape != b.shape or (a != b).any()]
    if differ:
        raise AssertionError(f"{label}: captured rows {differ} differ from the eager twin's")


def step_breakdown(card, scheds: dict, reps: int = 20) -> None:
    """One scheduler step per mode with every slot generating (all-zero
    block tables: every write lands in junk page 0): host wall time (the
    step ends in the token readback), device busy time, host share."""
    import numpy as np

    fns = {}
    for mode, sched in scheds.items():
        n = sched.n_slots
        z, pos = np.zeros(n, np.int32), np.full(n, sched.max_ctx - 1, np.int32)
        bt, zf = sched.pool.block_tables(), np.zeros(n, np.float32)

        def step(sched=sched, z=z, pos=pos, bt=bt, zf=zf):
            sched.pool.load_block_tables(bt)
            sched._step(z, pos, zf, z, 0)

        fns[mode] = step
    any_sched = next(iter(scheds.values()))
    _modes_breakdown(card, f"decode step breakdown slots={any_sched.n_slots} "
                     f"virtual_ctx={any_sched.pool.virtual_ctx}", fns, "step", reps)


async def serve_paged_kv(card) -> None:
    """Phase 5c: tiny_gpt_paged_kv (int8 pages, prefix reuse, chunked
    prefill) under shared-prefix traffic: the prefix index must hit, the
    allocator's audit must hold, and int8 against fp pools on the same
    weights, teacher-forced, must stay within INT8_KV_ATOL."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import decoder

    path = BASELINE_DIR / "tiny_gpt_paged_kv.json"
    server, build_s, warmup_s = await _start(path)
    twin, _, _ = await _start(path, cuda_graphs=False)
    sched, runtime = server.decode_scheduler, _model_runtime(server)
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, vocab, size=(12, seq))
    prompts[:, : seq - 16] = prompts[0, : seq - 16]  # one shared system prompt

    async def traffic(port):
        first = await _ids_post(port, prompts[:1], {"cache_prefix": seq - 16})
        rest = await asyncio.gather(*(_ids_post(port, prompts[i : i + 1]) for i in range(1, 12)))
        out = []
        for status, _, body, _ in [first, *rest]:
            if status != 200:
                raise AssertionError(f"tiny_gpt_paged_kv returned HTTP {status}: {body[:300]!r}")
            out.append(np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0])
        return out

    try:
        served = await traffic(server.port)
        hold_twin_rows("tiny_gpt_paged_kv", served, await traffic(twin.port))
        stats = dict(hits=sched.stat_prefix_hits, misses=sched.stat_prefix_misses,
                     tokens_saved=sched.stat_prefix_tokens_saved, chunks=sched.stat_chunk_dispatches,
                     cow=sched.pool.alloc.stat_cow_copies, shared=sched.pool.alloc.stat_pages_shared,
                     recompiles=sched.recompiles_since_warmup(),
                     twin_recompiles=twin.decode_scheduler.recompiles_since_warmup(),
                     compile_counts=sched.compile_counts(), captures=sched.graphs.stat_captures,
                     pool_bytes=server.warmup_reserved_bytes)
        sched.pool.alloc.check()
    finally:
        await server.stop()
        await twin.stop()
    want = _fused_oracle(runtime, prompts)
    agree = float(np.mean([(s[seq:] == w[seq:]).mean() for s, w in zip(served, want)]))

    # teacher-forced int8 against fp pools on the deployment's weights
    params, pool = runtime.params, sched.pool
    pps = pool.pages_per_slot
    bt = torch.arange(1, 1 + pps, device=runtime.device)[None, :]
    on = lambda a: torch.as_tensor(a, device=runtime.device)  # noqa: E731
    streams = {}
    with torch.inference_mode():
        pools = {kv: decoder.paged_kv_init(params, 1 + pps, pool.page_size, kv_dtype=kv) for kv in ("", "int8")}
        for kv, p in pools.items():
            lg, _, _ = decoder.paged_chunk_prefill(params, p, bt, on(prompts[:1]), on([0]), on([seq]))
            streams[kv] = [lg[0, seq - 1].float().cpu()]
        tok = int(torch.argmax(streams[""][0]))
        for i in range(sched.max_new_tokens - 1):
            for kv, p in pools.items():
                lg, _, _ = decoder.paged_decode_step(params, p, bt, on([tok]), on([seq + i]))
                streams[kv].append(lg[0].float().cpu())
            tok = int(torch.argmax(streams[""][-1]))
    drift = max(float((a - b).abs().max()) for a, b in zip(streams[""], streams["int8"]))
    print(f"[{card}] tiny_gpt_paged_kv: kv_dtype={pool.kv_dtype} pages={pool.n_pages} page_size={pool.page_size} "
          f"build_s={build_s:.3f} warmup_s={warmup_s:.3f} {json.dumps(stats)} greedy agreement with the fused "
          f"generate={agree:.3f} int8 vs fp teacher-forced max logit drift={drift} (limit {INT8_KV_ATOL})", flush=True)
    if stats["hits"] <= 0 or stats["recompiles"] != 0 or stats["twin_recompiles"] != 0:
        raise AssertionError(f"tiny_gpt_paged_kv: no prefix hit or a new dispatch key: {stats}")
    if not 0.0 < drift < INT8_KV_ATOL:
        raise AssertionError(f"int8 KV logits drift {drift} from the fp pool's (limit {INT8_KV_ATOL}, and > 0)")


def shifted_mask_attention(q, k, v):
    """Causal attention whose mask lets each row see one key past itself."""
    import math

    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril(diagonal=1)
    return torch.matmul(torch.softmax(s.masked_fill(~keep, -1e30), dim=-1), v.float()).to(q.dtype)


def tile_dropped_attention(q, k, v):
    """Causal attention with keys KV_TILE..2*KV_TILE-1 masked out of every
    row: one 128-key tile dropped."""
    import math

    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
    keep[:, KV_TILE : 2 * KV_TILE] = False
    keep[:, 0] = True
    return torch.matmul(torch.softmax(s.masked_fill(~keep, -1e30), dim=-1), v.float()).to(q.dtype)


def causal_arms() -> dict:
    """The decoder's prefill attention run other ways: blockwise (no
    kernel), the kernel's plain version, and two wrong attentions."""
    from seldon_core_tpu_torch.ops.attention import blockwise_attention
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention_reference

    return {
        "blockwise": lambda q, k, v: blockwise_attention(q, k, v, block_size=512, causal=True),
        "plain_version": lambda q, k, v: flash_attention_reference(q, k, v, causal=True),
        "shifted_mask": shifted_mask_attention,
        "tile_dropped": tile_dropped_attention,
    }


async def serve_long_prompt(card) -> int:
    """Phase 5d: GPT-2-small widths, one 4096-token prompt per request,
    bf16. The prefill must launch the flash kernel once per layer; prompt
    logits within LONG_LOGITS_REL_L2 of blockwise attention and of the
    kernel's plain version, two wrong attentions outside it; greedy ids
    equal to both up to the tie rule; where the request's time goes.
    Returns the kernel launches of the path."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import decoder
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES

    server, build_s, warmup_s = await _start(BASELINE_DIR / "gpt2_small_long_prompt.json")
    runtime = _model_runtime(server)
    params, dims = runtime.params, decoder.decoder_dims(runtime.params)
    seq, max_new = runtime.generative["seq"], runtime.generative["max_new_tokens"]
    rng = np.random.default_rng(8)
    try:
        served, deltas, latencies = [], [], []
        LAUNCHES.reset()  # the path's run starts here
        for _ in range(2):
            ids = rng.integers(0, dims["vocab"], size=(1, seq))
            before = LAUNCHES.count
            status, _, body, ms = await _ids_post(server.port, ids)
            if status != 200:
                raise AssertionError(f"gpt2_small_long_prompt returned HTTP {status}: {body[:300]!r}")
            served.append((ids, np.asarray(json.loads(body)["data"]["ndarray"], np.int64)))
            deltas.append(LAUNCHES.count - before)
            latencies.append(ms)
        launches = LAUNCHES.count  # ... and ends here
    finally:
        await server.stop()
    print(f"[{card}] gpt2_small_long_prompt: {json.dumps(dims)} dtype={runtime.dtype} build_s={build_s:.3f} "
          f"warmup_s={warmup_s:.3f} latency_ms={[round(m, 3) for m in latencies]} kernel_launches={deltas}",
          flush=True)
    require_launches("gpt2_small_long_prompt flash_attention", deltas, dims["layers"])
    for ids, out in served:
        if out.shape != (1, seq + max_new) or not (out[:, :seq] == ids).all():
            raise AssertionError(f"gpt2_small_long_prompt served ids of shape {out.shape}")

    def prompt_logits(x):
        h = decoder._embed(params, x)
        for lp in params["layers"]:
            h, _, _ = decoder._layer_prefill(lp, h, dims["heads"])
        return decoder._logits(params, h)[0].float()

    ids = served[0][0]
    with torch.inference_mode():
        x = torch.from_numpy(ids).to(runtime.device)
        kernel_logits = prompt_logits(x)
        rows, ties = {}, {}
        for name, fn in causal_arms().items():
            with planted(decoder, "_causal_attention", fn):
                got = prompt_logits(x)
                rows[name] = rel_l2(got, kernel_logits)
                rows[f"{name}_first_token"] = rel_l2(got[-1], kernel_logits[-1])
                del got
                if name in ("blockwise", "plain_version"):
                    ref = decoder.generate(params, x, max_new).cpu().numpy()
                    ties[name] = tie_rule(f"gpt2_small_long_prompt vs {name}", served[0][1], ref, params, seq,
                                          "bfloat16")
    print(f"[{card}] gpt2_small_long_prompt prompt logits vs the kernel (relative L2; limit "
          f"{LONG_LOGITS_REL_L2}): {json.dumps(rows)}; greedy tie rows {ties}", flush=True)
    if max(rows[f"{a}{b}"] for a in ("blockwise", "plain_version") for b in ("", "_first_token")) > LONG_LOGITS_REL_L2:
        raise AssertionError(f"long-prompt logits disagree with the same weights run another way: {rows}")
    for name in ("shifted_mask", "tile_dropped"):
        if rows[name] <= LONG_LOGITS_REL_L2:
            raise AssertionError(f"the long-prompt check cannot see a wrong attention ({name}: {rows[name]})")
    long_breakdown(card, runtime, ids)
    return launches


def long_breakdown(card, runtime, ids) -> None:
    """Where one long-prompt request's device time goes: the request's host
    wall (ids in, ids back), device busy and idle share, the prefill's
    device time and the kernel's share of it, and the per-token decode
    device time."""
    import torch

    from seldon_core_tpu_torch.models.decoder import prefill

    max_new = runtime.generative["max_new_tokens"]
    x = torch.from_numpy(ids).to(runtime.device)

    def prefill_only():
        with torch.inference_mode():
            prefill(runtime.params, x)[0].cpu()

    wall = wall_ms(lambda: runtime.predict(ids), reps=3)
    total, ops = profile_device(lambda: runtime.predict(ids), reps=1)
    pre, _ = profile_device(prefill_only, reps=1)
    busy, pre_busy = sum(total.values()), sum(pre.values())
    flash = sum(t for k, t in pre.items() if "flash_fwd" in k)
    if busy > 0 and pre_busy > 0:
        device = (f"device_busy_ms={busy:.4f} idle_share={max(0.0, 1 - busy / wall):.3f} "
                  f"prefill_device_ms={pre_busy:.4f} flash_ms={flash:.4f} flash_share_of_prefill={flash / pre_busy:.3f} "
                  f"decode_device_ms_per_token={(busy - pre_busy) / (max_new - 1):.4f}")
    else:
        device = "device time: not measured (the profiler saw no device activity)"
    print(f"[{card}] gpt2_small_long_prompt breakdown request_wall_ms={wall:.3f} "
          f"device_ops_per_request={ops:g} {device}", flush=True)
    for name, t in sorted(pre.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    prefill {t:.4f} ms  {name[:110]}")


SPEC_OFF = {"decode_draft_model": "", "decode_spec_k": 0, "decode_spec_tree": "", "decode_spec_accept_floor": 0.0}


def _spec_stats(sched) -> dict:
    return dict(rounds=sched.stat_steps, spec_dispatches=sched.stat_spec_dispatches,
                proposed=sched.stat_spec_proposed, accepted=sched.stat_spec_accepted,
                emitted=sched.stat_spec_emitted, rides=sched.stat_spec_rides)


async def _spec_traffic(port: int, prompts, budgets) -> tuple[list, float]:
    """SPEC_REQUESTS staggered requests with their own max_new_tokens, the
    second one tagged spec_k=0 (opted out): (replies, wall seconds)."""
    async def one(i):
        await asyncio.sleep(0.004 * i)
        tags = {"max_new_tokens": budgets[i], **({"spec_k": 0} if i == 1 else {})}
        return await _ids_post(port, prompts[i : i + 1], tags)

    t0 = time.perf_counter()
    replies = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    return replies, time.perf_counter() - t0


def _served_rows(label: str, replies, budgets, seq: int) -> list:
    import numpy as np

    rows = []
    for (status, _, body, _), b in zip(replies, budgets):
        out = json.loads(body) if status == 200 else {}
        if status != 200 or out["meta"]["tags"]["gen_lens"] != [b]:
            raise AssertionError(f"{label} returned HTTP {status}: {body[:300]!r}")
        rows.append(np.asarray(out["data"]["ndarray"], np.int64)[0][: seq + b])
    return rows


def _hold_ids(label: str, rows, ref_rows, params, seq: int, dtype_name: str) -> list:
    """Each served row against its reference row under the tie rule; the tie
    rows as (request, generated index, gap)."""
    ties = []
    for r, (a, b) in enumerate(zip(rows, ref_rows)):
        ties += [(r, *t[1:]) for t in tie_rule(label, [a], [b[: len(a)]], params, seq, dtype_name)]
    return ties


def _spec_prompts(sched, vocab: int, seed: int = 9):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(SPEC_REQUESTS, sched.seq_len))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=SPEC_REQUESTS)]
    budgets[0] = sched.max_new_tokens  # one request runs the whole budget
    return prompts, budgets


async def serve_speculative(card, path: Path, check_only: bool = False) -> dict:
    """Phase 6, one deployment: SPEC_REQUESTS staggered requests (mixed
    budgets, one opted out) through REST, on the speculative server and on
    a copy with speculation off, in turns (spec, plain, plain, spec); every
    greedy row held to the plain scheduler's and to the fused generate's
    under the tie rule; one SSE stream against its buffered reply; no new
    dispatch key on either server; then the round's breakdown. Returns the
    numbers printed. ``check_only`` serves one spec and one plain run and
    skips the timings (the float32 copies)."""
    import numpy as np

    spec_srv, build_s, warmup_s = await _start(path)
    twin_srv, _, twin_warm = await _start(path, cuda_graphs=False)
    dep = json.loads(path.read_text())
    dep["spec"]["predictors"][0]["tpu"].update(SPEC_OFF)
    plain_path = ROOT / "build" / f"{path.stem}_plain.json"
    plain_path.parent.mkdir(exist_ok=True)
    plain_path.write_text(json.dumps(dep))
    plain_srv, _, _ = await _start(plain_path)
    sched, plain = spec_srv.decode_scheduler, plain_srv.decode_scheduler
    runtime = _model_runtime(spec_srv)
    dtype_name = str(runtime.dtype).removeprefix("torch.")
    label = f"{path.stem} ({dtype_name})"
    seq, vocab = sched.seq_len, runtime.params["tok_emb"].shape[0]
    prompts, budgets = _spec_prompts(sched, vocab)
    order = ("spec", "plain") if check_only else ("spec", "plain", "plain", "spec")
    runs = {"spec": [], "plain": []}
    try:
        for kind in order:
            srv = spec_srv if kind == "spec" else plain_srv
            before = _spec_stats(srv.decode_scheduler)
            replies, wall = await _spec_traffic(srv.port, prompts, budgets)
            after = _spec_stats(srv.decode_scheduler)
            runs[kind].append((replies, wall, {k: after[k] - before[k] for k in after}))
        twin_replies, twin_wall = await _spec_traffic(twin_srv.port, prompts, budgets)
        status, events = await _read_sse(spec_srv.port, prompts[:1])
        _, _, body, _ = await _ids_post(spec_srv.port, prompts[:1])
        buffered = np.asarray(json.loads(body)["data"]["ndarray"], np.int64)[0]
        recompiles = (sched.recompiles_since_warmup(), plain.recompiles_since_warmup(),
                      twin_srv.decode_scheduler.recompiles_since_warmup())
        breakdown = {} if check_only else spec_breakdown(card, sched, twin_srv.decode_scheduler, plain)
    finally:
        await spec_srv.stop()
        await plain_srv.stop()
        await twin_srv.stop()
    rows = _served_rows(label, runs["spec"][0][0], budgets, seq)
    hold_twin_rows(label, rows, _served_rows(f"{label} eager twin", twin_replies, budgets, seq))
    plain_rows = _served_rows(f"{label} plain", runs["plain"][0][0], budgets, seq)
    for replies, _, _ in runs["spec"][1:]:
        if any((a != b).any() for a, b in zip(_served_rows(label, replies, budgets, seq), rows)):
            raise AssertionError(f"{label}: two runs of the same greedy traffic served different ids")
    want = _fused_oracle(runtime, prompts)
    ties = {"plain_scheduler": _hold_ids(f"{label} vs the plain scheduler", rows, plain_rows, runtime.params, seq,
                                         dtype_name),
            "fused_generate": _hold_ids(f"{label} vs the fused generate", rows, want, runtime.params, seq,
                                        dtype_name)}
    tokens = [e["token"] for e in events if "token" in e]
    if tokens != buffered[seq:].tolist() or events[-1].get("ids") != [buffered.tolist()]:
        raise AssertionError(f"{label}: the SSE stream's tokens differ from the buffered reply")
    if recompiles != (0, 0, 0):
        raise AssertionError(f"{label}: new keys after warmup (spec, plain, eager twin): {recompiles}")
    st = runs["spec"][0][2]
    n_tok = sum(budgets)
    decode_tokens = n_tok - SPEC_REQUESTS  # each request's first token comes from its prompt's chunk round
    result = dict(
        deployment=path.stem, dtype=dtype_name, spec_k=sched.spec_k,
        tree=None if sched.spec_tree is None else ",".join(map(str, sched.spec_tree.branching)),
        requests=SPEC_REQUESTS, tokens=n_tok, rounds=st["rounds"], spec_rounds=st["spec_dispatches"],
        plain_rounds=runs["plain"][0][2]["rounds"],
        tokens_per_target_dispatch=decode_tokens / max(st["rounds"], 1),
        plain_tokens_per_target_dispatch=decode_tokens / max(runs["plain"][0][2]["rounds"], 1),
        accept_rate=st["accepted"] / max(st["proposed"], 1),
        mean_accepted_per_round=st["accepted"] / max(st["rides"], 1),
        ms_per_token=[w * 1e3 / n_tok for _, w, _ in runs["spec"]],
        plain_ms_per_token=[w * 1e3 / n_tok for _, w, _ in runs["plain"]],
        tie_rows=ties, sse_tokens=len(tokens), build_s=build_s, warmup_s=warmup_s,
        dispatch_keys=sched.compile_counts(), captures=sched.graphs.stat_captures,
        eager_rounds=sched.stat_eager_rounds, eager_twin_ms_per_token=twin_wall * 1e3 / n_tok,
        eager_twin_warmup_s=twin_warm,
        pool_bytes={"captured": spec_srv.warmup_reserved_bytes, "eager": twin_srv.warmup_reserved_bytes},
        **breakdown,
    )
    print(f"[{card}] speculative {json.dumps(result)}", flush=True)
    return result


def spec_breakdown(card, sched, twin, plain, reps: int = 20) -> dict:
    """One speculative round pair with every slot generating at its full
    limits (all-zero block tables: every pool write lands in junk page 0),
    captured and on the eager twin: host wall (the round ends in its
    readback), device busy, the draft's device time (its program alone;
    the verify's is the rest) and host share; and the plain step of the
    same model beside it."""
    import numpy as np
    import torch

    n, tree = sched.n_slots, sched.spec_tree
    z, zf = np.zeros(n, np.int32), np.zeros(n, np.float32)
    pos = np.full(n, sched.max_ctx - 1, np.int32)
    bt, limits = sched.pool.block_tables(), np.full(n, sched.spec_k, np.int32)
    wl = None if tree is None else np.tile(np.asarray(tree.branching, np.int32), (n, 1))

    def spec_round(s):
        s.pool.load_block_tables(bt)
        s._spec(z, pos, zf, z, limits, wl, 0)

    def draft_only(s):
        draft, _ = s._spec_entries(n)
        draft.load(z, pos)
        draft.replay()
        torch.cuda.synchronize()

    plain_bt = plain.pool.block_tables()  # no spec_k headroom: fewer pages per slot

    def plain_step():
        plain.pool.load_block_tables(plain_bt)
        plain._step(z, pos, zf, z, 0)

    row = {}
    with torch.inference_mode():
        for mode, s in (("", sched), ("eager_", twin)):
            wall = wall_ms(lambda: spec_round(s), reps)
            total, ops = profile_device(lambda: spec_round(s))
            draft, draft_ops = profile_device(lambda: draft_only(s))
            busy, draft_ms = sum(total.values()), sum(draft.values())
            row[f"{mode}round_wall_ms"] = wall
            if busy > 0 and draft_ms > 0:
                row.update({f"{mode}round_device_ms": busy, f"{mode}draft_device_ms": draft_ms,
                            f"{mode}verify_device_ms": busy - draft_ms, f"{mode}host_share": max(0.0, 1 - busy / wall),
                            f"{mode}device_ops_per_round": ops, f"{mode}draft_device_ops": draft_ops})
        row["plain_step_wall_ms"] = wall_ms(plain_step, reps)
        plain_busy, plain_ops = profile_device(plain_step)
    plain_ms = sum(plain_busy.values())
    if plain_ms > 0:
        row.update(plain_step_device_ms=plain_ms, plain_step_host_share=max(0.0, 1 - plain_ms / row["plain_step_wall_ms"]),
                   plain_step_device_ops=plain_ops)
    if "round_device_ms" not in row:
        row["device"] = "not measured (the profiler saw no device activity)"
    return row


async def spec_faults(card, matched: dict) -> dict:
    """Phase 6's planted faults, each served through REST on the tiny
    deployments (float32) and held to the fused generate:
    - a draft from another seed must leave every greedy id unchanged while
      the accept rate falls below the matched draft's (speculation cannot
      change greedy output);
    - an acceptance that keeps one draft token past the first mismatch must
      fail the id check;
    - a tree commit that writes a sibling's K/V in place of the accepted
      node's must fail the id check."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.spec_tree import SpecTree
    from seldon_core_tpu_torch.serving import decode_scheduler as ds

    real_accept, real_commit = ds.speculative_accept, ds.paged_tree_commit

    def accept_one_past(target_logits, drafts, draft_logits, limits, temps, topks, gen):
        out, acc = real_accept(target_logits, drafts, draft_logits, limits, temps, topks, gen)
        past = acc < limits.to(acc.dtype)  # a draft existed there and lost: keep it anyway
        rows = torch.arange(out.shape[0], device=out.device)
        bonus = out[rows, acc.long()]
        acc2 = acc + past.to(acc.dtype)
        out2 = torch.cat([drafts.to(out.dtype), torch.zeros_like(out[:, :1])], dim=1)
        out2[rows, acc2.long()] = bonus
        return out2, acc2

    def sibling_of(tree) -> "np.ndarray":
        """Each block's next sibling under its parent (itself where its
        depth has branching 1)."""
        sib = np.arange(tree.width)
        for p in range(tree.width):
            kids = [int(c) for c in tree.child_table[p] if c]
            for i, c in enumerate(kids):
                sib[c] = kids[(i + 1) % len(kids)]
        return sib

    # the served tree's sibling table, on the card before its server
    # captures the planted commit (a capture refuses an upload)
    tree_path = BASELINE_DIR / "tiny_gpt_tree_speculation.json"
    tree_text = json.loads(tree_path.read_text())["spec"]["predictors"][0]["tpu"]["decode_spec_tree"]
    sibling = torch.as_tensor(sibling_of(SpecTree.from_text(tree_text)), device=DEVICE)

    def commit_sibling(pool, bt, new_k, new_v, path_idx, positions, n_acc):
        return real_commit(pool, bt, new_k, new_v, sibling[path_idx.long()].to(path_idx.dtype), positions, n_acc)

    out = {}
    cases = [
        ("other_seed_draft", _deployment_copy("tiny_gpt_speculative",
                                              {"decode_draft_model": "zoo://draft?layers=1&resid_scale=0.1&seed=7"}),
         None, False),
        ("accept_one_past_mismatch", BASELINE_DIR / "tiny_gpt_speculative.json",
         planted(ds, "speculative_accept", accept_one_past), True),
        # a draft equal to the target (all 4 layers) accepts every path, so
        # the commit runs at every depth; at resid_scale 1 the target's
        # logits depend enough on the K/V it attends to that a sibling's
        # K/V changes its ids (at 0.1 they barely move)
        ("tree_commit_sibling_kv", _deployment_copy("tiny_gpt_tree_speculation",
                                                    {"decode_draft_model": "zoo://draft?layers=4"},
                                                    {"resid_scale": "1.0"}),
         planted(ds, "paged_tree_commit", commit_sibling), True),
    ]
    for name, path, fault, must_fail in cases:
        # planted before the server starts: its warmup captures the fault
        with fault or contextlib.nullcontext():
            server, _, _ = await _start(path)
            sched, runtime = server.decode_scheduler, _model_runtime(server)
            if sched.spec_tree is not None and sched.spec_tree.branching != SpecTree.from_text(tree_text).branching:
                raise AssertionError(f"{name}: serves tree {sched.spec_tree.branching}, the sibling table is for "
                                     f"{tree_text}")
            prompts, budgets = _spec_prompts(sched, runtime.params["tok_emb"].shape[0])
            try:
                before = _spec_stats(sched)
                replies, _ = await _spec_traffic(server.port, prompts, budgets)
                st = {k: v - before[k] for k, v in _spec_stats(sched).items()}
            finally:
                await server.stop()
        rows = _served_rows(name, replies, budgets, sched.seq_len)
        want = _fused_oracle(runtime, prompts)
        try:
            ties = _hold_ids(name, rows, want, runtime.params, sched.seq_len, "float32")
            failed, why = False, f"tie rows {ties}"
        except AssertionError as e:
            failed, why = True, str(e)
        rate = st["accepted"] / max(st["proposed"], 1)
        out[name] = dict(id_check_failed=failed, accept_rate=rate, rows_differing=sum(
            int((a != b[: len(a)]).any()) for a, b in zip(rows, want)), detail=why[:200])
        print(f"[{card}] planted fault {name}: {json.dumps(out[name])}", flush=True)
        if failed != must_fail:
            raise AssertionError(f"planted fault {name}: the id check {'passed' if must_fail else 'failed'}: {why}")
    if not out["other_seed_draft"]["accept_rate"] < matched["accept_rate"]:
        raise AssertionError(f"another seed's draft accepted as often as the matched one: "
                             f"{out['other_seed_draft']['accept_rate']} vs {matched['accept_rate']}")
    return out


async def serve_speculation(card) -> dict:
    """Phase 6: the three speculative deployments (and the GPT-2-small tree
    copy) through REST, the float32 copies, the planted faults. Returns the
    per-deployment numbers."""
    results = {}
    for name in ("tiny_gpt_speculative", "tiny_gpt_tree_speculation", "gpt2_small_speculative"):
        results[name] = await serve_speculative(card, BASELINE_DIR / f"{name}.json")
    tree_copy = _deployment_copy("gpt2_small_speculative", {"decode_spec_tree": "2,2,1,1"})
    results["gpt2_small_speculative_tree"] = await serve_speculative(card, tree_copy)
    # the GPT-2-small chain in float32 (TF32 off): ids held at the float32 margin
    f32 = _deployment_copy("gpt2_small_speculative", {"dtype": "float32"})
    results["gpt2_small_speculative_f32"] = await serve_speculative(card, f32, check_only=True)
    gpt2 = results["gpt2_small_speculative"]
    if gpt2["mean_accepted_per_round"] < SPEC_MIN_ACCEPTED:
        raise AssertionError(f"the GPT-2-small chain accepted {gpt2['mean_accepted_per_round']} draft tokens per "
                             f"round, want >= {SPEC_MIN_ACCEPTED}")
    results["faults"] = await spec_faults(card, results["tiny_gpt_speculative"])
    return results


def int8_weights(k: int, n: int, rng):
    """One quantized [k, n] weight (payload, scale) whose columns differ in
    magnitude, which is why the scheme keeps a scale per column."""
    import numpy as np

    from seldon_core_tpu_torch.models.quant import payload, quantize_params

    w = rng.standard_normal((k, n)) * np.exp(rng.uniform(-1.0, 1.0, n)) / np.sqrt(k)
    leaf = quantize_params({"w": w.astype(np.float32)})["w"]
    return payload(leaf), leaf["scale"]


def int8_bound(e, m, k, n, dtype_name, shared_x):
    """Least time for the call on an H100 SXM: x read once (once for all
    members when shared), each member's int8 payload, scales and bias read
    once and y written once at HBM rate, against 2*M*N*K operations per
    member at the activation dtype's peak."""
    elem = 4 if dtype_name == "float32" else 2
    nbytes = m * k * elem * (1 if shared_x else e) + e * (k * n + 4 * n + elem * n + elem * m * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * e * m * n * k / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_planted(x, q, s, b, k_tile: int) -> dict:
    """The plain version with a planted fault: scales applied per row (row k
    takes column k mod N's scale), or one K tile of x dropped (the second
    tile, or half of a K shorter than two tiles)."""
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import _batched_reference

    k, n = q.shape[1], q.shape[2]
    rows = torch.arange(k, device=q.device) % n
    per_row = (q.float() * s[:, rows][:, :, None]).to(x.dtype)
    t = max(1, min(k_tile, k // 2))
    keep = torch.ones(k, device=x.device, dtype=x.dtype)
    keep[t:2 * t] = 0
    return {
        "scale_per_row": torch.matmul(x, per_row) + b[:, None, :],
        "k_tile_dropped": _batched_reference(x * keep, q, s, b),
    }


def check_int8(case, card) -> dict:
    """One W8A16 kernel-vs-plain case on the card: x [E, M, K] (one x
    shared by the E members when ``shared``, as a fused ensemble's input
    is), E quantized [K, N] weights, a bias; E > 1 goes through the vmap
    rule, as graph fusion calls it. The call must launch once, on ``body``.
    Returns the case's numbers."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.int8_matmul import _batched_reference, int8_matmul

    name, (e, m, k, n), dtype, shared, body = case
    dtype_name = str(dtype).removeprefix("torch.")
    rng = np.random.default_rng(len(name) * 7919 + m + k + n)
    weights = [int8_weights(k, n, rng) for _ in range(e)]
    q = torch.from_numpy(np.stack([w for w, _ in weights])).cuda()
    s = torch.from_numpy(np.stack([sc for _, sc in weights])).reshape(e, n).cuda()
    b = torch.from_numpy(rng.standard_normal((e, n)).astype(np.float32) * 0.1).cuda().to(dtype)
    x1 = torch.from_numpy(rng.standard_normal((1 if shared else e, m, k)).astype(np.float32)).cuda().to(dtype)
    x = x1.expand(e, m, k)
    if e == 1:
        def call():
            return int8_matmul(x1[0], q[0], s[0], b[0])[None]
    else:
        fused = torch.func.vmap(int8_matmul, in_dims=(None if shared else 0, 0, 0, 0))

        def call():
            return fused(x1[0] if shared else x1, q, s, b)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # the plain version sums in f32
    try:
        before = {name_: c.count for name_, c in i8.LAUNCHES_BY_BODY.items()}
        out = call()
        torch.cuda.synchronize()
        launched = {name_: c.count - before[name_] for name_, c in i8.LAUNCHES_BY_BODY.items()}
        ref = _batched_reference(x, q, s, b)
        agree = agreement(out, ref, dtype_name)
        planted = {f: agreement(y, ref, dtype_name)
                   for f, y in int8_planted(x, q, s, b, INT8_K_TILE[dtype_name]).items()}
        w = (q.float() * s[:, None, :]).to(dtype)
        ms = device_ms(call)
        # the simple body on the same inputs, where the wgmma body served
        ms_mma = device_ms(lambda: i8._launch(x, q, s, b, body="mma")) if body == "wgmma" else None
        plain_ms = device_ms(lambda: _batched_reference(x, q, s, b))
        if e == 1:
            library_ms = device_ms(lambda: torch.addmm(b[0], x1[0], w[0]))
        else:
            library_ms = device_ms(lambda: torch.baddbmm(b[:, None, :], x, w))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    bound_ms, bound_by = int8_bound(e, m, k, n, dtype_name, shared)
    row = dict(
        case=name, shape=[e, m, k, n], dtype=dtype_name, shared_x=shared, body=body,
        max_abs_err=agree["max_abs_err"], atol=agree["atol"], rel_l2=agree["rel_l2"],
        rel_l2_limit=agree["rel_l2_limit"],
        planted_faults={f: dict(max_abs_err=a["max_abs_err"], rel_l2=a["rel_l2"], caught=not a["ok"])
                        for f, a in planted.items()},
        ms=ms, ms_mma=ms_mma, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
    )
    print(f"[{card}] int8_matmul {json.dumps(row)}", flush=True)
    if launched != {name_: int(name_ == body) for name_ in launched}:
        raise AssertionError(f"int8_matmul {name}: want one launch on the {body} body, got {launched}")
    if not agree["ok"]:
        raise AssertionError(f"int8_matmul {name}: kernel disagrees with its plain version: {agree}")
    for fault, a in planted.items():
        if a["ok"]:
            raise AssertionError(f"int8_matmul {name}: the check passes a planted fault ({fault}): {a}")
    return row


INT8_SHAPES = [  # name, (E, M, K, N), x shared by the members, the bf16 body
    # BERT-base's projections at bucket 32 x seq 128 (M = 4096), and its head
    ("qkv_b32", (1, 4096, 768, 2304), False, "wgmma"),
    ("attn_out_b32", (1, 4096, 768, 768), False, "wgmma"),
    ("mlp_in_b32", (1, 4096, 768, 3072), False, "wgmma"),
    ("mlp_out_b32", (1, 4096, 3072, 768), False, "wgmma"),
    ("head_b32", (1, 32, 768, 2), False, "mma"),
    # the same at bucket 1 (M = 128 rows, the head one)
    ("qkv_b1", (1, 128, 768, 2304), False, "wgmma"),
    ("attn_out_b1", (1, 128, 768, 768), False, "wgmma"),
    ("mlp_in_b1", (1, 128, 768, 3072), False, "wgmma"),
    ("mlp_out_b1", (1, 128, 3072, 768), False, "wgmma"),
    ("head_b1", (1, 1, 768, 2), False, "mma"),
    # iris: K = 4, N = 3, ragged everywhere
    ("iris", (1, 5, 4, 3), False, "mma"),
    # the wgmma body's edges: M % 128 != 0, K % 64 != 0, N % 128 != 0
    ("m_ragged", (1, 4000, 768, 2304), False, "wgmma"),
    ("k_ragged", (1, 256, 776, 768), False, "wgmma"),
    ("n_ragged", (1, 256, 768, 400), False, "wgmma"),
    # a fused ensemble of three members: the shared input, then per-member
    # rows; K = 776 ends mid-tile, where a read across a member's edge shows
    ("stacked_e3_shared_x", (3, 256, 768, 768), True, "wgmma"),
    ("stacked_e3", (3, 256, 768, 768), False, "wgmma"),
    ("stacked_e3_k776_shared_x", (3, 256, 776, 768), True, "wgmma"),
    ("stacked_e3_k776", (3, 256, 776, 768), False, "wgmma"),
]


def int8_kernel_checks(card) -> dict:
    """Phase 7b: every INT8_SHAPES case in bfloat16 and float32 (fma)."""
    import torch

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, shared, body in INT8_SHAPES:
            label = f"{name}_{str(dtype).removeprefix('torch.')}"
            body = body if dtype == torch.bfloat16 else "fma"
            rows[label] = check_int8((label, shape, dtype, shared, body), card)
    return rows


def int8_host_cost(card, calls: int = 200) -> dict:
    """Host microseconds per W8A16 call at the qkv bucket-32 shape (the
    whole wrapper: checks, body rule, ctypes, x's tensor map, launch) and
    torch.addmm on the pre-dequantized weights beside it.
    Medians of ``calls`` calls, no synchronisation inside the loop."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops.int8_matmul import int8_matmul

    qw, sc = int8_weights(768, 2304, np.random.default_rng(5))
    q, s = torch.from_numpy(qw).cuda(), torch.from_numpy(sc).reshape(-1).cuda()
    b = torch.zeros(2304, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(4096, 768, device="cuda").to(torch.bfloat16)
    w = (q.float() * s).to(torch.bfloat16)
    walls, lib_walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        int8_matmul(x, q, s, b)
        walls.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        torch.addmm(b, x, w)
        lib_walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(wrapper_us=med(walls), library_call_us=med(lib_walls))
    print(f"[{card}] int8_matmul host cost per call (4096, 768 -> 2304): {json.dumps(row)}", flush=True)
    return row


def param_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (int8 payloads and float32
    scales of quantized leaves included)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return 0


def int8_breakdown(card, label: str, runtime, ids) -> dict:
    """Host wall time of one served forward at the runtime's bucket (ids in,
    probabilities back on the host), the device's busy time inside it and
    the W8A16 kernel's part of that (torch.profiler), and the costliest
    kernels."""
    kernels, ops = profile_device(lambda: runtime.predict(ids))
    wall = wall_ms(lambda: runtime.predict(ids))
    busy = sum(kernels.values())
    int8 = sum(t for k, t in kernels.items() if any(b in k for b in ("wgmma_body", "mma_body", "fma_body")))
    row = dict(predict_wall_ms=wall, device_ops_per_forward=ops)
    if busy > 0:
        row.update(device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall), int8_kernel_ms=int8,
                   int8_share_of_busy=int8 / busy)
    print(f"[{card}] breakdown {label} rows={len(ids)} {json.dumps(row)}"
          + ("" if busy > 0 else " device time: not measured (the profiler saw no device activity)"), flush=True)
    for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {t:.4f} ms  {name[:110]}")
    return row


async def serve_bert_int8(card) -> int:
    """Phase 7c: the bert_int8 deployment (BERT-base, bf16, bucket 32, seq
    128, int8 weights) through REST: 49 W8A16 launches per forward, counted;
    its probabilities against the same seed's bf16 deployment without
    weight_quant (INT8_SERVE_ATOL) and against the port's int8 forward on
    the CPU (SERVE_ATOL, the first rows: the forward is row-independent);
    the parameter bytes each holds on the card; a profiler breakdown and the
    wall time at bucket 32. Returns the main path's launches, in all and
    by body."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.convert import params_to_numpy, params_to_torch
    from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload
    from seldon_core_tpu_torch.ops import int8_matmul as i8
    from seldon_core_tpu_torch.ops.int8_matmul import LAUNCHES as INT8

    server, build_s, warm_s = await _start(BASELINE_DIR / "bert_int8.json")
    runtime = _model_runtime(server)
    layers, seq = len(runtime.params["layers"]), runtime.feature_shape[0]
    table = runtime.params["tok_emb"]  # 30522 rows: above the rule's 8192, so not quantized
    vocab = (payload(table) if is_quantized_leaf(table) else table).shape[0]
    if not is_quantized_leaf(runtime.params["layers"][0]["qkv"]["w"]) or not is_quantized_leaf(runtime.params["head"]["w"]):
        raise AssertionError("bert_int8 holds float projections")
    print(f"[{card}] serve: bert_int8.json layers={layers} seq={seq} vocab={vocab} dtype={runtime.dtype} "
          f"buckets={runtime.buckets} build_s={build_s:.3f} warmup_s={warm_s:.3f}", flush=True)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, vocab, size=(n, seq)) for n in (32, 5, 32)]
    served, deltas, body_deltas, latencies = [], [], [], []
    try:
        i8.reset_launches()  # the main path's run starts here
        for ids in batches:
            before = INT8.count
            by_body = {body: c.count for body, c in i8.LAUNCHES_BY_BODY.items()}
            status, out, ms = await _post(server.port, json.dumps({"data": {"ndarray": ids.tolist()}}).encode())
            if status != 200:
                raise AssertionError(f"bert_int8 predict returned HTTP {status}: {out}")
            served.append(_check_probs(out, len(ids)))
            deltas.append(INT8.count - before)
            body_deltas.append({body: c.count - by_body[body] for body, c in i8.LAUNCHES_BY_BODY.items()})
            latencies.append(ms)
        main_launches = INT8.count  # ... and ends here
        main_by_body = {body: c.count for body, c in i8.LAUNCHES_BY_BODY.items()}
    finally:
        await server.stop()
    for ids, ms, delta, by_body in zip(batches, latencies, deltas, body_deltas):
        print(f"[{card}] request bert_int8 batch={len(ids)} latency_ms={ms:.3f} int8_launches={delta} "
              f"by_body={json.dumps(by_body)}", flush=True)
    require_launches("bert_int8 int8_matmul", deltas, INT8_LAUNCHES)
    if body_deltas != [INT8_LAUNCHES_BY_BODY] * len(batches):
        raise AssertionError(f"int8_matmul launches per body and request {body_deltas}, "
                             f"want {INT8_LAUNCHES_BY_BODY} each")

    bf16_server, *_ = await _start(_deployment_copy("bert_int8", {"weight_quant": ""}))
    bf16 = _model_runtime(bf16_server)
    await bf16_server.stop()
    vs_bf16 = max(float(np.abs(p - bf16.predict(ids)).max()) for ids, p in zip(batches, served))
    cpu_rows = 4
    cpu_params = params_to_torch(params_to_numpy(runtime.params), torch.device("cpu"), runtime.dtype)
    with torch.inference_mode():
        cpu_ids = torch.from_numpy(batches[0][:cpu_rows].astype(np.int32))
        on_cpu = runtime.apply_fn(cpu_params, cpu_ids).float().numpy()
    del cpu_params
    vs_cpu = float(np.abs(served[0][:cpu_rows] - on_cpu).max())
    resident = {"int8": param_bytes(runtime.params), "bf16": param_bytes(bf16.params)}
    print(f"[{card}] bert_int8 vs the bf16 deployment: max_abs_diff={vs_bf16} (atol {INT8_SERVE_ATOL}); "
          f"vs the int8 forward on the CPU ({cpu_rows} rows): {vs_cpu} (atol {SERVE_ATOL})", flush=True)
    print(f"[{card}] bert_int8 parameter bytes on the card: {json.dumps(resident)} "
          f"ratio={resident['int8'] / resident['bf16']:.4f}", flush=True)
    if vs_bf16 > INT8_SERVE_ATOL or vs_cpu > SERVE_ATOL:
        raise AssertionError(f"bert_int8 disagrees: vs bf16 {vs_bf16}, vs the CPU {vs_cpu}")
    if resident["int8"] >= resident["bf16"]:
        raise AssertionError(f"int8 parameters take no fewer bytes than bf16: {resident}")
    ids32 = batches[0]
    int8_row = int8_breakdown(card, "bert_int8", runtime, ids32)
    bf16_row = int8_breakdown(card, "bert_int8 without weight_quant (bf16)", bf16, ids32)
    print(f"[{card}] bert_int8 bucket 32 wall: int8 {int8_row['predict_wall_ms']:.3f} ms, bf16 "
          f"{bf16_row['predict_wall_ms']:.3f} ms", flush=True)
    del bf16
    return main_launches, main_by_body


def _iris_primary_as_root() -> Path:
    """iris_fallback_breaker with its breakered primary as the whole graph:
    no router above it, so no fallback."""
    dep = json.loads((BASELINE_DIR / "iris_fallback_breaker.json").read_text())
    pred = dep["spec"]["predictors"][0]
    pred["graph"] = pred["graph"]["children"][0]
    path = ROOT / "build" / "iris_fallback_breaker_primary_only.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(dep))
    return path


async def serve_resilience(card) -> dict:
    """Phase 7d: iris_fallback_breaker on the card, as the example stands,
    with faults installed on its primary: a failing primary is served by the
    fallback (200, degraded, routing restamped) and opens its breaker; a
    hang is cut by a 50 ms deadline tag (504, code 304); a breakered node
    without a fallback answers 500 (code 103), then 503 (code 305) with
    Retry-After; with batch_across_requests false, concurrent requests walk
    one each."""
    import numpy as np

    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults

    path = BASELINE_DIR / "iris_fallback_breaker.json"
    body = json.dumps({"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}).encode()
    results = {}

    server, *_ = await _start(path)
    try:
        sched = install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        replies = [await _post(server.port, body) for _ in range(4)]
        breaker = server.executor.breaker_for("iris-primary").state
    finally:
        await server.stop()
    for status, out, _ in replies:
        if status != 200 or out["meta"]["tags"].get("degraded") != "router_fallback" \
                or out["meta"]["routing"] != {"router": 1}:
            raise AssertionError(f"a failing primary was not served by the fallback: {status} {out}")
        _check_probs(out, 1, classes=3)
    if sched["iris-primary"].calls != 5 or breaker != "open":
        raise AssertionError(f"primary calls {sched['iris-primary'].calls} (want 5), breaker {breaker} (want open)")
    results["fallback"] = dict(statuses=[r[0] for r in replies], ms=[r[2] for r in replies],
                               primary_calls=sched["iris-primary"].calls, breaker=breaker)

    server, *_ = await _start(path)
    try:
        # a 2 s hang: the deadline answers at 50 ms; the merged batch walk
        # it was cut from runs on until the hang ends, and stop() waits
        install_faults(server.executor, {"iris-primary": FaultSpec(timeout_rate=1.0, hang_s=2.0, seed=5)})
        tagged = json.dumps({"meta": {"tags": {"deadline_ms": 50}},
                             "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}).encode()
        status, out, ms = await _post(server.port, tagged)
    finally:
        await server.stop()
    if (status, out.get("code")) != (504, 304):
        raise AssertionError(f"a hang under a 50 ms deadline answered {status} {out}")
    results["deadline"] = dict(status=status, code=out["code"], ms=ms)

    server, *_ = await _start(_iris_primary_as_root())
    try:
        install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        first = await _request(server.port, body)
        second = await _request(server.port, body)
    finally:
        await server.stop()
    got = [(r[0], json.loads(r[2])["code"]) for r in (first, second)]
    if got != [(500, 103), (503, 305)] or int(second[1].get("retry-after", "0")) < 1:
        raise AssertionError(f"a breakered node without fallback answered {got}, headers {second[1]}")
    results["no_fallback"] = dict(replies=got, retry_after=second[1]["retry-after"])

    for across in (True, False):
        server, *_ = await _start(_deployment_copy("iris_fallback_breaker", {"batch_across_requests": across}))
        try:
            sched = install_faults(server.executor, {"iris-primary": FaultSpec()})
            bodies = [json.dumps({"data": {"ndarray": [[float(i), 3.5, 1.4, 0.2]]}}).encode() for i in range(8)]
            replies = await asyncio.gather(*(_post(server.port, b) for b in bodies))
            walks, batcher = sched["iris-primary"].calls, server.batcher is not None
        finally:
            await server.stop()
        if any(r[0] != 200 for r in replies):
            raise AssertionError(f"batch_across_requests={across}: {[r[0] for r in replies]}")
        if not across and (walks != 8 or batcher):
            raise AssertionError(f"batch_across_requests false walked {walks} times for 8 requests (batcher {batcher})")
        results[f"batch_across_requests_{str(across).lower()}"] = dict(requests=8, primary_calls=walks)
    print(f"[{card}] iris_fallback_breaker: {json.dumps(results)}", flush=True)
    return results


# ------------------------------------------------ captured against eager
# Every runtime and decode scheduler serves its dispatch keys as captured
# CUDA graphs (seldon_core_tpu_torch/ops/graphs.py); the eager twin
# (cuda_graphs=False) runs the same keys eagerly on the same static buffers.
# The same kernels run with the same launch configurations either way, so
# the twins must agree bit for bit, and the launch counters (credited per
# replay on the captured side) must read the same.
LOAD_SECONDS = 1.5  # per load point
LOAD_USERS = (8, 16, 32)  # the saturating point: the first whose successor rises <= 10%
LOAD_RISE = 1.10
LOAD_WORKERS = 2  # client processes of a multi-user point


def _runtimes(server) -> list:
    """(node name, runtime) of every model node of a server's graph."""
    return [(n.name, n.unit.runtime) for n in server.executor.root.walk()
            if getattr(n.unit, "runtime", None) is not None]


def _launch_counts() -> dict:
    from seldon_core_tpu_torch.ops import flash_attention, int8_matmul

    return {"flash_attention": flash_attention.LAUNCHES.count, "int8_matmul": int8_matmul.LAUNCHES.count,
            **{f"int8_{b}": c.count for b, c in int8_matmul.LAUNCHES_BY_BODY.items()}}


def _launches_of(fn) -> dict:
    """The kernel launches ``fn`` made (on a captured path: the launches
    its replays credited), by counter, zeros left out."""
    before = _launch_counts()
    fn()
    return {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}


def _twin_input(runtime, n: int, wire, rng):
    import numpy as np

    from seldon_core_tpu_torch.models.quant import is_quantized_leaf, payload

    shape = tuple(runtime.feature_shape)
    if wire == np.int32:
        table = runtime.params["tok_emb"]
        vocab = (payload(table) if is_quantized_leaf(table) else table).shape[0]
        return rng.integers(0, vocab, size=(n, *shape)).astype(np.int32)
    if wire == np.uint8:
        return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)
    return rng.uniform(0, 8, size=(n, *shape)).astype(np.float32)


def _wires(runtime) -> list:
    import numpy as np

    if runtime.int_inputs == "ids":
        return [np.int32]
    return [np.float32, np.uint8] if runtime._uint8_wire() else [np.float32]


def _modes_breakdown(card, label: str, fns: dict, unit: str, reps: int = 5) -> dict:
    """Host wall and device busy time of one call of each mode's ``fn``
    (which must end on the host), and the host share."""
    out = {}
    for mode, fn in fns.items():
        wall = wall_ms(fn, reps)
        kernels, ops = profile_device(fn)
        busy = sum(kernels.values())
        row = dict(wall_ms=wall, device_ops=ops)
        if busy > 0:
            row.update(device_ms=busy, host_share=max(0.0, 1 - busy / wall))
        out[mode] = row
        print(f"[{card}] {label} {unit} mode={mode} {json.dumps(row)}"
              + ("" if busy > 0 else " device time: not measured (the profiler saw no device activity)"), flush=True)
    return out


def check_twin_runtimes(card, label: str, cap, eager, kernels: tuple = ()) -> dict:
    """Every runtime of the captured server against its eager twin: at
    every bucket and wire dtype the same rows bit for bit and the same
    kernel launches (the captured side's credited by its replays; a kernel
    in ``kernels`` must launch on both, so a captured path that reports 0
    fails here); each key one captured graph; the forward's wall and device
    time at the smallest and largest bucket in both modes."""
    import numpy as np

    rng = np.random.default_rng(11)
    rows = {}
    for (node, rc), (_, re) in zip(_runtimes(cap), _runtimes(eager)):
        if not rc.graphs.capture or re.graphs.capture:
            raise AssertionError(f"{label}/{node}: the captured server does not capture or its twin does")
        if rc.graphs.stat_captures != sum(rc.compile_counts().values()):
            raise AssertionError(f"{label}/{node}: {rc.graphs.stat_captures} captures for keys {rc.compile_counts()}")
        launches = {}
        for b in rc.buckets:
            for wire in _wires(rc):
                x = _twin_input(rc, b, wire, rng)
                got = {}
                per = {mode: _launches_of(lambda rt=rt, mode=mode: got.__setitem__(mode, rt.predict(x)))
                       for mode, rt in (("captured", rc), ("eager", re))}
                if not np.array_equal(got["captured"], got["eager"]):
                    diff = float(np.abs(got["captured"].astype(np.float64) - got["eager"]).max())
                    raise AssertionError(f"{label}/{node} bucket {b} {np.dtype(wire).name}: captured rows differ "
                                         f"from the eager twin's (max abs {diff})")
                if per["captured"] != per["eager"]:
                    raise AssertionError(f"{label}/{node} bucket {b}: replays credited {per['captured']}, the eager "
                                         f"twin launched {per['eager']}")
                for k in kernels:
                    if per["captured"].get(k, 0) <= 0:
                        raise AssertionError(f"{label}/{node} bucket {b}: the captured path reports 0 {k} launches "
                                             "(its replays credit none)")
                launches[b] = per["captured"]
        print(f"[{card}] twins {label}/{node}: buckets={list(rc.buckets)} wires="
              f"{[np.dtype(w).name for w in _wires(rc)]} captured rows equal to the eager twin's bit for bit; "
              f"launches per forward (credited by replays) {json.dumps(launches)}; compile_counts "
              f"{rc.compile_counts()} captures={rc.graphs.stat_captures} replays={rc.graphs.stat_replays}", flush=True)
        for b in sorted({rc.buckets[0], rc.buckets[-1]}):
            x = _twin_input(rc, b, _wires(rc)[-1], rng)
            rows[f"{node}_b{b}"] = _modes_breakdown(
                card, f"twins {label}/{node} bucket={b}",
                {"captured": lambda: rc.predict(x), "eager": lambda: re.predict(x)}, "forward")
    return rows


async def _load_point(port: int, users: int, load: dict) -> dict:
    """One closed-loop load point from the port's load generator, run as
    its CLI in other processes so the server keeps its own."""
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.tools.loadtest", f"http://127.0.0.1:{port}",
           "--users", str(users), "--duration", str(LOAD_SECONDS), "--workers", str(1 if users == 1 else LOAD_WORKERS),
           "--static-payload", "--json", "--payload", load["payload"]]
    shape = load["features"]
    cmd += ["--features", str(shape)] if isinstance(shape, int) else ["--shape", ",".join(map(str, shape))]
    proc = await asyncio.create_subprocess_exec(*cmd, stdout=asyncio.subprocess.PIPE,
                                                stderr=asyncio.subprocess.PIPE, cwd=str(ROOT))
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout=120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"loadtest exited {proc.returncode}: {err.decode()[-500:]}")
    summary = json.loads(out.decode().strip().splitlines()[-1])
    if summary["errors"] or summary["requests"] <= 0:
        raise AssertionError(f"loadtest at {users} users: {summary}")
    return summary


async def load_curve(card, label: str, mode: str, port: int, load: dict) -> dict:
    """1 user (latency), then 8, 16 and 32 users until predictions/s stops
    rising by more than 10%: the last point that rose is the saturating
    one."""
    points = {1: await _load_point(port, 1, load)}
    print(f"[{card}] load {label} mode={mode} users=1 {json.dumps(points[1])}", flush=True)
    sat = None
    for users in LOAD_USERS:
        points[users] = await _load_point(port, users, load)
        print(f"[{card}] load {label} mode={mode} users={users} {json.dumps(points[users])}", flush=True)
        if sat is not None and points[users]["requests_per_sec"] <= LOAD_RISE * points[sat]["requests_per_sec"]:
            break
        sat = users
    return {"users_1": points[1], "saturation": {"users": sat, **points[sat]}}


async def serve_twins(card, path: Path, kernels: tuple = (), load: dict | None = None) -> dict:
    """One deployment served captured and as its eager twin: the runtimes
    held together (``check_twin_runtimes``), then, with ``load``, each
    server driven by the port's load generator; no new key on either
    after the traffic; the graph pool's bytes."""
    label = path.stem
    cap, build_s, cap_warm = await _start(path)
    eager, _, eager_warm = await _start(path, cuda_graphs=False)
    try:
        breakdown = check_twin_runtimes(card, label, cap, eager, kernels)
        curves = {}
        if load is not None:
            for mode, srv in (("captured", cap), ("eager", eager)):
                curves[mode] = await load_curve(card, label, mode, srv.port, load)
    finally:
        await cap.stop()
        await eager.stop()
    recompiles = {f"{mode}/{node}": rt.recompiles_since_warmup() for mode, srv in (("captured", cap), ("eager", eager))
                  for node, rt in _runtimes(srv)}
    pool = {"captured": cap.warmup_reserved_bytes, "eager": eager.warmup_reserved_bytes}
    print(f"[{card}] twins {label}: warmup_s captured={cap_warm:.3f} eager={eager_warm:.3f} build_s={build_s:.3f} "
          f"warmup memory_reserved growth bytes {json.dumps(pool)} recompiles_since_warmup after the traffic "
          f"{json.dumps(recompiles)}", flush=True)
    if any(recompiles.values()):
        raise AssertionError(f"{label}: new keys after warmup: {recompiles}")
    summary = {"pool_bytes": pool, "breakdown": breakdown}
    if curves:
        summary["load"] = {mode: {"p50_ms_1_user": c["users_1"]["p50_ms"], "p99_ms_1_user": c["users_1"]["p99_ms"],
                                  "saturating_users": c["saturation"]["users"],
                                  "predictions_per_s": c["saturation"]["requests_per_sec"],
                                  "p50_ms": c["saturation"]["p50_ms"], "p99_ms": c["saturation"]["p99_ms"]}
                           for mode, c in curves.items()}
        print(f"[{card}] load {label} summary {json.dumps(summary['load'])}", flush=True)
    return summary


async def baseline_twins(card) -> dict:
    """Phase 4d: the five BASELINE deployments captured against their eager
    twins, and under load (JSON bodies; the ResNet ensemble uint8 npy, the
    wire it serves)."""
    loads = {
        "iris": {"payload": "json", "features": 4},
        "mnist": {"payload": "json", "features": 784},
        "iris_abtest": {"payload": "json", "features": 4},
        "resnet_ensemble": {"payload": "npy", "features": (224, 224, 3)},
        "full_dag_bert": {"payload": "json", "features": 128},
    }
    return {name: await serve_twins(card, BASELINE_DIR / f"{name}.json",
                                    ("flash_attention",) if name == "full_dag_bert" else (), load)
            for name, load in loads.items()}


# ------------------------------------------------------ phase 8: telemetry
# Every server of phases 3-7 runs with telemetry at its defaults (tracing,
# metrics and the flight recorder on). Phase 8 reads what it recorded:
# request traces, /metrics, the decode flight frames and the profiler,
# each check shown to fail on a planted fault, and prints the split of a
# served request, the decode round's host phases and telemetry's cost.
TRACE_REQUESTS = 50
TELEMETRY_LOAD_USERS = 16  # at or past the saturating point of iris and the DAG (PERF.md)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def metric_samples(text: str) -> dict:
    """Prometheus 0.0.4 text -> {(sample name, sorted label pairs): value}
    (the card's host has no prometheus_client to parse it)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        out[(name, tuple(sorted(_LABEL_RE.findall(labels))))] = float(value)
    return out


def metric_total(samples: dict, name: str, **labels) -> float:
    return sum(v for (n, ls), v in samples.items() if n == name and all((k, v2) in ls for k, v2 in labels.items()))


async def _get(port: int, path: str):
    status, _, body, _ = await _request(port, b"", path=path, method="GET")
    if status != 200:
        raise AssertionError(f"GET {path} answered {status}: {body[:300]!r}")
    return body


def _traceparent(name: str, i: int) -> tuple[str, str, str]:
    """Request ``i``'s header: a trace id of its own (fragments under one
    trace id merge in the store) and a caller's span id."""
    import zlib

    trace_id, parent = f"{zlib.crc32(name.encode()):08x}{i + 1:024x}", f"{0xa11ce + i:016x}"
    return f"00-{trace_id}-{parent}-01", trace_id, parent


def expected_calls(node, routing: dict) -> list:
    """The unit calls a request's walk makes, from the graph and its
    routing: ``name.method`` per call, in walk order."""
    from seldon_core_tpu_torch.engine.executor import _has_method
    from seldon_core_tpu_torch.graph.spec import PredictiveUnitMethod as M

    calls = []
    if _has_method(node, M.TRANSFORM_INPUT):
        calls.append(f"{node.name}.transform_input")
    if node.children:
        if _has_method(node, M.ROUTE):
            calls.append(f"{node.name}.route")
        branch = routing.get(node.name, -1)
        for c in (node.children if branch < 0 else [node.children[branch]]):
            calls += expected_calls(c, routing)
        if _has_method(node, M.AGGREGATE):
            calls.append(f"{node.name}.aggregate")
    if _has_method(node, M.TRANSFORM_OUTPUT):
        calls.append(f"{node.name}.transform_output")
    return calls


def check_trace(rec: dict, trace_id: str, parent: str, calls: list) -> dict:
    """A served request's span tree: an ingress root continuing the header
    (its trace id, parented to its span), one batcher child, one unit span
    per unit call under the batcher, every child inside its parent's
    interval. Returns the request's split in ms."""
    spans = rec["trace"]
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "ingress"]
    if rec["trace_id"] != trace_id or len(roots) != 1 or roots[0]["parent_id"] != parent:
        raise AssertionError(f"trace {rec['trace_id']}: want one ingress root continuing {trace_id}/{parent}")
    root = roots[0]
    batchers = [s for s in spans if s["name"] == "batcher"]
    if len(batchers) != 1 or batchers[0]["parent_id"] != root["span_id"]:
        raise AssertionError(f"trace {trace_id}: {len(batchers)} batcher spans, want one under the root")
    batcher = batchers[0]
    units = [s for s in spans if "unit" in s.get("attrs", {}) and "method" in s.get("attrs", {})]
    if sorted(s["name"] for s in units) != sorted(calls) or any(s["parent_id"] != batcher["span_id"] for s in units):
        raise AssertionError(f"trace {trace_id}: unit spans {[s['name'] for s in units]}, want {calls} under the "
                             f"batcher")
    if len(spans) != 2 + len(units):
        raise AssertionError(f"trace {trace_id}: {len(spans)} spans, want {2 + len(units)}")
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is not None and not (p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]):
            raise AssertionError(f"trace {trace_id}: span {s['name']} leaves its parent {p['name']}'s interval")
    children = sum(s["end_ns"] - s["start_ns"] for s in spans if s["parent_id"] == root["span_id"])
    return {"root_ms": root["ms"], "batcher_ms": batcher["ms"],
            "queue_wait_ms": batcher["attrs"]["queue_wait_ms"],
            "ingress_self_ms": (root["end_ns"] - root["start_ns"] - children) / 1e6,
            **{f"unit {s['name']}": s["ms"] for s in units}}


def check_delta(label: str, before: dict, after: dict, name: str, want: float, **labels) -> None:
    got = metric_total(after, name, **labels) - metric_total(before, name, **labels)
    if got != want:
        raise AssertionError(f"{label}: {name}{labels} moved by {got}, want {want}")


def check_flight(label: str, frames: list, tokens: int, requests: int) -> None:
    """The frames of a decode run total what was served: tokens, and one
    admission and one retirement per request."""
    got = (sum(f["tokens"] for f in frames), sum(f.get("admitted", 0) for f in frames),
           sum(f.get("retired", 0) for f in frames))
    if got != (tokens, requests, requests):
        raise AssertionError(f"{label}: flight frames total (tokens, admitted, retired) {got}, "
                             f"want {(tokens, requests, requests)}")


def must_fail(label: str, fn) -> None:
    """A planted fault: the check must raise."""
    try:
        fn()
    except AssertionError:
        return
    raise AssertionError(f"planted fault passed its check: {label}")


def _mean(rows: list) -> dict:
    """Per key, the mean over the rows that have it (a routed arm's span
    over the requests routed to it)."""
    keys = sorted({k for r in rows for k in r})
    return {k: round(sum(r[k] for r in rows if k in r) / sum(k in r for r in rows), 4) for k in keys}


async def serve_traces(card, name: str) -> dict:
    """Phase 8a: TRACE_REQUESTS one-row requests, each with its own
    traceparent header and the ``trace`` tag (a trace continuing a caller's
    header is kept only when flagged: the reference's tail sampling), one
    after another; each GET /traces/{puid} held by ``check_trace``;
    /metrics: the ingress count rises by the requests, each unit call's
    count by the requests that made it; on the DAG one feedback moves
    ``seldon_api_model_feedback``. Returns the mean split."""
    import numpy as np

    server, *_ = await _start(BASELINE_DIR / f"{name}.json")
    rt = _runtimes(server)[0][1]
    rng = np.random.default_rng(12)
    dep, pred = server.deployment_name, server.predictor.name
    splits, calls_made = [], {}
    try:
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        last = None
        for i in range(TRACE_REQUESTS):
            header, trace_id, parent = _traceparent(name, i)
            ids = rng.integers(0, rt.params["tok_emb"].shape[0], size=(1, rt.feature_shape[0]))
            body = {"meta": {"puid": f"{name}-trace-{i}", "tags": {"trace": 1}}, "data": {"ndarray": ids.tolist()}}
            status, _, out, client_ms = await _request(server.port, json.dumps(body).encode(),
                                                       headers={"traceparent": header})
            if status != 200:
                raise AssertionError(f"{name} traced request answered {status}: {out[:300]!r}")
            last = json.loads(out)
            calls = expected_calls(server.executor.root, last["meta"].get("routing", {}))
            for c in calls:
                calls_made[c] = calls_made.get(c, 0) + 1
            rec = json.loads(await _get(server.port, f"/traces/{name}-trace-{i}"))
            split = check_trace(rec, trace_id, parent, calls)
            # what the client waited beyond the root span: the HTTP parse,
            # the JSON codecs outside the service, the event loop's turns
            splits.append({**split, "client_ms": client_ms, "outside_root_ms": client_ms - split["root_ms"]})
        if name == "full_dag_bert":
            fb = json.dumps({"response": last, "reward": 1.0}).encode()
            status, _, out, _ = await _request(server.port, fb, path="/api/v0.1/feedback")
            if status != 200:
                raise AssertionError(f"feedback answered {status}: {out[:200]!r}")
        after = metric_samples((await _get(server.port, "/metrics")).decode())
        recompiles = {n: r.recompiles_since_warmup() for n, r in _runtimes(server)}
    finally:
        await server.stop()
    if any(recompiles.values()):
        raise AssertionError(f"{name}: new keys after warmup with telemetry on: {recompiles}")
    ingress = "seldon_api_ingress_server_requests_duration_seconds_count"
    unit = "seldon_api_engine_client_requests_duration_seconds_count"
    check_delta(name, before, after, ingress, TRACE_REQUESTS, deployment_name=dep, method="predict")
    for call, n in calls_made.items():
        node, method = call.rsplit(".", 1)
        check_delta(name, before, after, unit, n, deployment_name=dep, predictor_name=pred, model_name=node,
                    method=method)
    if name == "full_dag_bert":
        router = server.executor.root.children[0].name
        check_delta(name, before, after, "seldon_api_model_feedback_total", 1, model_name=router)
        check_delta(name, before, after, ingress, 1, method="feedback")
    # planted faults: a dropped span, a metric off by one
    rec = json.loads(json.dumps(rec))
    _, trace_id, parent = _traceparent(name, TRACE_REQUESTS - 1)
    for drop in ("batcher", calls[-1]):
        cut = dict(rec, trace=[s for s in rec["trace"] if s["name"] != drop])
        must_fail(f"{name}: trace without its {drop} span", lambda: check_trace(cut, trace_id, parent, calls))
    must_fail(f"{name}: ingress count off by one", lambda: check_delta(
        name, before, after, ingress, TRACE_REQUESTS + 1, deployment_name=dep, method="predict"))
    split = _mean(splits)
    print(f"[{card}] telemetry {name} bucket 1: {TRACE_REQUESTS} traces held (root continues the header, one "
          f"batcher, one span per unit call {sorted(calls_made)}, children inside parents); /metrics ingress "
          f"+{TRACE_REQUESTS}, unit calls {json.dumps(calls_made)}; mean split ms {json.dumps(split)}", flush=True)
    return split


async def telemetry_faults(card) -> dict:
    """Phase 8b: iris_fallback_breaker with a failing primary (phase 7's
    traffic, each request traced): retries equal the traces' retry events,
    injected faults the fault schedule's calls, one degraded response per
    request, the breaker open."""
    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults

    server, *_ = await _start(BASELINE_DIR / "iris_fallback_breaker.json")
    dep = server.deployment_name
    retry_events = 0
    try:
        sched = install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        for i in range(4):
            body = {"meta": {"puid": f"faults-{i}", "tags": {"trace": 1}}, "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}
            status, out, _ = await _post(server.port, json.dumps(body).encode())
            if status != 200 or out["meta"]["tags"].get("degraded") != "router_fallback":
                raise AssertionError(f"a failing primary was not served by the fallback: {status} {out}")
            rec = json.loads(await _get(server.port, f"/traces/faults-{i}"))
            retry_events += sum(e["name"] == "retry" for s in rec["trace"] for e in s.get("events", []))
        after = metric_samples((await _get(server.port, "/metrics")).decode())
        calls = sched["iris-primary"].calls
    finally:
        await server.stop()
    check_delta("faults", before, after, "seldon_tpu_retries_total", retry_events, deployment_name=dep,
                model_name="iris-primary")
    check_delta("faults", before, after, "seldon_tpu_faults_injected_total", calls, deployment_name=dep,
                model_name="iris-primary", kind="error")
    check_delta("faults", before, after, "seldon_tpu_degraded_responses_total", 4, deployment_name=dep,
                mode="router_fallback")
    check_delta("faults", before, after, "seldon_tpu_breaker_transitions_total", 1, deployment_name=dep,
                endpoint="iris-primary", state="open")
    state = metric_total(after, "seldon_tpu_breaker_state", deployment_name=dep, endpoint="iris-primary")
    if state != 2 or retry_events == 0:
        raise AssertionError(f"breaker state gauge {state} (want 2 = open), retry events {retry_events}")
    must_fail("faults: degraded off by one", lambda: check_delta(
        "faults", before, after, "seldon_tpu_degraded_responses_total", 5, deployment_name=dep,
        mode="router_fallback"))
    out = {"retries": retry_events, "faults": calls, "degraded": 4, "breaker_state": state}
    print(f"[{card}] telemetry faults iris_fallback_breaker: {json.dumps(out)}", flush=True)
    return out


def phase_split(frames: list) -> dict:
    """Per round, from /decode/flight frames: wall, busy and gap; enqueue and
    readback per family; the gap by phase, each as ms and as a share of the
    round's wall."""
    n = len(frames)
    fam = {}
    for f in frames:
        for k, v in f.get("busy_us", {}).items():
            fam.setdefault(k, [0.0, 0.0])[0] += v
        for k, v in f.get("rdb_us", {}).items():
            fam.setdefault(k, [0.0, 0.0])[1] += v
    busy = sum(v[0] for v in fam.values()) / n / 1e3
    gap = sum(f["gap_us"] for f in frames) / n / 1e3
    wall = busy + gap
    phases = {}
    for f in frames:
        for k, v in f.get("phase_us", {}).items():
            phases[k] = phases.get(k, 0.0) + v
    modes = {}
    for f in frames:
        modes[f["mode"]] = modes.get(f["mode"], 0) + 1
    return {
        "rounds": n, "modes": modes, "wall_ms": round(wall, 4), "busy_ms": round(busy, 4), "gap_ms": round(gap, 4),
        "families_ms": {k: {"enqueue": round((b - r) / n / 1e3, 4), "readback": round(r / n / 1e3, 4)}
                        for k, (b, r) in fam.items()},
        "phases_ms": {k: round(v / n / 1e3, 4) for k, v in sorted(phases.items(), key=lambda kv: -kv[1])},
        "phase_share_of_wall": {k: round(v / n / 1e3 / wall, 4) for k, v in phases.items()} if wall else {},
    }


async def _frames_of(port: int, name: str, since: int) -> list:
    rep = json.loads(await _get(port, "/decode/flight?n=4096"))["recorders"][name]
    return [f for f in rep["frames"] if f["seq"] >= since]


async def decode_phases(card, name: str, traffic, sched, port: int, dep: str) -> dict:
    """The round split of ``traffic`` with ENGINE_FLIGHT_SYNC_TIMING off,
    then on (a synchronize after every dispatch: each family's enqueue
    column is then the device's wall)."""
    out = {}
    for sync in (False, True):
        sched._sync_timing = sync
        since = sched.flight.rounds
        await traffic(port)
        out["sync_on" if sync else "sync_off"] = phase_split(await _frames_of(port, dep, since))
    sched._sync_timing = False
    print(f"[{card}] telemetry decode phases {name}: {json.dumps(out)}", flush=True)
    return out


async def step_hop(sched, reps: int = 50) -> dict:
    """With no traffic: one plain step called directly (``_step``: inputs
    uploaded, the replay, sampling, the readback), the same through the
    worker thread as a round calls it, and the worker hop alone — the
    median ms of each."""
    import numpy as np

    n = sched.n_slots
    z, pos = np.zeros(n, np.int32), np.full(n, sched.max_ctx - 1, np.int32)
    bt, zf = sched.pool.block_tables(), np.zeros(n, np.float32)

    def step():
        sched.pool.load_block_tables(bt)
        sched._step(z, pos, zf, z, 0)

    async def timed(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            await fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return round(sorted(times)[reps // 2], 4)

    async def direct():
        sched._on_worker(step)

    return {"direct": await timed(direct), "via_worker": await timed(lambda: sched._device_call(step)),
            "hop_only": await timed(lambda: sched._device_call(lambda: None))}


async def serve_decode_telemetry(card) -> dict:
    """Phase 8c: gpt_continuous_batching under phase 5's traffic (16
    staggered requests, mixed budgets): /decode/flight frames total the
    served tokens, admissions and retirements; /decode/health reads the
    bubble; /decode/profile has samples of the loop's thread (?hz=200);
    the round split with sync timing off and on; the step's wall with the
    recorder on and off, in turns. A copy with decode_slo_ttft_ms huge and
    decode_slo_itl_ms tiny: every TTFT meets its SLO and every later token
    breaches, on /metrics. Then gpt2_small_speculative's round split."""
    import numpy as np

    out = {}
    path = BASELINE_DIR / "gpt_continuous_batching.json"
    server, *_ = await _start(path)
    sched = server.decode_scheduler
    dep = server.deployment_name
    vocab = _model_runtime(server).params["tok_emb"].shape[0]
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, vocab, size=(CB_REQUESTS, sched.seq_len))
    budgets = [int(b) for b in rng.integers(1, sched.max_new_tokens + 1, size=CB_REQUESTS)]

    async def traffic(port):
        async def one(i):
            await asyncio.sleep(0.004 * i)
            return await _ids_post(port, prompts[i : i + 1], {"max_new_tokens": budgets[i]})

        replies = await asyncio.gather(*(one(i) for i in range(CB_REQUESTS)))
        return _served_rows("gpt_continuous_batching telemetry", replies, budgets, sched.seq_len)

    try:
        prof = json.loads(await _get(server.port, "/decode/profile?hz=1000"))
        if prof["hz"] != 200:
            raise AssertionError(f"/decode/profile?hz=1000 set {prof['hz']} Hz, want the 200 Hz cap")
        await traffic(server.port)
        frames = await _frames_of(server.port, dep, 0)
        check_flight("gpt_continuous_batching", frames, sum(budgets), CB_REQUESTS)
        lost = json.loads(json.dumps(frames))
        next(f for f in lost if f["tokens"])["tokens"] -= 1
        must_fail("a frame that loses a token", lambda: check_flight("planted", lost, sum(budgets), CB_REQUESTS))
        health = json.loads(await _get(server.port, "/decode/health"))[dep]
        if not 0.0 < health["bubble_fraction"] < 1.0 or health["tokens"] != sum(budgets):
            raise AssertionError(f"/decode/health: {health}")
        prof = json.loads(await _get(server.port, "/decode/profile?n=8"))
        if prof["samples"] <= 0:
            raise AssertionError(f"/decode/profile sampled nothing: {prof}")
        out["health"] = {k: health[k] for k in ("bubble_fraction", "top_gap_phase", "phase_of_gap", "rounds")}
        out["profile"] = {"samples": prof["samples"], "top": prof["top"][:5]}
        out["phases"] = await decode_phases(card, "gpt_continuous_batching", traffic, sched, server.port, dep)
        walls = {"on": [], "off": []}
        for on in (True, False, False, True):
            sched.flight.enabled = sched._phases.enabled = on
            steps = sched.stat_steps
            t0 = time.perf_counter()
            await traffic(server.port)
            walls["on" if on else "off"].append(round((time.perf_counter() - t0) * 1e3 / (sched.stat_steps - steps), 4))
        sched.flight.enabled = sched._phases.enabled = True
        out["step_wall_ms_flight"] = walls
        out["idle_step_ms"] = await step_hop(sched)
        await _get(server.port, "/decode/profile?hz=19")  # back to the default rate
        if sched.recompiles_since_warmup() != 0:
            raise AssertionError("gpt_continuous_batching built new keys with telemetry on")
    finally:
        await server.stop()

    server, *_ = await _start(_deployment_copy("gpt_continuous_batching",
                                               {"decode_slo_ttft_ms": 1e6, "decode_slo_itl_ms": 1e-3}))
    try:
        before = metric_samples((await _get(server.port, "/metrics")).decode())
        rows = await traffic(server.port)
        after = metric_samples((await _get(server.port, "/metrics")).decode())
    finally:
        await server.stop()
    slo = "seldon_tpu_decode_slo_attainment_total"
    sdep = server.deployment_name
    check_delta("slo", before, after, slo, CB_REQUESTS, deployment_name=sdep, kind="ttft", outcome="ok")
    check_delta("slo", before, after, slo, sum(budgets) - CB_REQUESTS, deployment_name=sdep, kind="itl",
                outcome="breach")
    check_delta("slo", before, after, slo, 0, deployment_name=sdep, kind="ttft", outcome="breach")
    must_fail("slo: itl breaches off by one", lambda: check_delta(
        "slo", before, after, slo, sum(budgets) - CB_REQUESTS + 1, deployment_name=sdep, kind="itl",
        outcome="breach"))
    out["slo"] = {"ttft_ok": CB_REQUESTS, "itl_breach": sum(budgets) - CB_REQUESTS, "rows": len(rows)}

    path = BASELINE_DIR / "gpt2_small_speculative.json"
    server, *_ = await _start(path)
    sched = server.decode_scheduler
    prompts_s, budgets_s = _spec_prompts(sched, _model_runtime(server).params["tok_emb"].shape[0])

    async def spec_traffic(port):
        replies, _ = await _spec_traffic(port, prompts_s, budgets_s)
        return _served_rows("gpt2_small_speculative telemetry", replies, budgets_s, sched.seq_len)

    try:
        await spec_traffic(server.port)  # the controller settles
        out["spec_phases"] = await decode_phases(card, "gpt2_small_speculative", spec_traffic, sched, server.port,
                                                 server.deployment_name)
        if sched.recompiles_since_warmup() != 0:
            raise AssertionError("gpt2_small_speculative built new keys with telemetry on")
    finally:
        await server.stop()
    keys = ("health", "profile", "slo", "step_wall_ms_flight", "idle_step_ms")
    print(f"[{card}] telemetry decode: {json.dumps({k: out[k] for k in keys})}", flush=True)
    return out


async def telemetry_cost(card) -> dict:
    """Phase 8d: telemetry on (the defaults) against off (the tracer
    disabled, metrics_enabled=False) under the load generator at
    TELEMETRY_LOAD_USERS users, in turns (on, off, off, on): iris
    (ingress-bound) and the BERT DAG."""
    from seldon_core_tpu_torch.telemetry import Tracer

    loads = {"iris": {"payload": "json", "features": 4}, "full_dag_bert": {"payload": "json", "features": 128}}
    out = {}
    for name, load in loads.items():
        on, *_ = await _start(BASELINE_DIR / f"{name}.json")
        off, *_ = await _start(BASELINE_DIR / f"{name}.json", metrics_enabled=False)
        off.service.tracer = Tracer(enabled=False)
        runs = {"on": [], "off": []}
        try:
            for mode, srv in (("on", on), ("off", off), ("off", off), ("on", on)):
                pt = await _load_point(srv.port, TELEMETRY_LOAD_USERS, load)
                runs[mode].append({k: pt[k] for k in ("requests_per_sec", "p50_ms", "p99_ms")})
        finally:
            await on.stop()
            await off.stop()
        if off.metrics.export() != b"":
            raise AssertionError(f"{name}: the telemetry-off server exported metrics")
        spread = {m: round(max(r["requests_per_sec"] for r in rs) / min(r["requests_per_sec"] for r in rs), 3)
                  for m, rs in runs.items()}
        out[name] = {**runs, "spread": spread}
        print(f"[{card}] telemetry cost {name} users={TELEMETRY_LOAD_USERS}: {json.dumps(out[name])}", flush=True)
    return out


async def serve_telemetry(card) -> dict:
    """Phase 8, every part in one event loop."""
    out = {"split": {}}
    for name in ("bert_base_flash", "full_dag_bert"):
        out["split"][name] = await serve_traces(card, name)
    out["faults"] = await telemetry_faults(card)
    out["decode"] = await serve_decode_telemetry(card)
    out["cost"] = await telemetry_cost(card)
    return out


def sass_counts(library: Path, ops=("HGMMA", "UTMALDG")) -> dict:
    """How many of each instruction in ``ops`` (by default HGMMA, wgmma,
    and UTMALDG, a TMA load) the built library holds, from its
    disassembly."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def host_cost(card, calls: int = 200) -> dict:
    """Host microseconds per call at the bucket-8 shape, fed as QKV views:
    the whole wrapper (checks, ctypes, tensor maps, launch) and PyTorch's
    own attention call beside it. Medians of ``calls`` calls, no
    synchronisation inside the loop."""
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    q, k, v = qkv_views(8, 12, 512, 64, torch.bfloat16, torch.Generator(device="cuda").manual_seed(5))
    walls, lib_walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        fa.flash_attention(q, k, v)
        walls.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        F.scaled_dot_product_attention(q, k, v)
        lib_walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(wrapper_us=med(walls), library_call_us=med(lib_walls))
    print(f"[{card}] host cost per call (8, 12, 512, 512, 64) views: {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    from seldon_core_tpu_torch.ops import kernel_build
    from seldon_core_tpu_torch.ops.flash_attention import LAUNCHES, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"[{card}] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build_s = kernel_build.build()
    print(f"[{card}] build: {json.dumps(build_s)} total_s={time.perf_counter() - t0:.3f}", flush=True)
    for name, log in kernel_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Potential Performance Loss" in line:
                print(f"  {name}: {line.strip()}")
    sass = sass_counts(kernel_build.library_path("flash_attention"))
    print(f"[{card}] flash_attention SASS: {json.dumps(sass)}", flush=True)
    if min(sass.values()) == 0:
        raise AssertionError(f"the flash kernel's library lacks wgmma or TMA instructions: {sass}")
    int8_sass = sass_counts(kernel_build.library_path("int8_matmul"), ("HGMMA", "UTMALDG", "HMMA"))
    print(f"[{card}] int8_matmul SASS: {json.dumps(int8_sass)}", flush=True)
    if min(int8_sass.values()) == 0:
        raise AssertionError(f"the int8_matmul library lacks wgmma, TMA or mma.sync instructions: {int8_sass}")
    print(f"[{card}] phase 1 seconds: {time.perf_counter() - t0:.3f}", flush=True)

    # 2. kernel against its plain version
    t2 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    dense, views = "contiguous", "qkv_views"
    cases = [
        ("bert_base_b8", (8, 12, 512, 512, 64), bf16, False, dense),
        ("bert_base_b8_views", (8, 12, 512, 512, 64), bf16, False, views),
        ("bert_base_b1", (1, 12, 512, 512, 64), bf16, False, dense),
        ("bert_base_b1_views", (1, 12, 512, 512, 64), bf16, False, views),
        ("auto_long", (1, 12, 4096, 4096, 64), bf16, False, dense),
        ("auto_long_views", (1, 12, 4096, 4096, 64), bf16, False, views),
        ("causal_d128", (1, 12, 2048, 2048, 128), bf16, True, dense),
        ("ragged_causal_d128", (2, 3, 200, 256, 128), bf16, True, dense),
        ("ragged_d128", (2, 3, 65, 48, 128), bf16, False, dense),
        ("f32_qpad", (2, 3, 40, 64, 64), f32, False, dense),
        ("f32_qpad_causal", (2, 3, 40, 64, 64), f32, True, dense),
        # the DAG's BERT-base arms at seq 128: one 128-key tile
        ("dag_seq128_b1", (1, 12, 128, 128, 64), bf16, False, dense),
        ("dag_seq128_b1_views", (1, 12, 128, 128, 64), bf16, False, views),
        ("dag_seq128_b64", (64, 12, 128, 128, 64), bf16, False, dense),
        ("dag_seq128_b64_views", (64, 12, 128, 128, 64), bf16, False, views),
        # the decoder's prefill at GPT-2-small widths and a 4096-token prompt
        ("decoder_prefill_views", (1, 12, 4096, 4096, 64), bf16, True, views),
        ("decoder_prefill", (1, 12, 4096, 4096, 64), bf16, True, dense),
        ("decoder_prefill_f32", (1, 12, 4096, 4096, 64), f32, True, views),
    ]
    rows = {c[0]: check_flash(c, card) for c in cases}
    host = host_cost(card)
    x = torch.zeros(1, 12, 4100, 64, device="cuda", dtype=bf16)
    try:
        flash_attention(x, x, x)
    except ValueError as e:
        print(f"[{card}] ragged kv 4100 rejected: {e}", flush=True)
    else:
        raise AssertionError("flash_attention took a ragged kv length of 4100")
    del x
    print(f"[{card}] phase 2 seconds: {time.perf_counter() - t2:.3f}", flush=True)

    # 3. BERT-base at seq 512
    t3 = time.perf_counter()
    bert_launches = asyncio.run(serve_bert(card, BASELINE_DIR / "bert_base_flash.json"))
    if bert_launches <= 0:
        raise AssertionError("the BERT path launched no flash_attention kernel")
    twins = {"bert_base_flash": asyncio.run(serve_twins(card, BASELINE_DIR / "bert_base_flash.json",
                                                        ("flash_attention",)))}
    print(f"[{card}] phase 3 seconds: {time.perf_counter() - t3:.3f}", flush=True)

    # 4. the five BASELINE deployments
    t4 = time.perf_counter()
    asyncio.run(serve_small(card))
    serve_resnet_ensemble(card)
    dag_launches = asyncio.run(serve_dag(card))
    if dag_launches <= 0:
        raise AssertionError("the DAG path launched no flash_attention kernel")
    twins.update(asyncio.run(baseline_twins(card)))
    print(f"[{card}] phase 4 seconds: {time.perf_counter() - t4:.3f}", flush=True)

    # 5. the four decoder deployments
    t5 = time.perf_counter()
    asyncio.run(serve_tiny_gpt(card))
    asyncio.run(serve_continuous_batching(card))
    asyncio.run(serve_paged_kv(card))
    decoder_launches = asyncio.run(serve_long_prompt(card))
    if decoder_launches <= 0:
        raise AssertionError("the decoder path launched no flash_attention kernel")
    twins["gpt2_small_long_prompt"] = asyncio.run(serve_twins(card, BASELINE_DIR / "gpt2_small_long_prompt.json",
                                                              ("flash_attention",)))
    print(f"[{card}] phase 5 seconds: {time.perf_counter() - t5:.3f}", flush=True)

    # 6. speculative decoding: the three speculative deployments
    t6 = time.perf_counter()
    before = LAUNCHES.count
    asyncio.run(serve_speculation(card))
    # the speculation path's attention is masked attention over the page
    # pool and the draft cache, plain PyTorch as in the JAX package
    spec_launches = LAUNCHES.count - before
    print(f"[{card}] phase 6 flash_attention launches: {spec_launches}", flush=True)
    print(f"[{card}] phase 6 seconds: {time.perf_counter() - t6:.3f}", flush=True)

    # 7. int8 weights and the resilience layer
    t7 = time.perf_counter()
    int8_rows = int8_kernel_checks(card)
    int8_host = int8_host_cost(card)
    int8_launches, int8_by_body = asyncio.run(serve_bert_int8(card))
    if int8_launches <= 0:
        raise AssertionError("the bert_int8 path launched no int8_matmul kernel")
    twins["bert_int8"] = asyncio.run(serve_twins(card, BASELINE_DIR / "bert_int8.json", ("int8_matmul",),
                                                 {"payload": "json", "features": 128}))
    asyncio.run(serve_resilience(card))
    print(f"[{card}] phase 7 seconds: {time.perf_counter() - t7:.3f}", flush=True)

    # 8. telemetry: traces, /metrics, the flight recorder and the profiler
    t8 = time.perf_counter()
    telemetry_out = asyncio.run(serve_telemetry(card))
    print(f"[{card}] phase 8 seconds: {time.perf_counter() - t8:.3f}", flush=True)

    main = rows["bert_base_b8_views"]  # the layout the served forward hands the kernel
    dag = rows["dag_seq128_b64_views"]
    prefill_row = rows["decoder_prefill_views"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/pallas_flash.py:147",
        "launches": bert_launches + dag_launches + decoder_launches + spec_launches,
        "launches_by_path": {"bert_base_flash (phase 3)": bert_launches, "full_dag_bert (phase 4)": dag_launches,
                             "gpt2_small_long_prompt (phase 5)": decoder_launches,
                             "speculative deployments (phase 6)": spec_launches},
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "ms_cold_l2": main["ms_cold_l2"],
        "host_us": host["wrapper_us"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "seq128_b64_views": {k: dag[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")},
        "decoder_prefill_views": {k: prefill_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms")},
    }]
    int8_main = int8_rows["qkv_b32_bfloat16"]  # the served shape with the most work
    served = {"attn_out_b32_bfloat16", "mlp_in_b32_bfloat16", "mlp_out_b32_bfloat16", "head_b32_bfloat16",
              "qkv_b1_bfloat16", "qkv_b32_float32", "stacked_e3_shared_x_bfloat16", "stacked_e3_bfloat16",
              "stacked_e3_k776_shared_x_bfloat16", "stacked_e3_k776_bfloat16",
              "m_ragged_bfloat16", "k_ragged_bfloat16", "n_ragged_bfloat16"}
    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/csrc/int8_matmul.cu",
        # no Pallas kernel: XLA's fusion of quant.dequantize into the matmul
        "replaces": "seldon_core_tpu/models/base.py:137",
        "launches": int8_launches,
        "launches_by_path": {"bert_int8 (phase 7)": int8_launches},
        "launches_by_body": int8_by_body,
        "host_us": int8_host["wrapper_us"],
        **{k: int8_main[k] for k in ("max_abs_err", "ms", "ms_mma", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        **{name: {k: int8_rows[name][k] for k in ("body", "max_abs_err", "ms", "ms_mma", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")} for name in sorted(served)},
    })
    print(json.dumps({"captured_vs_eager": {name: {k: v for k, v in t.items() if k != "breakdown"}
                                            for name, t in twins.items()}}), flush=True)
    print(json.dumps({"telemetry": {"card": card, **telemetry_out}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
