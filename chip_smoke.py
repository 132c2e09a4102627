#!/usr/bin/env python3
"""Drive the PyTorch port (``seldon_core_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card visible

Phases, each of which raises on failure (no phase catches its own):

1. build every CUDA kernel under ``seldon_core_tpu_torch/csrc/`` with nvcc
   for sm_90a (into the git-ignored ``build/kernels/``), and count the
   Hopper instructions in the built library (``HGMMA``, ``UTMALDG``): the
   flash kernel must hold both;
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

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the port beside it, it exits non-zero and prints no result.
TF32 is off for every matmul and convolution here (the plain versions and
the model's projections run in full float32 where they are float32).
"""

from __future__ import annotations

import asyncio
import json
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
DEVICE = "cuda"  # where phase 4 serves
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
                   path: str = "/api/v0.1/predictions") -> tuple[int, dict, bytes, float]:
    """One POST through the port's REST ingress: (status, lower-case headers,
    body, wall ms from connect to the last byte)."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        b"POST %s HTTP/1.1\r\nHost: localhost\r\nContent-Type: %s\r\nContent-Length: %d\r\n"
        b"Connection: close\r\n\r\n" % (path.encode(), ctype.encode(), len(body)) + body
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
    if deltas != [layers] * len(batches):
        raise AssertionError(f"flash kernel launches per request {deltas}, want {layers} each")

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
    if auto_launches != long_layers:
        raise AssertionError(f"auto policy at seq {SEQ_LONG} launched the kernel {auto_launches} times, want {long_layers}")
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


async def _start(path: Path):
    """A warmed PredictorServer for one deployment file, serving REST on a
    free port on the card; returns it with its build and warmup seconds."""
    from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor

    predictor, name = load_predictor(str(path))
    t0 = time.perf_counter()
    server = PredictorServer(predictor, deployment_name=name, device=DEVICE)
    t1 = time.perf_counter()
    server.warmup()
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
    if deltas != [layers] * len(deltas):
        raise AssertionError(f"DAG flash launches per request {deltas}, want {layers} each")
    check_served_bert(card, "full_dag_bert", served)
    return launches


def sass_counts(library: Path) -> dict:
    """How many HGMMA (wgmma) and UTMALDG (TMA load) instructions the built
    library holds, from its disassembly."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}


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
    from seldon_core_tpu_torch.ops.flash_attention import flash_attention

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

    # 2. kernel against its plain version
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

    # 3. BERT-base at seq 512
    bert_launches = asyncio.run(serve_bert(card, BASELINE_DIR / "bert_base_flash.json"))
    if bert_launches <= 0:
        raise AssertionError("the BERT path launched no flash_attention kernel")

    # 4. the five BASELINE deployments
    asyncio.run(serve_small(card))
    serve_resnet_ensemble(card)
    dag_launches = asyncio.run(serve_dag(card))
    if dag_launches <= 0:
        raise AssertionError("the DAG path launched no flash_attention kernel")

    main = rows["bert_base_b8_views"]  # the layout the served forward hands the kernel
    dag = rows["dag_seq128_b64_views"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/pallas_flash.py:147",
        "launches": bert_launches + dag_launches,
        "launches_by_path": {"bert_base_flash (phase 3)": bert_launches, "full_dag_bert (phase 4)": dag_launches},
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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
