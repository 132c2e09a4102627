"""The soak harness's port (``seldon_core_tpu_torch/tools/soak.py``) on the
CPU, against the JAX package's.

Every leg runs as a subprocess, for the reason the JAX package's own soak
test gives (``tests/test_tools.py``): the stack's boot applies the serving
GC policy, and a ``gc.freeze`` inside the shared pytest process would pin
every earlier test's leftovers. The legs start together, once per module:

- ``--duration 2 --users 4``: the port's JSON line has exactly the keys of
  the JAX package's line for the same arguments;
- ``--faults --trace-summary 3``: the JAX package's trace-summary
  assertions hold on the port's report;
- the ``Makefile``'s ``chaos-smoke`` (``--replicas 2 --kill-replica 0@2``)
  and ``kvtier-smoke`` (``--kv-overflow``) arguments, and its
  ``profile-smoke`` (``--prefix-share 0.5 --profile FILE``), pass the soak's
  own gates on ``tiny_gpt`` (zero errors, evictions and recoveries,
  demotions and promotions, nothing built after warmup, a folded profile);
- ``--tp 2 --device cpu`` serves tensor-parallel decode over two CPU
  positions and passes the JAX soak's tp gates (the shard audit, nothing
  built after warmup, the allocator check); a ``--tp`` soak the positions
  cannot hold is refused by name (``decode_mesh_axes``) before anything is
  built.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "seldon_core_tpu_torch.tools.soak"
JAX = "seldon_core_tpu.tools.soak"
FAULTS = ["--trace-summary", "3", "--faults", "--fault-error-rate", "0.3", "--fault-seed", "1337"]


def _legs(profile_path: str) -> dict:
    return {
        "jax_base": ([JAX, "--duration", "2", "--users", "4"], {}),
        "port_base": ([PORT, "--duration", "2", "--users", "4", "--device", "cpu"], {}),
        "port_faults": ([PORT, "--duration", "2", "--users", "4", *FAULTS, "--device", "cpu"], {}),
        "port_chaos": ([PORT, "--duration", "6", "--users", "4", "--replicas", "2", "--kill-replica", "0@2",
                        "--device", "cpu"], {}),
        "port_kv": ([PORT, "--duration", "3", "--users", "4", "--kv-overflow", "--device", "cpu"], {}),
        "port_profile": ([PORT, "--duration", "3", "--users", "4", "--prefix-share", "0.5", "--profile",
                          profile_path, "--device", "cpu"], {"ENGINE_DECODE_PIPELINE": "on"}),
        # two users on four decode slots: no request waits for a slot, so a
        # loaded host cannot time one out in the queue
        "port_tp": ([PORT, "--duration", "2", "--users", "2", "--tp", "2", "--device", "cpu"], {}),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every leg's (returncode, last stdout line as JSON or None, stderr)."""
    profile_path = str(tmp_path_factory.mktemp("soak") / "decode.folded")
    procs = {}
    for name, (args, extra_env) in _legs(profile_path).items():
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        # seven processes at once: one compute thread each
        env["OMP_NUM_THREADS"] = "1"
        env.update(extra_env)
        procs[name] = subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        lines = stdout.strip().splitlines()
        out[name] = (p.returncode, json.loads(lines[-1]) if p.returncode == 0 and lines else None, stderr)
    out["profile_path"] = profile_path
    return out


def _ok(runs, name: str) -> dict:
    rc, line, stderr = runs[name]
    assert rc == 0, stderr[-2000:]
    return line


def test_baseline_keys_equal_jax(runs):
    ours, theirs = _ok(runs, "port_base"), _ok(runs, "jax_base")
    assert list(ours) == list(theirs)
    assert ours["model"] == theirs["model"] == "iris_mlp"
    assert ours["errors"] == 0 and ours["preds_per_sec"] > 0
    assert ours["rss_end_mb"] > 0 and ours["rss_start_mb"] > 0
    assert ours["loop_lag_p99_ms"] is not None
    # the slope net of the load generator's own growth over the 2 s window
    # (the estimate is printed to 0.1 MB: 1.5 MB/min at 30 windows a minute)
    net = ours["rss_slope_mb_per_min"] - ours["loadgen_stats_mb_est"] * 30
    assert abs(ours["rss_slope_net_mb_per_min"] - net) <= 1.5 + 1e-3


def test_trace_summary_attributes_slowest_traces(runs):
    out = _ok(runs, "port_faults")
    assert set(out) == {"fault_seed", "baseline", "faulted", "p99_delta_ms", "error_rate_delta"}
    assert out["faulted"]["faults_injected"] > 0
    for leg in ("baseline", "faulted"):
        summary = out[leg]["trace_summary"]
        assert summary, f"{leg} leg retained no traces"
        assert len(summary) <= 3
        for entry in summary:
            assert entry["trace_id"] and entry["total_ms"] > 0
            assert 1 <= len(entry["top_spans"]) <= 3
            for span in entry["top_spans"]:
                assert span["name"] and span["self_ms"] >= 0
        totals = [e["total_ms"] for e in summary]
        assert totals == sorted(totals, reverse=True)


def test_chaos_leg_passes_the_soak_gates(runs):
    out = _ok(runs, "port_chaos")
    assert out["model"] == "tiny_gpt" and out["errors"] == 0
    chaos = out["chaos"]
    assert chaos["events"][0]["action"] == "kill" and chaos["evictions"] >= 1 and chaos["recoveries"] >= 1
    assert out["replicas"]["replicas"] == 2 and out["replicas"]["recompiles_after_warmup"] == 0
    assert out["paged"]["recompiles_after_warmup"] == 0 and out["prefix"]["recompiles_after_warmup"] == 0
    assert {r["replica_id"] for r in out["flight"]["per_replica"]} == {0, 1}


def test_kv_overflow_leg_passes_the_soak_gates(runs):
    out = _ok(runs, "port_kv")
    assert out["errors"] == 0
    tier = out["kv_tier"]
    assert tier["groups"] == 8 and tier["prefix_slots"] == 2
    assert tier["demotions"] >= 1 and tier["promotions"] >= 1
    assert tier["recompiles_after_warmup"] == 0 and out["paged"]["recompiles_after_warmup"] == 0
    assert out["prefix"]["captures"] >= 1 and out["prefix"]["evictions"] >= 1


def test_profile_leg_writes_folded_stacks(runs):
    out = _ok(runs, "port_profile")
    prof = out["profile"]
    assert prof["samples"] >= 1 and prof["folded_out"] == runs["profile_path"]
    with open(runs["profile_path"]) as f:
        assert f.read().strip()
    assert out["flight"]["overlap_of_gap"] > 0


def test_tp_is_refused_by_name(runs, monkeypatch):
    """``--tp 2`` serves over two CPU positions with the JAX soak's tp
    report; a tp soak the positions cannot hold is refused by name before
    the stack is built (it would run on one device and report green)."""
    out = _ok(runs, "port_tp")
    tp = out["tp"]
    assert tp["tp"] == tp["requested_tp"] == 2 and tp["mesh_devices"] == 2
    assert tp["components_audited"] >= 2 and tp["recompiles_after_warmup"] == 0
    assert out["errors"] == 0 and out["paged"]["recompiles_after_warmup"] == 0
    # in-process: refused before the stack is built
    import torch

    from seldon_core_tpu_torch.tools import soak, stack

    def built(*a, **k):
        raise AssertionError("soak --tp built a server")

    monkeypatch.setattr(stack, "build_gateway_stack", built)
    with pytest.raises(RuntimeError, match="decode_mesh_axes"):
        asyncio.run(soak.soak(tp=2, device="cpu", mesh_devices=[torch.device("cpu")]))


def test_soak_predictor_serves_any_zoo_spec():
    """The non-generative leg's spec: ``--model`` as the zoo spec, float32,
    no ``tpu`` block beyond the defaults (BERT-base at full width is
    ``bert_base?seq=512&attn_kernel=pallas``)."""
    from seldon_core_tpu_torch.tools.soak import soak_predictor

    pred, prefix_share, paged, generative = soak_predictor(model="bert_base?seq=512&attn_kernel=pallas",
                                                           features=512)
    assert not generative and not paged and prefix_share == 0.0
    (param,) = pred.graph.parameters
    assert (param.name, param.value) == ("model", "bert_base?seq=512&attn_kernel=pallas")
    assert pred.tpu.dtype == "float32" and pred.tpu.decode_slots == 0
    pred, _, paged, generative = soak_predictor(kv_overflow=True, features=8)
    assert generative and paged
    assert pred.tpu.decode_prefix_slots == 2 and pred.tpu.decode_kv_host_bytes == 32 << 20
