"""The port's load generator (seldon_core_tpu_torch/tools/loadtest.py) against
the JAX package's, and against a port server on the CPU.

- ``LoadStats``: percentiles, the windowed rate, drain counts and the
  multiprocess override give the JAX package's summary on the same
  latencies;
- ``run_load`` for about a second against the port's ``iris_abtest``
  server: predictions/s above zero, no errors, and route-reward feedback
  posted to ``/api/v0.1/feedback`` and answered 200; JSON and npy bodies;
- ``--workers 2`` re-execs the port's module, never the JAX package's;
- ``--oauth-key`` credentials the port's gateway refuses fail the run by
  name, in the function, the multiprocess fan-out and the CLI;
- the module imports nothing of ``seldon_core_tpu``, ``aiohttp``, ``jax``
  or ``torch``, and its npy codec no torch.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.tools.loadtest import LoadStats as JaxLoadStats
from seldon_core_tpu_torch.serving.server import PredictorServer, load_predictor
from seldon_core_tpu_torch.tools import loadtest

ROOT = Path(__file__).resolve().parent.parent
ABTEST = ROOT / "seldon_core_tpu_torch" / "deployments" / "iris_abtest.json"


def _fill(stats, lat, completions, started, deadline):
    stats.latencies_s = list(lat)
    stats.completions_s = list(completions)
    stats.started, stats.deadline = started, deadline
    stats.finished = max(completions) if completions else started
    stats.errors, stats.feedback_sent = 2, 5
    return stats


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (7, 2), (100, 3), (1001, 4)])
def test_load_stats_summary_equals_the_jax_package(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.exponential(0.01, n).tolist()
    completions = np.sort(rng.uniform(0.0, 1.2, n)).tolist()  # some past the 1 s window: drain
    ours = _fill(loadtest.LoadStats(), lat, completions, 0.0, 1.0)
    theirs = _fill(JaxLoadStats(), lat, completions, 0.0, 1.0)
    assert ours.summary() == theirs.summary()
    for q in (50, 90, 95, 99, 100):
        assert ours.percentile(q) == theirs.percentile(q)
    # no window: the rate over the wall; a merged (multiprocess) rate wins
    ours.deadline = theirs.deadline = 0.0
    assert ours.summary() == theirs.summary()
    ours.rps_override = theirs.rps_override = 12.5
    ours.drain_override = theirs.drain_override = 3
    assert ours.summary() == theirs.summary()


async def _abtest_server():
    predictor, name = load_predictor(str(ABTEST))
    server = PredictorServer(predictor, deployment_name=name, device="cpu")
    server.warmup()
    await server.start("127.0.0.1", 0)
    return server


async def test_run_load_against_the_port_abtest_server_posts_feedback():
    server = await _abtest_server()
    try:
        stats = await loadtest.run_load(
            f"http://127.0.0.1:{server.port}", users=3, duration_s=1.0, features=4, route_rewards=[0.2, 0.9], seed=7,
        )
    finally:
        await server.stop()
    s = stats.summary()
    assert s["requests"] > 0 and s["requests_per_sec"] > 0 and s["errors"] == 0
    assert s["feedback_sent"] > 0 and s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]


async def test_npy_payload_and_static_payload_against_the_port():
    server = await _abtest_server()
    try:
        stats = await loadtest.run_load(f"http://127.0.0.1:{server.port}", users=2, duration_s=0.5, features=4,
                                        payload_format="npy", static_payload=True)
    finally:
        await server.stop()
    assert stats.summary()["requests"] > 0 and stats.errors == 0


async def test_two_workers_rerun_the_port_module():
    server = await _abtest_server()
    try:
        stats = await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: loadtest.run_load_multiprocess(f"http://127.0.0.1:{server.port}", workers=2, users=2,
                                                   duration_s=1.0, features=4, timeout_s=90),
        )
    finally:
        await server.stop()
    s = stats.summary()
    assert s["workers"] == 2 and len(stats.worker_requests) == 2 and min(stats.worker_requests) > 0
    assert s["errors"] == 0 and s["requests_per_sec"] > 0


async def test_oauth_is_refused_by_name():
    """The port serves the OAuth gateway now: credentials it refuses fail
    the run by name in the function, the multiprocess fan-out and the CLI,
    never an unauthenticated run in their place (the served path is
    tests/test_torch_tools_gateway.py)."""
    from seldon_core_tpu_torch.serving.fast_http import gateway_routes, start_fast_server
    from seldon_core_tpu_torch.tools.stack import build_gateway_stack

    predictor, name = load_predictor(str(ABTEST))
    server, gw, _, _ = build_gateway_stack(predictor, deployment_name=name, oauth_key="k", oauth_secret="s",
                                           device="cpu")
    gws = await start_fast_server(gateway_routes(gw), "127.0.0.1", 0)
    base = f"http://127.0.0.1:{gws.sockets[0].getsockname()[1]}"
    try:
        with pytest.raises(loadtest.TokenRefused, match="--oauth-key 'k'.*401.*invalid_client"):
            await loadtest.run_load(base, users=1, duration_s=0.1, oauth_key="k", oauth_secret="wrong")
        with pytest.raises(RuntimeError, match="--oauth-key 'k'.*401"):
            await asyncio.to_thread(loadtest.run_load_multiprocess, base, workers=2, users=2, duration_s=0.1,
                                    oauth_key="k", oauth_secret="wrong", timeout_s=90)
        proc = await asyncio.to_thread(
            subprocess.run,
            [sys.executable, "-m", "seldon_core_tpu_torch.tools.loadtest", base, "--oauth-key", "k",
             "--oauth-secret", "wrong", "--duration", "0.1"],
            capture_output=True, text=True, cwd=ROOT, timeout=60,
        )
        assert proc.returncode == 2 and "--oauth-key 'k'" in proc.stderr and proc.stdout == ""
    finally:
        gws.close()
        await gws.wait_closed()
        await server.stop()


def test_module_imports_only_the_standard_library():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import seldon_core_tpu_torch.tools.loadtest; "
        "import json; print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('seldon_core_tpu', 'aiohttp', 'jax', 'torch', 'numpy'))))"
    )
    # -S: no site hooks, so nothing is imported before the module itself
    out = subprocess.run([sys.executable, "-S", "-c", code, str(ROOT)], capture_output=True, text=True, timeout=60,
                         check=True)
    assert json.loads(out.stdout) == []
    # the npy payload's codec comes without torch: a client process stays light
    code = "import sys, seldon_core_tpu_torch.core.codec_npy; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60, check=True, cwd=ROOT)
    assert out.stdout.strip() == "False"
