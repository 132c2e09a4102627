"""The port's processes end cleanly: every thread the port starts is
stopped and joined by its owner's close path, and one still running at
exit by an ``atexit`` hook of its owner.

A daemon thread still inside the interpreter when it finalises is killed
in place, which can abort the process after its work is done
("terminate called without an active exception", exit -6): the decode
loop's sampling profiler did so at the end of one soak leg in a few. Each
case runs in a child process of its own (one compute thread), so no
earlier test's threads or servers are counted:

- after ``soak()`` returns (``--kv-overflow``, 2 s), and after a server
  with a decode scheduler, a KV store tier, a state persister and the
  sampling profiler closes, no thread the port started is alive, by name;
- a child that builds such a server, serves, and returns without closing
  anything exits 0 with nothing on stderr, five times in a row.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the names the port gives the threads it starts (profiler, persister,
# decode worker, compute pool, gRPC gateway handlers, reconciler settles)
PORT_THREADS = ("decode-profile", "persist-", "seldon-decode", "seldon-compute", "seldon-grpc-gateway")

CHILD = r'''
import asyncio, dataclasses, json, sys, threading

from seldon_core_tpu_torch.core.codec_json import message_from_dict
from seldon_core_tpu_torch.persistence.state import StatePersister, make_state_store
from seldon_core_tpu_torch.serving.server import PredictorServer
from seldon_core_tpu_torch.tools.soak import soak, soak_predictor


class Tally:
    """A stateful unit: the persister snapshots it on its thread."""

    name = "tally"

    def __init__(self):
        self.n = 0

    def __getstate__(self):
        return {"n": self.n}

    def __setstate__(self, state):
        self.n = state["n"]


def names():
    return sorted(t.name for t in threading.enumerate())


async def serve(close: bool, store_dir: str) -> dict:
    predictor, _, _, _ = soak_predictor(kv_overflow=True)
    predictor = dataclasses.replace(
        predictor, tpu=dataclasses.replace(predictor.tpu, decode_kv_store_tier=f"file://{store_dir}/kv"))
    server = PredictorServer(predictor, deployment_name="shutdown", device="cpu")
    persister = StatePersister(make_state_store(f"file://{store_dir}/state"), "shutdown", period_s=0.01)
    persister.attach([Tally()])
    persister.start()
    for g in range(3):
        out = await server.service.predict(message_from_dict({"data": {"ndarray": [[7 + g] * 4]}}))
        assert out.status is None or out.status.code in (0, 200), out
    serving = names()
    if close:
        await server.stop()
        persister.stop()
    return {"serving": serving, "after": names()}


mode, store_dir = sys.argv[1:3]
if mode == "soak":
    out = asyncio.run(soak(duration_s=2.0, users=4, kv_overflow=True, device="cpu"))
    print(json.dumps({"errors": out["errors"], "after": names()}))
else:
    # the stores outlive the process: an unclosed persister may snapshot
    # until its atexit join
    print(json.dumps(asyncio.run(serve(mode == "closed", store_dir))))
'''


def _child(mode: str, tmp_path, n: int = 1) -> list[tuple[int, str, str]]:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, mode, str(tmp_path / f"store{i}")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for i in range(n)]
    outs = [p.communicate(timeout=240) for p in procs]
    return [(p.returncode, *out) for p, out in zip(procs, outs)]


def _port_threads(names: list[str]) -> list[str]:
    return [n for n in names if n.startswith(PORT_THREADS)]


@pytest.mark.parametrize("mode", ["soak", "closed"])
def test_no_port_thread_outlives_its_owners_close(mode, tmp_path):
    ((rc, out, err),) = _child(mode, tmp_path)
    assert rc == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    if mode == "soak":
        assert got["errors"] == 0
    else:
        # the server did start the threads this test is about
        assert {"decode-profile", "persist-shutdown"} <= set(got["serving"]), got["serving"]
        assert any(n.startswith("seldon-decode") for n in got["serving"]), got["serving"]
    assert _port_threads(got["after"]) == [], got["after"]
    assert got["after"] == ["MainThread"], got["after"]


def test_an_unclosed_server_exits_cleanly_five_times_in_a_row(tmp_path):
    runs = _child("unclosed", tmp_path, n=5)
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
        assert err == "", err[-3000:]
        assert "decode-profile" in json.loads(out.strip().splitlines()[-1])["serving"]
