"""Async load tester: throughput + latency percentiles + bandit feedback.

Port of ``seldon_core_tpu/tools/loadtest.py``, stdlib only: a swarm of
closed-loop users sends random ndarray predictions (JSON, or uint8 npy
bodies for image models) over persistent HTTP/1.1 connections and reports
requests per second in the intended window with p50/90/95/99 latency; with
``--feedback-route-rewards`` each reply's route earns a reward with a
probability that depends on the route taken, posted to
``/api/v0.1/feedback``, which is how an A/B or epsilon-greedy router is
exercised under load.

Multi-process mode: ``--workers N`` re-execs this module N times, splits the
users across the worker processes, and merges exact latency distributions
(each worker dumps raw float32 latencies to a temp .npy the parent reads
back). One asyncio process tops out as a generator well below a multi-core
server's ceiling; N workers show whether a measured ceiling is the
server's or the client's.

With ``--oauth-key`` (or its ``LOADTEST_OAUTH_KEY`` default) the
generator fetches one client_credentials token from the gateway's
``/oauth/token`` before the window and sends ``Authorization: Bearer`` on
every request; a gateway that issues no token fails the run by name
(``TokenRefused``), never an unauthenticated run in its place. The
connection is ``serving/http_client.py::RawHttpConn``.

CLI:
    python -m seldon_core_tpu_torch.tools.loadtest http://HOST:PORT \
        [--users 10] [--duration 10] [--features 4] [--batch 1] \
        [--workers 1] [--feedback-route-rewards 0.4,0.9] \
        [--oauth-key K --oauth-secret S] [--json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

from seldon_core_tpu_torch.serving.http_client import RawHttpConn as _RawHttpConn
from seldon_core_tpu_torch.utils.env import LOADTEST_OAUTH_KEY, LOADTEST_OAUTH_SECRET


class TokenRefused(RuntimeError):
    """The gateway would not issue a token for the --oauth-key credentials."""


async def fetch_token(base: str, key: str, secret: str) -> str:
    """A client_credentials token from ``{base}/oauth/token`` (an
    urlencoded form, over one connection); raises TokenRefused naming the
    gateway's answer when it issues none."""
    from urllib.parse import urlencode

    host, port, tls = _split_base(base)
    conn = _RawHttpConn(host, port, use_tls=tls)
    body = urlencode({"grant_type": "client_credentials", "client_id": key, "client_secret": secret}).encode()
    try:
        status, _, raw = await conn.post("/oauth/token", body, "application/x-www-form-urlencoded", {})
    finally:
        await conn.close()
    try:
        token = json.loads(raw).get("access_token") if status == 200 else None
    except (ValueError, AttributeError):
        token = None
    if not token:
        raise TokenRefused(
            f"--oauth-key {key!r}: {base}/oauth/token answered {status} {raw[:200].decode(errors='replace')}"
        )
    return token


@dataclass
class LoadStats:
    latencies_s: list[float] = field(default_factory=list)
    errors: int = 0
    feedback_sent: int = 0
    started: float = 0.0
    finished: float = 0.0
    workers: int = 1
    # completion timestamps (same clock as started), parallel to
    # latencies_s: lets the rate count only requests that finished inside
    # the intended window. Closed-loop users drain their LAST in-flight
    # request after the deadline; a single multi-second stall (network
    # hiccup, device preemption) would otherwise stretch the measured wall
    # and poison the throughput 10-100x while every percentile stays sane.
    completions_s: list[float] = field(default_factory=list)
    deadline: float = 0.0  # perf_counter timestamp of intended window end
    # multiprocess mode: per-worker request counts, in worker order — lets
    # callers verify every worker's dump actually contributed to the merge
    worker_requests: list[int] = field(default_factory=list)
    # multiprocess mode: sum of the workers' windowed rates (each worker
    # computes its own window; the merged latency list spans all of them)
    rps_override: float | None = None
    # multiprocess mode: summed drain_requests across workers — the tail
    # signal must survive the merge (a huge p99 with no drain count would
    # be indistinguishable from slow steady-state latency)
    drain_override: int = 0

    def percentile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        idx = min(len(xs) - 1, int(q / 100.0 * len(xs)))
        return xs[idx]

    def summary(self) -> dict:
        n = len(self.latencies_s)
        wall = max(self.finished - self.started, 1e-9)
        drain = 0
        if self.rps_override is not None:
            rps = self.rps_override
            drain = self.drain_override
        elif self.deadline and self.completions_s:
            in_window = sum(1 for t in self.completions_s if t <= self.deadline)
            drain = n - in_window
            window = max(self.deadline - self.started, 1e-9)
            rps = in_window / window
        else:
            rps = n / wall
        out = {
            "requests": n,
            "errors": self.errors,
            "feedback_sent": self.feedback_sent,
            "duration_s": round(wall, 3),
            "requests_per_sec": round(rps, 2),
            "p50_ms": round(self.percentile(50) * 1e3, 2),
            "p90_ms": round(self.percentile(90) * 1e3, 2),
            "p95_ms": round(self.percentile(95) * 1e3, 2),
            "p99_ms": round(self.percentile(99) * 1e3, 2),
            "workers": self.workers,
        }
        if drain:
            # requests that completed after the window (their latencies ARE
            # in the percentiles; they just don't inflate the denominator)
            out["drain_requests"] = drain
        return out


def _make_payload(rng: random.Random, batch: int, shape) -> dict:
    """Random ndarray payload: ``shape`` is an int (flat feature count, the
    locust-script shape) or a tuple (e.g. (224, 224, 3) images)."""

    def _fill(dims):
        if not dims:
            return rng.random()
        return [_fill(dims[1:]) for _ in range(dims[0])]

    dims = (batch, shape) if isinstance(shape, int) else (batch, *tuple(shape))
    return {"data": {"ndarray": _fill(dims)}}


def _split_base(base: str) -> tuple[str, int, bool]:
    from urllib.parse import urlparse

    u = urlparse(base)
    tls = u.scheme == "https"
    return u.hostname or "127.0.0.1", u.port or (443 if tls else 80), tls


async def _user(
    base: str,
    stats: LoadStats,
    stop_at: float,
    *,
    features,
    batch: int,
    headers: dict,
    route_rewards: list[float],
    rng: random.Random,
    wait_range: tuple[float, float] | None,
    static_payload: bool = False,
    payload_format: str = "json",
    payload_fn=None,
) -> None:
    # static_payload: generate + encode ONCE per user and re-post the same
    # bytes — large-tensor benches (images) must not measure the CLIENT's
    # random-number and json.dumps cost
    npy = payload_format == "npy"

    def encode() -> bytes:
        if npy:
            # binary tensor wire path: uint8 npy (images' natural wire dtype,
            # ~8x smaller than JSON text; the server casts to model dtype)
            import numpy as np

            from seldon_core_tpu_torch.core.codec_npy import npy_from_array

            shape = (
                (batch, *tuple(features))
                if not isinstance(features, int)
                else (batch, features)
            )
            nprng = np.random.default_rng(rng.randrange(2**31))
            return npy_from_array(nprng.integers(0, 256, shape, dtype=np.uint8))
        if payload_fn is not None:
            # caller-shaped request bodies (e.g. the soak's shared-system-
            # prompt generative mix); varies per request, so incompatible
            # with the static_payload fast path
            return json.dumps(payload_fn(rng)).encode()
        return json.dumps(_make_payload(rng, batch, features)).encode()

    ctype = "application/x-npy" if npy else "application/json"
    host, port, tls = _split_base(base)
    conn = _RawHttpConn(host, port, use_tls=tls)
    pre_built: bytes | None = (
        conn.build_request("/api/v0.1/predictions", encode(), ctype, headers)
        if static_payload and payload_fn is None
        else None
    )
    parse_body = bool(route_rewards)
    try:
        while time.perf_counter() < stop_at:
            req = (
                pre_built
                if pre_built is not None
                else conn.build_request("/api/v0.1/predictions", encode(), ctype, headers)
            )
            t0 = time.perf_counter()
            try:
                status, resp_headers, raw = await conn.request_raw(req)
                ok = status == 200
                if npy:
                    meta = json.loads(resp_headers.get("seldon-meta", "{}"))
                    body = {"meta": meta} if ok else {}
                elif parse_body and ok:
                    # the bandit loop needs meta.routing from the body
                    body = json.loads(raw)
                else:
                    # latency/throughput mode: body already drained; skip
                    # the JSON parse — the CLIENT's decode cost must not
                    # count against the serving stack under test
                    body = {}
            except Exception:  # noqa: BLE001
                ok = False
                body = {}
            done_at = time.perf_counter()
            dt = done_at - t0
            if ok:
                stats.latencies_s.append(dt)
                stats.completions_s.append(done_at)
            else:
                stats.errors += 1

            # bandit loop: reward probability depends on the route taken
            # (reference predict_rest_locust.py:83-103)
            routing = (body.get("meta") or {}).get("routing") or {}
            if ok and route_rewards and routing:
                branch = next(iter(routing.values()))
                p = route_rewards[branch % len(route_rewards)]
                reward = 1.0 if rng.random() < p else 0.0
                fb = json.dumps(
                    {"response": {"meta": body.get("meta", {})}, "reward": reward}
                ).encode()
                try:
                    st, _, _ = await conn.post(
                        "/api/v0.1/feedback", fb, "application/json", headers
                    )
                    if st == 200:
                        stats.feedback_sent += 1
                except Exception:  # noqa: BLE001
                    pass
            if wait_range:
                await asyncio.sleep(rng.uniform(*wait_range))
    finally:
        await conn.close()


async def run_load(
    base: str,
    *,
    users: int = 10,
    duration_s: float = 10.0,
    features=4,
    batch: int = 1,
    oauth_key: str = "",
    oauth_secret: str = "",
    route_rewards: list[float] | None = None,
    locust_pacing: bool = False,
    seed: int = 0,
    static_payload: bool = False,
    payload_format: str = "json",
    payload_fn=None,
) -> LoadStats:
    stats = LoadStats()
    # reference locust pacing: min_wait 900 / max_wait 1100 ms (~1 req/s/user);
    # default here is closed-loop max throughput
    wait_range = (0.9, 1.1) if locust_pacing else None
    headers: dict = {}
    if oauth_key:
        # one token for every user, fetched before the window opens
        headers["Authorization"] = f"Bearer {await fetch_token(base, oauth_key, oauth_secret)}"
    if payload_format == "npy":
        # the codec loads before the window opens: set-up, not load
        from seldon_core_tpu_torch.core.codec_npy import npy_from_array  # noqa: F401
    stats.started = time.perf_counter()
    stop_at = stats.started + duration_s
    stats.deadline = stop_at
    await asyncio.gather(
        *(
            _user(
                base,
                stats,
                stop_at,
                features=features,
                batch=batch,
                headers=headers,
                route_rewards=route_rewards or [],
                rng=random.Random(seed + i),
                wait_range=wait_range,
                static_payload=static_payload,
                payload_format=payload_format,
                payload_fn=payload_fn,
            )
            for i in range(users)
        )
    )
    stats.finished = time.perf_counter()
    return stats


def run_load_multiprocess(
    base: str,
    *,
    workers: int,
    users: int = 10,
    duration_s: float = 10.0,
    features=4,
    batch: int = 1,
    oauth_key: str = "",
    oauth_secret: str = "",
    route_rewards: list[float] | None = None,
    locust_pacing: bool = False,
    seed: int = 0,
    static_payload: bool = False,
    payload_format: str = "json",
    timeout_s: float | None = None,
) -> LoadStats:
    """Fan the load across ``workers`` OS processes and merge exact stats.

    Each worker is a fresh `python -m seldon_core_tpu_torch.tools.loadtest` with a
    slice of the users; it prints its summary JSON on stdout and dumps raw
    per-request latencies (float32 seconds) to a parent-owned .npy file, so
    merged percentiles are computed over the union, not approximated.
    """
    import numpy as np

    if workers < 2:
        raise ValueError("run_load_multiprocess needs workers >= 2")
    if users < workers:
        workers = max(1, users)
    per = users // workers
    extras = users % workers

    # workers must import this package regardless of the caller's cwd;
    # PREPEND the repo root — wiping PYTHONPATH would drop sitecustomize
    # entries the interpreter environment depends on
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    with tempfile.TemporaryDirectory(prefix="loadtest_") as tmp:
        procs: list[tuple[subprocess.Popen, str]] = []
        for w in range(workers):
            w_users = per + (1 if w < extras else 0)
            dump = os.path.join(tmp, f"lat_{w}.npy")
            cmd = [
                sys.executable, "-m", "seldon_core_tpu_torch.tools.loadtest", base,
                "--users", str(w_users),
                "--duration", str(duration_s),
                "--batch", str(batch),
                "--seed", str(seed + w * 100003),
                "--payload", payload_format,
                "--latency-dump", dump,
                "--json",
            ]
            if isinstance(features, int):
                cmd += ["--features", str(features)]
            else:
                cmd += ["--shape", ",".join(str(d) for d in features)]
            if oauth_key:
                cmd += ["--oauth-key", oauth_key, "--oauth-secret", oauth_secret]
            if route_rewards:
                cmd += [
                    "--feedback-route-rewards",
                    ",".join(str(r) for r in route_rewards),
                ]
            if locust_pacing:
                cmd += ["--locust-pacing"]
            if static_payload:
                cmd += ["--static-payload"]
            procs.append(
                (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env
                    ),
                    dump,
                )
            )

        merged = LoadStats(workers=workers)
        walls: list[float] = []
        rps_sum = 0.0
        deadline = duration_s + (timeout_s if timeout_s is not None else 120.0)
        try:
            for proc, dump in procs:
                try:
                    out, err = proc.communicate(timeout=deadline)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"loadtest worker failed rc={proc.returncode}: "
                        f"{err.decode()[-500:]}"
                    )
                summary = json.loads(out.decode().strip().splitlines()[-1])
                merged.errors += summary["errors"]
                merged.feedback_sent += summary["feedback_sent"]
                walls.append(summary["duration_s"])
                rps_sum += summary["requests_per_sec"]
                merged.drain_override += summary.get("drain_requests", 0)
                n_before = len(merged.latencies_s)
                if os.path.exists(dump):
                    merged.latencies_s.extend(np.load(dump).tolist())
                merged.worker_requests.append(len(merged.latencies_s) - n_before)
            # each worker reports a windowed rate over its own timing; the
            # aggregate is their sum (workers run concurrently)
            merged.rps_override = round(rps_sum, 2)
        finally:
            # one failed worker must not leave the rest hammering the target
            # (and unreaped) for the remaining duration
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        # workers run concurrently: aggregate throughput is the union of
        # requests over the LONGEST worker wall (start skew between worker
        # process launches is excluded by each worker timing itself)
        merged.started = 0.0
        merged.finished = max(walls) if walls else 0.0
        return merged


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("base", help="http://HOST:PORT")
    p.add_argument("--users", type=int, default=10)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--features", type=int, default=4)
    p.add_argument(
        "--shape",
        default="",
        help="comma tensor shape per item (e.g. 224,224,3); overrides --features",
    )
    p.add_argument("--batch", type=int, default=1)
    p.add_argument(
        "--workers",
        type=int,
        default=1,
        help="fan load across N OS processes (locust master/slave equivalent)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--static-payload",
        action="store_true",
        help="encode the payload once per user and re-post the same bytes",
    )
    p.add_argument(
        "--latency-dump",
        default="",
        help="write raw per-request latencies (float32 s) to this .npy path",
    )
    # env fallbacks let a k8s Job inject credentials from a Secret instead
    # of exposing them in the pod spec's command args
    p.add_argument("--oauth-key", default=os.environ.get(LOADTEST_OAUTH_KEY, ""))
    p.add_argument(
        "--oauth-secret", default=os.environ.get(LOADTEST_OAUTH_SECRET, "")
    )
    p.add_argument(
        "--feedback-route-rewards",
        default="",
        help="comma list of per-route reward probabilities, e.g. 0.4,0.9",
    )
    p.add_argument("--locust-pacing", action="store_true", help="~1 req/s/user")
    p.add_argument(
        "--payload",
        choices=("json", "npy"),
        default="json",
        dest="payload_format",
        help="wire format: json ndarray envelope or raw npy (binary fast path)",
    )
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args()
    rewards = (
        [float(x) for x in args.feedback_route_rewards.split(",")]
        if args.feedback_route_rewards
        else None
    )
    features = (
        tuple(int(d) for d in args.shape.split(",")) if args.shape else args.features
    )
    common = dict(
        users=args.users,
        duration_s=args.duration,
        features=features,
        batch=args.batch,
        oauth_key=args.oauth_key,
        oauth_secret=args.oauth_secret,
        route_rewards=rewards,
        locust_pacing=args.locust_pacing,
        seed=args.seed,
        static_payload=args.static_payload,
        payload_format=args.payload_format,
    )
    if args.workers > 1:
        stats = run_load_multiprocess(
            args.base.rstrip("/"), workers=args.workers, **common
        )
    else:
        try:
            stats = asyncio.run(run_load(args.base.rstrip("/"), **common))
        except TokenRefused as e:
            p.exit(2, f"loadtest: {e}\n")
    if args.latency_dump:
        import numpy as np

        np.save(args.latency_dump, np.asarray(stats.latencies_s, dtype=np.float32))
    out = stats.summary()
    print(json.dumps(out) if args.as_json else out)


if __name__ == "__main__":
    main()
