"""Environment variable names the port reads.

Port of the part of ``seldon_core_tpu/utils/env.py`` that the port needs,
with the JAX package's names and defaults: the load generator's OAuth
credentials (``tools/loadtest.py`` takes them as the defaults of
``--oauth-key`` / ``--oauth-secret``, so a job can inject them from a
secret instead of its command line); the standalone microservice's
contract (``serving/microservice.py``: the unit's typed parameters, id and
port, the deployment id, and its ``--persistence`` store), the reference's
test-client credentials (``gateway/app.py``) and the remote units' REST
timeouts (``engine/remote.py``, ``rest_timeouts``); and the telemetry knobs read by
``telemetry/tracer.py``, ``telemetry/access_log.py``, ``telemetry/flight.py``
and ``telemetry/profile.py``; the Redis store's socket budget
(``persistence/state.py``); the store a decode fleet spills prefix pages
through and its warm-boot kill switch (``serving/affinity_router.py``);
the predictor server's gRPC port and graceful-drain window
(``serving/server.py``); the operator's PYTHON_CLASS opt-in and Kubernetes
API address, and ``encode_b64_json`` for its manifests (``operator/``).
"""

from __future__ import annotations

import os

# the predictor server's CLI: the gRPC port (reference
# SeldonGrpcServer.java:33) and the window stop() gives in-flight gRPC calls
ENGINE_SERVER_GRPC_PORT = "ENGINE_SERVER_GRPC_PORT"  # default 5000
ENGINE_DRAIN_SECONDS = "ENGINE_DRAIN_SECONDS"  # default 5
LOADTEST_OAUTH_KEY = "LOADTEST_OAUTH_KEY"
LOADTEST_OAUTH_SECRET = "LOADTEST_OAUTH_SECRET"
# the standalone microservice (reference wrappers/python/microservice.py)
PREDICTIVE_UNIT_PARAMETERS = "PREDICTIVE_UNIT_PARAMETERS"
PREDICTIVE_UNIT_ID = "PREDICTIVE_UNIT_ID"
PREDICTIVE_UNIT_SERVICE_PORT = "PREDICTIVE_UNIT_SERVICE_PORT"  # default 5000
SELDON_DEPLOYMENT_ID = "SELDON_DEPLOYMENT_ID"
# the reference's test-client backdoor (AuthorizationServerConfiguration.java:78-96)
TEST_CLIENT_KEY = "TEST_CLIENT_KEY"
TEST_CLIENT_SECRET = "TEST_CLIENT_SECRET"
# a remote unit's REST timeouts: a connect hang fails in about a second,
# while a slow model may use the whole total (which a request's remaining
# deadline budget replaces)
ENGINE_REST_CONNECT_TIMEOUT_S = "ENGINE_REST_CONNECT_TIMEOUT_S"  # default 1.0
ENGINE_REST_TOTAL_TIMEOUT_S = "ENGINE_REST_TOTAL_TIMEOUT_S"  # default 5.0
# tracing: process-wide toggle, tail-sampling pool bounds, optional
# OTLP-JSON trace export, and the structured access log gate
ENGINE_TELEMETRY = "ENGINE_TELEMETRY"  # "off" disables tracing (default on)
ENGINE_TRACE_MAX_ERRORS = "ENGINE_TRACE_MAX_ERRORS"  # default 128
ENGINE_TRACE_SLOW_KEEP = "ENGINE_TRACE_SLOW_KEEP"  # default 32
ENGINE_TRACE_MAX_SAMPLED = "ENGINE_TRACE_MAX_SAMPLED"  # default 64
ENGINE_TRACE_SAMPLE_RATE = "ENGINE_TRACE_SAMPLE_RATE"  # default 0.05
ENGINE_OTLP_FILE = "ENGINE_OTLP_FILE"  # path; unset = no export
ENGINE_ACCESS_LOG = "ENGINE_ACCESS_LOG"  # "json" enables; default off
# decode-loop flight recorder: kill switch and ring capacity (default on,
# 2048 frames)
ENGINE_FLIGHT = "ENGINE_FLIGHT"  # "off" disables the recorder
ENGINE_FLIGHT_FRAMES = "ENGINE_FLIGHT_FRAMES"
# "on": torch.cuda.synchronize() after every scheduler dispatch, so each
# family's flight column is the device's wall (calibration runs; default off)
ENGINE_FLIGHT_SYNC_TIMING = "ENGINE_FLIGHT_SYNC_TIMING"
# the pipelined decode rounds' kill switch ("off": the serial loop; default on)
ENGINE_DECODE_PIPELINE = "ENGINE_DECODE_PIPELINE"
# decode-loop sampling profiler: kill switch, rate (default 19 Hz) and the
# folded-stack table bound (default 512 entries)
ENGINE_DECODE_PROFILE = "ENGINE_DECODE_PROFILE"
ENGINE_DECODE_PROFILE_HZ = "ENGINE_DECODE_PROFILE_HZ"
ENGINE_DECODE_PROFILE_TABLE = "ENGINE_DECODE_PROFILE_TABLE"
# the Redis state store's socket and connect timeout in ms (default 2000)
PERSISTENCE_REDIS_TIMEOUT_MS = "PERSISTENCE_REDIS_TIMEOUT_MS"
# the state store a replicated decode fleet spills its prefix pages through
# and a microservice's --persistence snapshots to (default
# file://./.seldon_state)
PERSISTENCE_STORE = "PERSISTENCE_STORE"
# "off": no warm pre-seeding of a scaled-up replica and no sibling prefix
# pull between replicas (default on)
ENGINE_DECODE_REPLICA_PRESEED = "ENGINE_DECODE_REPLICA_PRESEED"
# the platform's operator: "1" lets CRs mount PYTHON_CLASS units in-process
# (default off), and the Kubernetes API a watcher outside a cluster speaks
# to (e.g. http://127.0.0.1:8001 from kubectl proxy)
SELDON_TPU_ALLOW_PYTHON_CLASS = "SELDON_TPU_ALLOW_PYTHON_CLASS"
SELDON_TPU_K8S_API = "SELDON_TPU_K8S_API"


def encode_b64_json(obj) -> str:
    """JSON, base64-encoded: how a predictor rides ENGINE_PREDICTOR."""
    import base64
    import json

    return base64.b64encode(json.dumps(obj).encode()).decode("ascii")


def rest_timeouts(env: dict | None = None) -> tuple[float, float]:
    """(connect_s, total_s) of a remote unit's REST pool. Falls back to the
    defaults on unset, unparsable or non-positive values: a typo'd timeout
    must not take the data plane down at boot."""
    env = env if env is not None else os.environ
    out = []
    for key, default in ((ENGINE_REST_CONNECT_TIMEOUT_S, 1.0), (ENGINE_REST_TOTAL_TIMEOUT_S, 5.0)):
        try:
            value = float(env.get(key, default))
        except (TypeError, ValueError):
            value = default
        out.append(value if value > 0 else default)
    return out[0], out[1]


def redis_timeout_s(env: dict | None = None) -> float:
    """Redis socket/connect timeout in seconds (redis-py's unit), from
    PERSISTENCE_REDIS_TIMEOUT_MS. Falls back to the 2000 ms default on unset
    or unparsable values: a typo'd timeout must not take the store down."""
    env = env if env is not None else os.environ
    try:
        ms = float(env.get(PERSISTENCE_REDIS_TIMEOUT_MS, 2000.0))
    except (TypeError, ValueError):
        ms = 2000.0
    if ms <= 0:
        ms = 2000.0
    return ms / 1000.0
