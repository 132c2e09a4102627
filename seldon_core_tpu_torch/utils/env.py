"""Environment variable names the port reads.

Port of the part of ``seldon_core_tpu/utils/env.py`` that the port needs,
with the JAX package's names and defaults: the load generator's OAuth
credentials (``tools/loadtest.py`` takes them as the defaults of
``--oauth-key`` / ``--oauth-secret``, so a job can inject them from a
secret instead of its command line), and the telemetry knobs read by
``telemetry/tracer.py``, ``telemetry/access_log.py``, ``telemetry/flight.py``
and ``telemetry/profile.py``.
"""

LOADTEST_OAUTH_KEY = "LOADTEST_OAUTH_KEY"
LOADTEST_OAUTH_SECRET = "LOADTEST_OAUTH_SECRET"
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
# the pipelined decode rounds' kill switch; the port runs the serial loop,
# so the recorder's overlap fields read 0 whatever it says
ENGINE_DECODE_PIPELINE = "ENGINE_DECODE_PIPELINE"
# decode-loop sampling profiler: kill switch, rate (default 19 Hz) and the
# folded-stack table bound (default 512 entries)
ENGINE_DECODE_PROFILE = "ENGINE_DECODE_PROFILE"
ENGINE_DECODE_PROFILE_HZ = "ENGINE_DECODE_PROFILE_HZ"
ENGINE_DECODE_PROFILE_TABLE = "ENGINE_DECODE_PROFILE_TABLE"
