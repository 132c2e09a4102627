"""Serving-time garbage-collection policy (port of
``seldon_core_tpu/serving/gc_policy.py``).

After warmup the process holds many long-lived objects: the model's
parameter trees, the captured CUDA graphs and their static buffers, module
state. Every CPython generation-2 collection scans all of them, on the
serving thread, inside whichever event-loop callback allocated the
triggering object, and in the JAX package such pauses were the measured
cause of its 70–100 ms event-loop stalls.

The policy, the standard one for a long-lived server (see the ``gc.freeze``
docs):

1. one full ``collect()`` to drop warmup garbage, then
2. ``freeze()`` the survivors into the permanent generation, out of every
   future generation-2 scan.

Call it after warmup, before taking traffic. Anything in flight at that
moment is pinned for good, so call it from set-up code, not per request.
The ``seldon_tpu_event_loop_lag_ms`` gauges (metrics/registry.py, fed by
``run_loop_lag_probe``) show its effect.
"""

from __future__ import annotations

import gc
import logging

log = logging.getLogger(__name__)

_applied = False


def policy_applied() -> bool:
    """Whether the policy has been applied in this process: the state that
    the platform's release of a dropped deployment (``operator/
    reconciler.py::_Release``), which has to thaw the heap, restores."""
    return _applied


def apply_serving_gc_policy() -> int:
    """Collect warmup garbage, then freeze survivors out of gen-2 scans.
    Returns the number of objects now frozen. Idempotent."""
    global _applied
    _applied = True
    gc.collect()
    gc.freeze()
    frozen = gc.get_freeze_count()
    log.info("serving GC policy applied: %d objects frozen out of gen-2", frozen)
    return frozen
