"""Meshes of device positions driven by one process: the mesh, the
collectives between positions, and the pipeline schedule (port of
``seldon_core_tpu/parallel``; decode tensor parallelism, ``tp.py``, and
``initialize_distributed`` are not ported yet)."""

from seldon_core_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    P,
    Packed,
    PositionParams,
    local_cards,
    mesh_from_spec,
    place_params,
    serving_positions,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "P",
    "Packed",
    "PositionParams",
    "local_cards",
    "mesh_from_spec",
    "place_params",
    "serving_positions",
]
