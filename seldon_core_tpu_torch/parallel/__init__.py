"""Meshes of device positions driven by one process: the mesh, the
collectives between positions, the pipeline schedule and decode tensor
parallelism (port of ``seldon_core_tpu/parallel``; ``initialize_distributed``
is not ported yet)."""

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
from seldon_core_tpu_torch.parallel.tp import (
    decode_mesh_problems,
    decode_tp_mesh,
    decoder_param_pspecs,
    kv_placed,
    place_decoder,
    tp_width,
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
    "decode_mesh_problems",
    "decode_tp_mesh",
    "decoder_param_pspecs",
    "kv_placed",
    "place_decoder",
    "tp_width",
]
