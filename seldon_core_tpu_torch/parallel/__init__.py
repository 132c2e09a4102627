"""Meshes of device positions: the mesh, the collectives between positions,
the pipeline schedule and decode tensor parallelism (port of
``seldon_core_tpu/parallel``). One process drives a mesh's positions; with
``initialize_distributed`` (``torch.distributed`` booted from the JAX
package's variables) a ``process_mesh`` spans OS processes, each driving
its own positions, and the collectives cross between them."""

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
    gather_params,
    initialize_distributed,
    local_cards,
    mesh_from_spec,
    place_params,
    process_mesh,
    serving_positions,
    sum_replica_grads,
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
    "gather_params",
    "initialize_distributed",
    "local_cards",
    "mesh_from_spec",
    "place_params",
    "process_mesh",
    "serving_positions",
    "sum_replica_grads",
    "decode_mesh_problems",
    "decode_tp_mesh",
    "decoder_param_pspecs",
    "kv_placed",
    "place_decoder",
    "tp_width",
]
