"""Multi-device execution over `torch.distributed`: tensor (tp), data
(dp), expert (EP), sequence (SP) and pipeline (PP) parallelism; the
counterpart of `uzu_tpu/parallel/`, one process per rank."""

from .distributed import initialize, make_hybrid_mesh, process_local_batch_slots
from .expert import default_capacity, moe_forward_ep
from .mesh import DP_AXIS, TP_AXIS, dp_size, make_mesh, replicated, single_device_mesh, tp_size
from .pipeline import (
    PP_AXIS,
    make_pp_mesh,
    pipeline_forward,
    stack_pipeline_params,
    stack_pipeline_states,
    unstack_pipeline_states,
    validate_pp,
)
from .seqpar import make_sp_mesh, ring_attention, sequence_parallel_prefill
from .sharding import (
    decoder_param_specs,
    shard_decoder_params,
    shard_state,
    state_specs,
    validate_tp,
)

__all__ = [
    "initialize",
    "make_hybrid_mesh",
    "process_local_batch_slots",
    "default_capacity",
    "moe_forward_ep",
    "DP_AXIS",
    "TP_AXIS",
    "dp_size",
    "make_mesh",
    "replicated",
    "single_device_mesh",
    "tp_size",
    "PP_AXIS",
    "make_pp_mesh",
    "pipeline_forward",
    "stack_pipeline_params",
    "stack_pipeline_states",
    "unstack_pipeline_states",
    "validate_pp",
    "make_sp_mesh",
    "ring_attention",
    "sequence_parallel_prefill",
    "decoder_param_specs",
    "shard_decoder_params",
    "shard_state",
    "state_specs",
    "validate_tp",
]
