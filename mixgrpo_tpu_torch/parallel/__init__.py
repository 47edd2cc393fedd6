"""Parallelism on ``torch.distributed``: the mesh, FSDP sharding, collectives,
Ulysses and ring attention (port of mixgrpo_tpu/parallel/)."""

from mixgrpo_tpu_torch.parallel.mesh import MeshConfig, init_distributed, make_mesh
from mixgrpo_tpu_torch.parallel.ring import ring_attention
from mixgrpo_tpu_torch.parallel.sharding import (
    constrain_attn,
    data_spec,
    flux_param_specs,
    get_activation_mesh,
    get_local_batch,
    put_global_batch,
    replicated_spec,
    set_activation_mesh,
    shard_params,
)
from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context, ulysses_attention

__all__ = [
    "MeshConfig",
    "make_mesh",
    "init_distributed",
    "flux_param_specs",
    "shard_params",
    "data_spec",
    "replicated_spec",
    "put_global_batch",
    "get_local_batch",
    "set_activation_mesh",
    "get_activation_mesh",
    "constrain_attn",
    "ring_attention",
    "set_sp_context",
    "ulysses_attention",
]
