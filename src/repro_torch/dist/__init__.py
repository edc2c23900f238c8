"""Distribution layer: the ambient mesh, placement specs, collectives.

`dist.sharding` owns the ambient-mesh helpers model code calls inline
(`ctx_mesh`, `ctx_dp_axes`, `axis_size`, `axis_rank`, `constrain`);
`dist.collectives` the all-gather / reduce-scatter / all-reduce over one
mesh axis that every parallel block calls; this package root re-exports the
spec functions the trainer and the dry-run use to place whole trees.
"""
from .sharding import (DP_AXES, ShapeMesh, constrain,  # noqa: F401
                       ctx_dp_axes, ctx_mesh, set_mesh)
from .specs import (batch_specs, cache_specs, init_sharded,  # noqa: F401
                    opt_state_specs, param_specs, shard_params)
