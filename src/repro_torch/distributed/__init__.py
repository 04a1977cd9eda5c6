"""Distribution layer (PyTorch port of ``repro.distributed``):
logical-axis sharding rules and their DTensor placements."""

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES, ShardingRules, batch_pspec, cache_pspecs,
    distribute_params, distribute_tree, init_sharded_state, opt_pspecs,
    param_pspecs, param_shardings, resolve_axes, to_placements,
)
