"""Logical-axis sharding rules: the PyTorch counterpart of
``repro.sharding``."""
from repro_torch.sharding.partition import (DEFAULT_RULES, MULTIPOD_RULES,
                                            current_mesh, logical_to_pspec,
                                            param_shardings, set_mesh, shard,
                                            use_mesh)

__all__ = ["DEFAULT_RULES", "MULTIPOD_RULES", "current_mesh",
           "logical_to_pspec", "param_shardings", "set_mesh", "shard",
           "use_mesh"]
