"""Sharding: logical-axis annotation + parameter partition specs."""
from repro_torch.sharding.annotate import (DEFAULT_RULES, logical_axis_rules,
                                           resolve_spec, with_sharding)

__all__ = ["DEFAULT_RULES", "logical_axis_rules", "resolve_spec",
           "with_sharding"]
