from repro_torch.sharding.specs import (RULE_SETS, AxisRules, axis_rules,
                                        can_shard, current_rules,
                                        logical_to_spec, make_param_shardings,
                                        rule_axis_size, rules_for,
                                        shard_constraint, shard_shape)

__all__ = ["AxisRules", "axis_rules", "can_shard", "rule_axis_size", "current_rules",
           "logical_to_spec", "make_param_shardings", "shard_constraint",
           "shard_shape", "RULE_SETS", "rules_for"]
