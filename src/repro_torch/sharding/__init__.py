from repro_torch.sharding.rules import (
    DEFAULT_RULES, Mesh, batch_axes, db_axes, db_shards, logical_to_spec,
    rule_overrides,
)
