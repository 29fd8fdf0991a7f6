from repro_torch.sharding.rules import (
    DEFAULT_RULES, Mesh, NamedSharding, batch_axes, data_axes, db_axes,
    db_shards, logical_to_spec, rule_overrides, shard_tree, with_sharding,
)
