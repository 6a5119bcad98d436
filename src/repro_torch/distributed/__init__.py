from repro_torch.distributed.sharding import (  # noqa: F401
    Rules, make_rules, use_rules, constrain, current_rules,
)
