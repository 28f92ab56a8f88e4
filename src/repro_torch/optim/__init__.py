"""AdamW and gradient compression on trees of tensors."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, apply_updates, global_norm, init_opt_state, lr_schedule)
