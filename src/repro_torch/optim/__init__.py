from repro_torch.optim.optim import (Optimizer, adamw, apply_updates,
                                     clip_by_global_norm, constant,
                                     cosine_decay, global_norm, sgd,
                                     warmup_cosine)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "constant", "cosine_decay", "global_norm", "sgd", "warmup_cosine"]
