from repro_torch.models import lenet, transformer
from repro_torch.models.transformer import (decode_step, forward, init_params,
                                            loss_fn, make_caches, prefill)

__all__ = ["transformer", "lenet", "decode_step", "forward", "init_params",
           "loss_fn", "make_caches", "prefill"]
