from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, init_adamw, leaves,
                                     like_tree)
from repro_torch.optim.compression import compress_grads_bf16, init_residual
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamWConfig", "OptState", "adamw_update", "compress_grads_bf16",
           "cosine_warmup", "global_norm", "init_adamw", "init_residual",
           "leaves", "like_tree"]
