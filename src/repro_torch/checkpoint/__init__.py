from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         leaf_paths, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "leaf_paths",
           "restore_checkpoint", "save_checkpoint"]
