"""Checkpoints of the port (counterpart of `repro/checkpoint/`): the same
``ckpt-crc32-v1`` msgpack files, read and written without the `msgpack`
package."""
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               latest_paged_checkpoint,
                                               paged_checkpoints, restore,
                                               restore_paged_state,
                                               restore_train_state, save,
                                               save_paged_state,
                                               save_train_state)

__all__ = ["CheckpointCorruptError", "latest_paged_checkpoint",
           "paged_checkpoints", "restore", "restore_paged_state",
           "restore_train_state", "save", "save_paged_state",
           "save_train_state"]
