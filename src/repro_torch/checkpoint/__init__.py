from .checkpoint import (
    CheckpointManager,
    all_steps,
    latest_step,
    load_aux,
    restore_checkpoint,
    restore_ps_checkpoint,
    restore_sharded_checkpoint,
    save_checkpoint,
    save_ps_checkpoint,
    save_sharded_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "save_ps_checkpoint",
           "restore_ps_checkpoint", "save_sharded_checkpoint",
           "restore_sharded_checkpoint", "load_aux", "latest_step",
           "all_steps", "CheckpointManager"]
