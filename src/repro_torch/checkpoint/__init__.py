from repro_torch.checkpoint.checkpoint import (
    CheckpointError, CheckpointManager, checkpoint_steps, latest_step,
    restore_checkpoint, save_checkpoint,
)
