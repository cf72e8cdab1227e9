from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointError,
                                            CheckpointManager,
                                            CheckpointMismatchError,
                                            CheckpointWriteError,
                                            load_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "CheckpointError",
           "CheckpointWriteError", "CheckpointCorruptError",
           "CheckpointMismatchError"]
