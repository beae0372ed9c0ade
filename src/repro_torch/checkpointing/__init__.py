from repro_torch.checkpointing.checkpoint import (latest_step, restore,
                                                  restore_resharded, save,
                                                  skeleton)

__all__ = ["save", "restore", "restore_resharded", "latest_step",
           "skeleton"]
