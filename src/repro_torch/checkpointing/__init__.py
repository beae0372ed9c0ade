from repro_torch.checkpointing.checkpoint import (latest_step, restore, save,
                                                  skeleton)

__all__ = ["save", "restore", "latest_step", "skeleton"]
