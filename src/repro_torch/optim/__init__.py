from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, clip_by_global_norm_,
                                     compress_grads, decompress_grads,
                                     wsd_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "clip_by_global_norm_", "compress_grads",
           "decompress_grads", "wsd_schedule"]
