from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm,
                                          cosine_schedule, global_norm,
                                          make_optimizer, sgd)

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "make_optimizer",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]
