from repro_torch.training.optim import AdamW, adam, cosine_schedule, global_norm
from repro_torch.training.trainer import TrainConfig, make_train_step, train

__all__ = ["AdamW", "adam", "cosine_schedule", "global_norm", "TrainConfig",
           "make_train_step", "train"]
