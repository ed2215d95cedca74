"""Port of ``src/repro/train``: AdamW, the training step and loop,
checkpointing, straggler tracking and elastic re-meshing."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, lr_schedule
from repro_torch.train.train_loop import TrainState, make_train_step, train_loop

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
    "TrainState", "make_train_step", "train_loop",
]
