"""Training: AdamW and the LR schedules (``optimizer.py``), the train step
(``train_step.py``) and DiSketch gradient compression (``compress.py``)."""
from .compress import CompressorState, DisketchCompressor
from .optimizer import (OptState, adamw_init, adamw_update, cosine_schedule,
                        wsd_schedule)
from .train_step import (TrainState, init_train_state, loss_fn,
                         make_eval_step, make_train_step)

__all__ = ["CompressorState", "DisketchCompressor", "OptState", "TrainState",
           "adamw_init", "adamw_update", "cosine_schedule", "init_train_state",
           "loss_fn", "make_eval_step", "make_train_step", "wsd_schedule"]
