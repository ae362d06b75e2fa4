from repro_torch.train.loop import LoopConfig, LoopReport, train_loop
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_eval_step, make_train_step)

__all__ = ["LoopConfig", "LoopReport", "TrainState", "init_train_state",
           "make_eval_step", "make_train_step", "train_loop"]
