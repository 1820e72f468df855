"""Training: the train state, the two-group optimizer and the steps."""

from attend_infer_repeat_torch.train.state import (
    Optimizer,
    TrainState,
    create_train_state,
    param_count,
    prior_success_prob,
)
from attend_infer_repeat_torch.train.step import (
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)

__all__ = ["Optimizer", "TrainState", "create_train_state", "param_count",
           "prior_success_prob", "make_eval_step", "make_scan_train_step",
           "make_train_step"]
