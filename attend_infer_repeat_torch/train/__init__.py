"""Training: the train state, the two-group optimizer, the steps, the
checkpoints and the loop (``python -m attend_infer_repeat_torch.train``)."""

import sys as _sys
import types as _types

from attend_infer_repeat_torch.train.checkpoint import (
    BestCheckpointTracker,
    CheckpointManager,
    restore_latest,
)
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
from attend_infer_repeat_torch.train.loop import train


class _CallableTrainModule(_types.ModuleType):
    """Make ``attend_infer_repeat_torch.train`` itself call ``loop.train``.

    Importing this subpackage sets the parent package's ``train``
    attribute to this MODULE, which hides the package's lazy export of
    the ``train`` FUNCTION; a callable module keeps both readings of
    ``air.train(cfg, workdir=...)`` working.
    """

    def __call__(self, *args, **kwargs):
        return train(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableTrainModule

__all__ = ["BestCheckpointTracker", "CheckpointManager", "restore_latest",
           "Optimizer", "TrainState", "create_train_state", "param_count",
           "prior_success_prob", "make_eval_step", "make_scan_train_step",
           "make_train_step", "train"]
