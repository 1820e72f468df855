"""Evaluation: metrics, the IWAE bound, count analysis and figures."""

from attend_infer_repeat_torch.eval.analyze import (
    count_confusion,
    format_confusion,
)
from attend_infer_repeat_torch.eval.figures import make_fig
from attend_infer_repeat_torch.eval.iwae import make_iwae_eval_step
from attend_infer_repeat_torch.eval.metrics import MetricsLogger, evaluate

__all__ = ["count_confusion", "format_confusion", "make_fig",
           "make_iwae_eval_step", "MetricsLogger", "evaluate"]
