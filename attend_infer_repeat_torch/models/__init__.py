"""Models: the AIR model, its recurrent cell and their modules."""

from attend_infer_repeat_torch.models.air import AIRModel, AIROutputs
from attend_infer_repeat_torch.models.cell import AIRCell, AIRStepOutput

__all__ = ["AIRModel", "AIROutputs", "AIRCell", "AIRStepOutput"]
