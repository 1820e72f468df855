"""Models: the AIR model, its recurrent cell, Sequential AIR, SPACE and
their modules."""

from attend_infer_repeat_torch.models.air import AIRModel, AIROutputs
from attend_infer_repeat_torch.models.cell import AIRCell, AIRStepOutput
from attend_infer_repeat_torch.models.space import SpaceModel, SpaceOutputs
from attend_infer_repeat_torch.models.sqair import SQAIRModel, SQAIROutputs

__all__ = ["AIRModel", "AIROutputs", "AIRCell", "AIRStepOutput",
           "SpaceModel", "SpaceOutputs", "SQAIRModel", "SQAIROutputs"]
