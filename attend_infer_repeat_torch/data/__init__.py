"""Data: digit banks, on-device canvas synthesis and pickle loaders."""

from attend_infer_repeat_torch.data.digits import load_digit_bank
from attend_infer_repeat_torch.data.loader import (
    InMemoryDataset,
    batch_iterator,
    load_data,
    tensors_from_data,
)
from attend_infer_repeat_torch.data.synth import (
    make_synth_fn,
    synthesize_batch,
)

__all__ = ["load_digit_bank", "InMemoryDataset", "batch_iterator",
           "load_data", "tensors_from_data", "make_synth_fn",
           "synthesize_batch"]
