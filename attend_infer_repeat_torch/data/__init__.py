"""Data: the bundled digit bank and on-device canvas synthesis."""

from attend_infer_repeat_torch.data.digits import load_digit_bank
from attend_infer_repeat_torch.data.synth import (
    make_synth_fn,
    synthesize_batch,
)

__all__ = ["load_digit_bank", "make_synth_fn", "synthesize_batch"]
