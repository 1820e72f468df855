"""Parameters of the JAX package's model as the port's ``state_dict``.

``params_from_flax`` takes the flax parameter tree of ``AIRModel`` (nested
dicts of numpy arrays, with or without the top-level ``"params"`` key) and
returns the ``state_dict`` of the port's ``AIRModel``, so that both run on
the same weights.  Layout changes:

- a flax ``Dense`` kernel is ``(in, out)``, a torch ``Linear`` weight
  ``(out, in)``: transposed;
- a flax ``Conv`` kernel is ``(kh, kw, in, out)``, a torch ``Conv2d``
  weight ``(out, in, kh, kw)``;
- ``OptimizedLSTMCell`` keeps one kernel per gate: ``ii/if/ig/io`` on the
  input (no bias) and ``hi/hf/hg/ho`` on the hidden state (with bias).
  They are stacked in gate order i, f, g, o into ``lstm.ih`` / ``lstm.hh``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax submodule name → port attribute
_MODULES = {
    "cell": "cell", "decoder": "decoder", "baseline": "baseline",
    "Encoder_0": "encoder", "StochasticTransformParam_0": "where",
    "GlimpseEncoder_0": "what", "StepsPredictor_0": "steps",
    "MLP_0": "mlp", "GaussianHead_0": "head",
}
# names of a Dense layer inside a parent that is not an MLP
_DENSE_IN = {"GaussianHead_0": ("loc", "scale"), "StepsPredictor_0": ("logit",)}
_GATES = "ifgo"


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lstm(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.ih.weight"] = torch.cat(
        [_tensor(tree[f"i{g}"]["kernel"]).t() for g in _GATES], 0)
    out[f"{prefix}.hh.weight"] = torch.cat(
        [_tensor(tree[f"h{g}"]["kernel"]).t() for g in _GATES], 0)
    out[f"{prefix}.hh.bias"] = torch.cat(
        [_tensor(tree[f"h{g}"]["bias"]) for g in _GATES], 0)


def _walk(tree: Mapping, parent: str, prefix: str,
          out: Dict[str, torch.Tensor]) -> None:
    for name, sub in tree.items():
        if name == "OptimizedLSTMCell_0":
            _lstm(sub, f"{prefix}lstm", out)
        elif name.startswith("Dense_"):
            k = int(name.split("_")[1])
            attr = (_DENSE_IN[parent][k] if parent in _DENSE_IN
                    else f"dense.{k}")
            out[f"{prefix}{attr}.weight"] = _tensor(sub["kernel"]).t()
            out[f"{prefix}{attr}.bias"] = _tensor(sub["bias"])
        elif name.startswith("Conv_"):
            attr = f"conv.{int(name.split('_')[1])}"
            out[f"{prefix}{attr}.weight"] = _tensor(
                sub["kernel"]).permute(3, 2, 0, 1)
            out[f"{prefix}{attr}.bias"] = _tensor(sub["bias"])
        elif name in _MODULES:
            _walk(sub, name, f"{prefix}{_MODULES[name]}.", out)
        else:
            raise KeyError(f"unknown flax module {prefix}{name}")


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``AIRModel`` parameters → the port's ``AIRModel.state_dict()``."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _walk(tree, "", "", out)
    return {k: v.contiguous() for k, v in out.items()}
