"""Count-prediction analysis: per-class accuracy and confusion matrix.

The scalar ``count_accuracy`` hides which counts fail; this breaks it
down (under- against over-counting).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from attend_infer_repeat_torch.ops.math import seeded_generator


def count_confusion(eval_step: Callable, state, batches,
                    seed: Sequence[int]) -> Dict:
    """Aggregate a confusion matrix ``C[true, pred]`` over batches.

    ``batches`` yields ``(imgs, nums)``; ``eval_step`` is from
    ``train.make_eval_step``; batch ``i`` draws its noise from
    ``seeded_generator(device, *seed, i)``.  Returns the matrix, per-class
    accuracy, overall accuracy, and mean predicted count per true count.
    """
    c_max = 0
    pairs = []
    for i, (imgs, nums) in enumerate(batches):
        _, outputs = eval_step(
            state, imgs, nums,
            seeded_generator(state.model.device, *seed, i))
        t = np.asarray(nums.cpu() if hasattr(nums, "cpu") else nums
                       ).astype(int)
        p = outputs.mode_steps.cpu().numpy().astype(int)
        pairs.append((t, p))
        c_max = max(c_max, t.max(), p.max())
    k = c_max + 1
    mat = np.zeros((k, k), np.int64)
    for t, p in pairs:
        np.add.at(mat, (t, p), 1)
    totals = mat.sum(axis=1)
    per_class = np.where(totals > 0, np.diag(mat) / np.maximum(totals, 1),
                         np.nan)
    mean_pred = np.where(
        totals > 0,
        (mat * np.arange(k)[None, :]).sum(1) / np.maximum(totals, 1),
        np.nan)
    return {
        "confusion": mat,
        "per_class_accuracy": per_class,
        "accuracy": float(np.diag(mat).sum() / max(mat.sum(), 1)),
        "mean_predicted": mean_pred,
    }


def format_confusion(result: Dict) -> str:
    mat = result["confusion"]
    k = mat.shape[0]
    lines = ["true\\pred " + " ".join(f"{j:>6d}" for j in range(k))]
    for i in range(k):
        lines.append(f"     {i:>4d} " + " ".join(
            f"{mat[i, j]:>6d}" for j in range(k)))
    lines.append("per-class acc: " + " ".join(
        f"{a:.3f}" if np.isfinite(a) else "  -  "
        for a in result["per_class_accuracy"]))
    lines.append(f"overall: {result['accuracy']:.4f}")
    return "\n".join(lines)
