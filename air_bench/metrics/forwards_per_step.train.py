"""Model forwards the train objective runs a step: the program's
``train.step.objective_counts``, ``forwards`` over ``steps`` since the
process started (the counter sees each run of the step's Python: eager
steps, a graph's warm-ups and its capture, not a replay, which runs the
captured step as it was).  Train cells of the ``iwae`` objective, whose
program keeps the counter, only."""

UNIT = "forwards/step"


def read(r):
    if r.kind != "chunks" or r.cfg["train"]["objective"] != "iwae":
        return None
    from attend_infer_repeat_torch.train import step

    counts = getattr(step, "objective_counts", None)
    if not counts or not counts.get("steps"):
        return None
    return counts["forwards"] / counts["steps"]
