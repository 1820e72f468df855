"""Checkpoint/resume of the whole ``TrainState`` with ``torch.save``.

A checkpoint holds ``step``, ``base_seed``, the model's ``state_dict`` and
each optimizer group's ``count``, ``nu`` and ``trace``, so a restore
resumes bit for bit: the batches and the noise of step ``s`` are a
function of ``(base_seed, s)``, and the anneal schedules of ``step``.
(The host-streamed pickle iterator's position is host state outside the
checkpoint; the loop reseeds it from the restored step.)

Layout: ``<directory>/<step>/state.pt``.  A save writes a hidden
temporary directory and renames it into place, so a kill never leaves a
half-written step directory.  Saves are synchronous.  Checkpoints of the
JAX package (orbax) are a different format and are not read.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

import torch

from attend_infer_repeat_torch.train.state import TrainState

_FILE = "state.pt"


def _blob(state: TrainState) -> dict:
    return {
        "step": int(state.step),
        "base_seed": int(state.base_seed),
        "model": state.model.state_dict(),
        "opt_state": {g: {"count": int(s.count), "nu": list(s.nu),
                          "trace": list(s.trace)}
                      for g, s in state.opt_state.items()},
    }


def _load_into(path: str, template: TrainState) -> TrainState:
    """Write the checkpoint at ``path`` into ``template`` in place."""
    blob = torch.load(path, map_location=template.model.device,
                      weights_only=True)
    template.model.load_state_dict(blob["model"])
    with torch.no_grad():
        for g, saved in blob["opt_state"].items():
            st = template.opt_state[g]
            for dst, src in zip(st.nu + st.trace,
                                saved["nu"] + saved["trace"]):
                dst.copy_(src)
            st.count = int(saved["count"])
    template.step = int(blob["step"])
    template.base_seed = int(blob["base_seed"])
    return template


class CheckpointManager:
    """Periodic checkpoints of a ``TrainState``, the newest
    ``max_to_keep`` kept (all of them with None).

    ``save`` writes only steps past the latest one and on the
    ``save_interval_steps`` grid, unless ``force``.  ``wait`` and ``close``
    have nothing to wait for (saves are synchronous); they keep the JAX
    package's interface.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, fresh: bool = False):
        self.directory = os.path.abspath(directory)
        if fresh and os.path.isdir(self.directory):
            # a restarted run must neither restore nor collide with the
            # abandoned run's step directories
            shutil.rmtree(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self._keep = max_to_keep
        self._interval = save_interval_steps

    def all_steps(self) -> List[int]:
        return sorted(int(e) for e in os.listdir(self.directory)
                      if e.isdigit()
                      and os.path.exists(os.path.join(self.directory, e,
                                                      _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Write ``state``; returns whether a checkpoint was written.

        A forced save of a step that already exists raises
        ``FileExistsError`` (as orbax raises ``StepAlreadyExistsError``).
        """
        step = int(state.step)
        if not force:
            latest = self.latest_step()
            if (latest is not None and latest >= step) \
                    or step % self._interval:
                return False
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint for step {step} exists: "
                                  f"{final}")
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_blob(state), os.path.join(tmp, _FILE))
        os.replace(tmp, final)
        if self._keep:
            for old in self.all_steps()[:-self._keep]:
                self.delete(old)
        return True

    def delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)),
                      ignore_errors=True)

    def restore(self, template: TrainState, step: Optional[int] = None
                ) -> Optional[TrainState]:
        """Restore checkpoint ``step`` (default: the latest) into
        ``template``, in place and on its device; None if there is none."""
        step = self.latest_step() if step is None else step
        if step is None or step not in self.all_steps():
            return None
        return _load_into(os.path.join(self.directory, str(step), _FILE),
                          template)

    def wait(self):
        """Nothing to wait for: saves are synchronous."""

    def close(self):
        """Nothing to release: saves are synchronous."""


class BestCheckpointTracker:
    """Keep the single best checkpoint by a validation metric.

    A ``best.json`` sidecar records the metric's value and step, so that a
    resumed run never regresses the best.
    """

    def __init__(self, directory: str, fresh: bool = False):
        self._mgr = CheckpointManager(directory, max_to_keep=None,
                                      fresh=fresh)
        self._meta = os.path.join(self._mgr.directory, "best.json")
        self.best: Optional[float] = None
        self.best_step: Optional[int] = None
        if fresh or not os.path.exists(self._meta):
            return
        try:
            with open(self._meta) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return
        self.best = blob.get("value")
        self.best_step = blob.get("step")

    def offer(self, state: TrainState, value: float) -> bool:
        """Snapshot ``state`` iff ``value`` beats the best so far."""
        step = int(state.step)
        if self.best is not None and float(value) <= self.best:
            return False
        if step == self.best_step:
            # the same step re-offered with a strictly better value
            self._mgr.delete(step)
        self.best = float(value)
        self.best_step = step
        self._mgr.save(state, force=True)
        # the checkpoint is on disk before the sidecar names it, and the
        # old best goes only after the sidecar has moved on
        with open(self._meta, "w") as f:
            json.dump({"value": self.best, "step": step}, f)
        for old in self._mgr.all_steps():
            if old != step:
                self._mgr.delete(old)
        return True

    def restore(self, template: TrainState) -> Optional[TrainState]:
        """Restore the best checkpoint into ``template``, or None."""
        if self.best_step is None:
            return None
        return self._mgr.restore(template, self.best_step)

    def wait(self):
        """Nothing to wait for: saves are synchronous."""

    def close(self):
        """Nothing to release: saves are synchronous."""


def restore_latest(directory: str, template: TrainState
                   ) -> Optional[TrainState]:
    """Restore-or-None (the reference's restore-or-init)."""
    if not os.path.isdir(directory):
        return None
    return CheckpointManager(directory).restore(template)
