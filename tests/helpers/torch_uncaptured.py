"""The CUDA graphs' logic on the CPU: ``UncapturedGraph``.

Imports torch and the port only (no JAX), so that the subprocess ranks of
``torch_parallel_helper.py``, which block JAX, can take the entry points'
graphed path too.
"""

import torch


class UncapturedGraph:
    """Stands in for ``utils.graphs.Graph`` on the CPU, which has no CUDA
    graphs: the warm-up runs as on the card (``state`` put back after),
    "capture" runs the body once (``state`` put back after) and keeps what
    it returned as the static outputs, and each "replay" runs the body
    eagerly and copies its
    results into those same tensors, as a real replay rewrites them.  So
    a caller that handed out the static outputs without copying them
    would see them change, as it would on the card."""

    @staticmethod
    def install(monkeypatch):
        from attend_infer_repeat_torch.utils import debug, graphs

        class Uncaptured(graphs.Graph):
            def _capture(self, body, capture, generators):
                # a capture executes nothing: the state is put back
                self._body = body
                with torch.no_grad():
                    saved = [t.clone() for t in self.state]
                out = body()
                with torch.no_grad():
                    for t, v in zip(self.state, saved):
                        t.copy_(v)
                return out

            def _replay(self):
                fresh = self._body()
                for s, v in zip(graphs.leaves(self.out),
                                graphs.leaves(fresh)):
                    s.copy_(v)

        # the graphed path on the CPU; debug_mode still selects the eager one
        monkeypatch.setattr(graphs, "eager", lambda device: debug.active())
        monkeypatch.setattr(graphs, "Graph", Uncaptured)
