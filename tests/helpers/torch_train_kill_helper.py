"""Subprocess helper for the PyTorch port's preemption test.

Runs the port's CLI (``attend_infer_repeat_torch.train.__main__.main``)
with ``--device cpu`` on a tiny preset registered as ``tiny``, with JAX
and the JAX package blocked from import.  With ``--kill-after-first-log``
a watchdog thread SIGTERMs this process as soon as the first metrics row
lands, so the only checkpoint a resume can find (with a huge
``--save-every``) is the loop's kill-time save.
"""

import argparse
import os
import signal
import sys
import threading
import time

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "attend_infer_repeat_tpu")
for _name in BLOCKED:
    sys.modules[_name] = None           # any import of them raises

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_here, os.pardir, os.pardir))


def _watch_log_and_kill(metrics_path: str):
    while True:
        try:
            if os.path.getsize(metrics_path) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
        except OSError:
            pass
        time.sleep(0.02)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", required=True)
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--kill-after-first-log", action="store_true")
    p.add_argument("--save-every", type=int, default=4)
    args = p.parse_args()

    import torch

    from attend_infer_repeat_torch import configs
    from attend_infer_repeat_torch.train.__main__ import main as cli

    torch.set_num_threads(1)
    configs.PRESETS["tiny"] = configs.Config(
        name="tiny",
        model=configs.ModelConfig(
            img_size=(14, 14), glimpse_size=(6, 6), n_what=4, max_steps=2,
            rnn_hidden=16, encoder_hidden=(16,),
            glimpse_encoder_hidden=(16,), decoder_hidden=(16,),
            transform_hidden=(16,), steps_hidden=(8,),
            baseline_hidden=(16,)),
        data=configs.DataConfig(canvas_size=(14, 14), digit_size=(8, 8)),
        # log_every=1: a host sync every step, so the kill lands early
        train=configs.TrainConfig(batch_size=8, learning_rate=1e-4,
                                  log_every=1, fig_every=10**9,
                                  save_every=args.save_every,
                                  eval_batches=2),
        prior=configs.PriorAnnealConfig(anneal_start=2, anneal_steps=10))
    if args.kill_after_first_log:
        threading.Thread(
            target=_watch_log_and_kill,
            args=(os.path.join(args.workdir, "metrics.jsonl"),),
            daemon=True).start()
    cli(["--config", "tiny", "--workdir", args.workdir, "--iters",
         str(args.iters), "--device", "cpu", "--no-tensorboard"])
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED
              and sys.modules[m] is not None]
    print(f"FINISHED; JAX modules loaded: {loaded}")


if __name__ == "__main__":
    main()
