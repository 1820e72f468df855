"""Run one of the PyTorch port's scripts with JAX and the JAX package
blocked from import.

    python tests/helpers/torch_no_jax_helper.py scripts/torch_X.py [args...]

The script runs as ``__main__`` with the given arguments; any import of
JAX, its libraries or ``attend_infer_repeat_tpu`` raises.  The last line
names the blocked modules that were loaded (none, unless the block
failed).
"""

import runpy
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "attend_infer_repeat_tpu")
for _name in BLOCKED:
    sys.modules[_name] = None           # any import of them raises


def main():
    script, *args = sys.argv[1:]
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED
              and sys.modules[m] is not None]
    print(f"FINISHED; JAX modules loaded: {loaded}")


if __name__ == "__main__":
    main()
