"""Where the kernels' build lands.

The JAX package caches XLA's compiled programs on disk.  The port
compiles nothing at run time but its CUDA kernels: ``ops/st_kernel.py``
builds ``csrc/`` with ``nvcc`` into one shared library, named by a hash
of the sources, in a build directory (``attend_infer_repeat_torch/_build/``
by default), and a later process finds it there.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(path: str | None = None) -> str:
    """Build the kernels into ``path`` (default: ``$AIR_TORCH_CACHE_DIR``,
    else the package's ``_build/``) from now on; returns the directory.

    A library already loaded in this process stays loaded.
    """
    from attend_infer_repeat_torch.ops import st_kernel

    path = path or os.environ.get("AIR_TORCH_CACHE_DIR") \
        or str(st_kernel.DEFAULT_BUILD_DIR)
    os.makedirs(path, exist_ok=True)
    st_kernel.BUILD_DIR = Path(path)
    return path
