"""Auxiliary subsystems: profiling and step timing, NaN trapping and
functional error checks, and the kernels' build cache.

The counterparts of the JAX package's ``utils``: ``torch.profiler`` for
``jax.profiler``, a dispatch-mode NaN trap for ``jax_debug_nans`` (with
the step run eagerly, the counterpart of ``jax_disable_jit``), and the
kernels' build directory for XLA's compilation cache.
"""

from attend_infer_repeat_torch.utils.cache import enable_compilation_cache
from attend_infer_repeat_torch.utils.debug import checkify_fn, debug_mode
from attend_infer_repeat_torch.utils.profiling import StepTimer, trace

__all__ = ["checkify_fn", "debug_mode", "enable_compilation_cache",
           "StepTimer", "trace"]
