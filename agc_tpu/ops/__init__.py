"""Device (JAX/XLA) kernels for the hot compute stages.

- 64-bit integers are required for k-mer codes (2k bits, k up to 32).
- A persistent compilation cache is enabled: kernel shapes are bucketed
  (see kmers._bucket_size), so the working set of executables is small and
  reused across runs. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
  and this module sets no directory; otherwise the cache lives at a fixed
  ``.jax_cache/`` in the checkout root (the path is part of the cache
  key, so it must not move between runs).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
