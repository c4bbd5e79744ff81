"""Test configuration: force an 8-device virtual CPU mesh so logic and
sharding tests run deterministically without an accelerator (the GPU is
exercised by ``chip_smoke.py`` instead).

Note: a pytest plugin imports jax before this conftest executes, so
environment variables are too late — ``jax.config.update`` still works
because the backend only initializes on first use.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses

import jax

from placement_tpu.utils.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: compile cost dominates test wall-clock.
enable_compile_cache()
