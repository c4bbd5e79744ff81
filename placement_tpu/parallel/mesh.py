"""Device-mesh scale-out for the placement engine.

The reference's only concurrency layer is Ray RLlib actors pinned to
``local_mode=True`` (experiments/PPO/PPO.py:38) — i.e. no real parallelism.
Here the env batch is the scaling axis (SURVEY §2.4): boards shard over a
1-D ``dp`` mesh spanning the devices (several hosts via
``jax.distributed``); model parameters are replicated (the policy nets are
KB-scale, so tensor or pipeline parallelism would only add latency); the
PPO loss reduces across the sharded batch, and GSPMD lowers those
reductions to ``psum`` collectives. One ``jit`` of the learner's train step
with these shardings is the whole distribution story — no parameter
server, no object store.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "dp"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host init (jax.distributed). No-op for single-process runs."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (board) axis sharded across the mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_learner(learner, mesh: Mesh) -> tuple:
    """Wrap a PPOLearner's train step for the mesh.

    Returns (shard_state_fn, train_step_fn): the former lays out a freshly
    initialized TrainState (env batch sharded on ``dp``, everything else
    replicated); the latter is the jitted data-parallel train step — XLA
    inserts the cross-chip ``psum`` for gradient/metric reductions.
    """
    data = batch_sharding(mesh)
    repl = replicated(mesh)

    def place(state):
        # Single-process: device_put scatters directly. Multi-process: the
        # state was computed identically on every process (same seed), so
        # each process materializes its addressable shards from its local
        # copy — the documented host-local -> global-array recipe.
        multiprocess = jax.process_count() > 1

        def put(x, shard):
            if multiprocess:
                arr = np.asarray(x)
                return jax.make_array_from_callback(
                    arr.shape, shard, lambda idx: arr[idx])
            return jax.device_put(x, shard)

        env_states = jax.tree_util.tree_map(lambda x: put(x, data),
                                            state.env_states)
        rest = state.replace(env_states=env_states)
        return rest.replace(
            variables=jax.tree_util.tree_map(lambda x: put(x, repl),
                                             state.variables),
            opt_state=jax.tree_util.tree_map(lambda x: put(x, repl),
                                             state.opt_state),
            kl_coeff=put(state.kl_coeff, repl),
            key=put(state.key, repl),
            steps=put(state.steps, repl),
            # per-env episode accumulators ride the board axis
            ep_return_acc=put(state.ep_return_acc, data),
            ep_len_acc=put(state.ep_len_acc, data))

    train_step = jax.jit(learner.train_step)
    return place, train_step


def shard_env_batch(mesh: Mesh, states) -> "jax.Array":
    """Shard a batched EnvState pytree's leading axis over the mesh."""
    data = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, data), states)

