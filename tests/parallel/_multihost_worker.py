"""Worker process for the 2-process ``jax.distributed`` test.

Usage: ``python _multihost_worker.py <coordinator> <num_processes> <pid>``.

Each worker initializes the distributed runtime through the SAME helper the
CLI uses (``placement_tpu.parallel.mesh.initialize_distributed`` — the code
path behind ``experiments/ppo.py --coordinator/--num-processes``), builds
the global 1-D dp mesh spanning both processes' CPU devices, runs

  1. a ``process_allgather`` sanity check (a real cross-process collective),
  2. one tiny sharded PPO train step over the global mesh,

and prints the resulting metrics as one JSON line. The parent test asserts
both processes exit 0 and report identical metrics (they execute the same
global program, so any divergence means the collective layer is broken).

This replaces the reference's Ray actor layer (experiments/PPO/PPO.py:38)
with ``jax.distributed`` + GSPMD collectives.
"""

import json
import os
import sys

import numpy as np


def main() -> None:
    coordinator, num_processes, pid = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

    from placement_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(coordinator, num_processes, pid)
    assert jax.process_count() == num_processes, jax.process_count()
    assert len(jax.devices()) == num_processes          # 1 CPU dev/process
    assert len(jax.local_devices()) == 1

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    # -- collective sanity: gather a per-process vector across processes --
    mine = jnp.full((4,), float(pid + 1))
    gathered = np.asarray(multihost_utils.process_allgather(mine))
    assert gathered.shape == (num_processes, 4), gathered.shape
    assert np.allclose(gathered.sum(axis=1),
                       [4.0 * (i + 1) for i in range(num_processes)])

    # -- one sharded train step over the global mesh ----------------------
    from placement_tpu.agent.policy import Policy, model_config_for
    from placement_tpu.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu.env import EnvParams, Variant
    from placement_tpu.parallel.mesh import make_mesh

    params = EnvParams(variant=Variant.PIN, height=6, width=6,
                       min_component_w=2, max_component_w=3,
                       min_component_h=2, max_component_h=3,
                       max_num_components=3, min_num_components=2,
                       min_num_nets=2, max_num_nets=2,
                       min_num_pins_per_net=2, max_num_pins_per_net=3,
                       reward_type="centroid")
    cfg = PPOConfig(num_envs=4, unroll_length=4, minibatch_size=8,
                    num_sgd_iter=2)
    learner = PPOLearner(params, Policy(
        params, model_config_for(params, "rectangle_pin")), cfg)

    # init is deterministic and identical on both processes; convert the
    # host-local state to global arrays shard-by-shard (the multi-process
    # analogue of mesh.shard_learner's place()).
    state = learner.init(jax.random.PRNGKey(0))
    mesh = make_mesh()
    data = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())

    def to_global(tree, sharding):
        def conv(x):
            x = np.asarray(x)
            return jax.make_array_from_callback(
                x.shape, sharding, lambda idx: x[idx])
        return jax.tree_util.tree_map(conv, tree)

    state = state.replace(
        env_states=to_global(state.env_states, data),
        ep_return_acc=to_global(state.ep_return_acc, data),
        ep_len_acc=to_global(state.ep_len_acc, data),
        variables=to_global(state.variables, repl),
        opt_state=to_global(state.opt_state, repl),
        kl_coeff=to_global(state.kl_coeff, repl),
        key=to_global(state.key, repl),
        steps=to_global(state.steps, repl))

    step = jax.jit(learner.train_step)
    state, metrics = step(state)
    out = {k: float(np.asarray(jax.device_get(v)))
           for k, v in sorted(metrics.items())}
    out["process_count"] = jax.process_count()
    out["global_devices"] = len(jax.devices())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
