"""Measure full PPO train-step throughput (rollout + GAE + SGD updates).

The north-star bench (bench.py) measures the pure env rollout; this tool
measures what trainer users actually pay: env-steps/s/chip of the complete
compiled train iteration for a shipped config.

Timing discipline: the first call compiles and is untimed; each timed
iteration's metrics are fetched to the host (a data-dependent scalar), so
asynchronous dispatch cannot hide execution.

    python tools/train_throughput.py --type rectangle_pin --iterations 20
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--type", default="rectangle_pin")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax

    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from placement_tpu.agent.policy import Policy, model_config_for
    from placement_tpu.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu.utils.config import load_experiment

    env_params, _, _ = load_experiment(args.type)
    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128,
                                       args.num_envs * args.unroll_length))
    learner = PPOLearner(env_params, Policy(
        env_params, model_config_for(env_params, args.type)), cfg)
    state = learner.init(jax.random.PRNGKey(args.seed))
    step = learner.jitted_train_step()

    t0 = time.perf_counter()
    state, metrics = step(state)
    compile_s = time.perf_counter() - t0
    float(metrics["episode_reward_mean"])          # force completion
    print(f"[compile+first call: {compile_s:.1f}s] "
          f"devices={jax.devices()}", file=sys.stderr, flush=True)

    wraps = 0
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        state, metrics = step(state)
        wraps += int(metrics["pool_wraps"])        # host fetch = sync point
    dt = time.perf_counter() - t0

    steps = args.iterations * cfg.train_batch
    n_chips = max(len(jax.devices()), 1)
    print(json.dumps({
        "metric": "train_step_env_steps_per_sec_per_chip",
        "type": args.type,
        "num_envs": cfg.num_envs, "unroll_length": cfg.unroll_length,
        "iterations": args.iterations,
        "seconds": round(dt, 3),
        "iter_seconds": round(dt / args.iterations, 4),
        "value": round(steps / dt / n_chips, 1),
        "pool_wraps": wraps,
    }), flush=True)


if __name__ == "__main__":
    main()
