"""PPO training entry point.

Equivalent of ``experiments/PPO/PPO.py`` in the reference: pick a
model type, train with per-iteration checkpointing (keep 5), and — for pin
model types — export deterministic rollouts and the config CSV afterwards
(``experiments/PPO/PPO.py:27-54``). No Ray: the training loop is one jitted
XLA program (see ``placement_tpu/agent/trainer.py``).

    python experiments/ppo.py --type rectangle_pin --iterations 1
"""

import argparse

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # noqa: E402  (reference installs its env package; we shim instead)


from placement_tpu.agent.ppo import PPOConfig
from placement_tpu.agent.trainer import Trainer
from placement_tpu.utils.config import MODEL_TYPES
from placement_tpu.viz.rollout import generate_rollouts


def main() -> None:
    p = argparse.ArgumentParser(description="Train a PPO placement agent")
    p.add_argument("--type", required=True, choices=sorted(MODEL_TYPES),
                   help="model type (experiments/PPO/PPO.py:29-35)")
    p.add_argument("--iterations", type=int, default=1,
                   help="training iterations (reference default: 1)")
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--num-sgd-iter", type=int, default=30,
                   help="SGD epochs per iteration (RLlib-parity default "
                        "30; 10 is the validated ~2x-faster preset, "
                        "docs/performance.md)")
    p.add_argument("--route-budget", type=int, default=None,
                   help="gated terminal routing: per-step finisher budget "
                        "(pin variants; speeds up rollouts on big boards, "
                        "rewards match eager to one f32 ulp)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restore", type=str, default=None,
                   help="run dir to restore the newest checkpoint from")
    p.add_argument("--no-rollouts", action="store_true",
                   help="skip post-training rollout export")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the env batch over all local devices "
                        "(1-D dp mesh; device count must divide num-envs)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="capture a jax.profiler trace of iterations 2-3 "
                        "into this directory (TensorBoard profile plugin)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host: jax.distributed coordinator address")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--run-name", type=str, default=None,
                   help="fixed run-dir name (required for multi-host runs "
                        "so every process shares one run directory)")
    p.add_argument("--results-root", type=str, default=None,
                   help="results root (default ~/placement_tpu_results)")
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if (args.num_processes or 0) > 1 and not args.run_name:
        p.error("--run-name is required with --num-processes > 1 "
                "(timestamped names would differ across processes)")

    from placement_tpu.parallel.mesh import initialize_distributed, make_mesh
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    mesh = make_mesh() if args.data_parallel else None

    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128, args.num_envs
                                       * args.unroll_length),
                    num_sgd_iter=args.num_sgd_iter,
                    route_budget=args.route_budget)
    extra = {}
    if args.results_root:
        extra["results_root"] = args.results_root
    trainer = Trainer(args.type, ppo_config=cfg, mesh=mesh,
                      profile_dir=args.profile_dir,
                      run_name=args.run_name, **extra)
    state = None
    if args.restore:
        state = trainer.restore(run_dir=args.restore, seed=args.seed)

    def report(it, row):
        print(f"iter {it}: reward_mean={row.get('episode_reward_mean'):.4f} "
              f"kl={row.get('kl', float('nan')):.5f}")

    result = trainer.run(num_iterations=args.iterations, seed=args.seed,
                         state=state, on_iteration=report)
    print("run dir:", result.run_dir)

    # rollout export for pin types only (experiments/PPO/PPO.py:49-54);
    # one writer in multi-host runs
    if (not args.no_rollouts and "pin" in args.type
            and trainer.is_main_process):
        generate_rollouts(trainer, state=result.state)
        print("rollouts exported to", result.run_dir)
    trainer.close()


if __name__ == "__main__":
    main()
