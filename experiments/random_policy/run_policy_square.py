"""Random-policy baseline on the square env.

Equivalent of the reference's ``experiments/random_policy/run_policy_square.py:38-58``
(10x10 grid, 2x2 components, 1000 episodes, returns plot to
``experiments/results/``), with the episode loop batched and jitted.
"""

import argparse

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..'))  # noqa: E402  (reference installs its env package; we shim instead)

import jax

from placement_tpu.agent.random_policy import simulate
from placement_tpu.env.types import EnvParams, Variant
from placement_tpu.viz.grid import plot_episode_returns

RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "results")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=10)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--component_n", type=int, default=2)
    p.add_argument("--n_episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    params = EnvParams(variant=Variant.SQUARE, height=args.height,
                       width=args.width,
                       component_n=args.component_n).validate()
    returns = simulate(params, jax.random.PRNGKey(args.seed),
                       args.n_episodes)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out = plot_episode_returns(
        list(map(float, returns)),
        os.path.join(RESULTS_DIR,
                     "square_env_random_policy_episode_returns.png"),
        title="Square env random policy episode returns")
    print(f"mean return {float(returns.mean()):.3f} over "
          f"{len(returns)} episodes -> {out}")


if __name__ == "__main__":
    main()
