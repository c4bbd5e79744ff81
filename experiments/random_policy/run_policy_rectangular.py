"""Random-policy baseline on the rectangular env
(reference: experiments/random_policy/run_policy_rectangular.py:48-98)."""

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
    p.add_argument("--min_component_h", type=int, default=2)
    p.add_argument("--max_component_h", type=int, default=4)
    p.add_argument("--min_component_w", type=int, default=2)
    p.add_argument("--max_component_w", type=int, default=4)
    p.add_argument("--min_num_components", type=int, default=20)
    p.add_argument("--max_num_components", type=int, default=20)
    p.add_argument("--n_episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    params = EnvParams(
        variant=Variant.RECT, height=args.height, width=args.width,
        min_component_h=args.min_component_h,
        max_component_h=args.max_component_h,
        min_component_w=args.min_component_w,
        max_component_w=args.max_component_w,
        min_num_components=args.min_num_components,
        max_num_components=args.max_num_components).validate()
    returns = simulate(params, jax.random.PRNGKey(args.seed),
                       args.n_episodes)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out = plot_episode_returns(
        list(map(float, returns)),
        os.path.join(RESULTS_DIR,
                     "rect_env_random_policy_episode_returns.png"),
        title="Rectangular env random policy episode returns")
    print(f"mean return {float(returns.mean()):.3f} over "
          f"{len(returns)} episodes -> {out}")


if __name__ == "__main__":
    main()
