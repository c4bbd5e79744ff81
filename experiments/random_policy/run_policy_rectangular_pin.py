"""Random-policy baseline on the rectangular-pin env.

The reference's pin runner (``run_policy_rectangular_pin.py:79-186``) is
stale — it passes a 20-argument constructor signature the env no longer
accepts (SURVEY §2.3) — so this runner targets the CURRENT pin-env signature
(``dummy_env_rectangular_pin.py:396-416``) with the routing-reward knobs
exposed.
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
    p.add_argument("--min_component_h", type=int, default=2)
    p.add_argument("--max_component_h", type=int, default=2)
    p.add_argument("--min_component_w", type=int, default=2)
    p.add_argument("--max_component_w", type=int, default=2)
    p.add_argument("--min_num_components", type=int, default=5)
    p.add_argument("--max_num_components", type=int, default=5)
    p.add_argument("--min_num_nets", type=int, default=3)
    p.add_argument("--max_num_nets", type=int, default=3)
    p.add_argument("--min_num_pins_per_net", type=int, default=2)
    p.add_argument("--max_num_pins_per_net", type=int, default=6)
    p.add_argument("--net_distribution", type=int, default=9)
    p.add_argument("--pin_spread", type=int, default=9)
    p.add_argument("--reward_type", default="centroid",
                   choices=["beam", "centroid", "both"])
    p.add_argument("--reward_beam_width", type=int, default=2)
    p.add_argument("--weight_wirelength", type=float, default=0.5)
    p.add_argument("--weight_num_intersections", type=float, default=0.5)
    p.add_argument("--spatial", action="store_true",
                   help="use the pin-spatial variant")
    p.add_argument("--n_episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    variant = Variant.PIN_SPATIAL if args.spatial else Variant.PIN
    kw = {k: v for k, v in vars(args).items()
          if k not in ("spatial", "n_episodes", "seed")}
    params = EnvParams(variant=variant, **kw).validate()
    returns = simulate(params, jax.random.PRNGKey(args.seed),
                       args.n_episodes)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = ("rect_pin_spatial" if args.spatial else "rect_pin")
    out = plot_episode_returns(
        list(map(float, returns)),
        os.path.join(RESULTS_DIR,
                     f"{name}_env_random_policy_episode_returns.png"),
        title=f"{name} env random policy episode returns")
    print(f"mean return {float(returns.mean()):.3f} over "
          f"{len(returns)} episodes -> {out}")


if __name__ == "__main__":
    main()
