"""North-star benchmark: env-steps/s per GPU, rectangular-pin env, 4096 boards.

Steps the flagship rectangle_pin configuration (configs/
rectangle_pin_model.json: 10x10 grid, five 2x2 components, 3 nets x 6 pins,
centroid reward) under a random legal policy with auto-reset — the batched
equivalent of the reference's random-policy rollout loop
(agent/random/random_policy_rectangular_pin.py:25-59), which is the pure-env
throughput the baseline targets (>= 100k env-steps/s per device).

The engine is the pooled auto-reset path with gated terminal routing
(env/pooled.py), the one PPO training uses.

Timing is honest: every chunk's output feeds the next chunk's input and an
accumulated-reward scalar is fetched to the host at the end, so asynchronous
dispatch cannot hide execution. Boards start as all-done dummy states that
the first (untimed) chunk replaces with generated instances, so no separate
reset program is compiled.

Runs only on a GPU; the card's name and power limit go to stderr.
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import math
import sys
import time

import jax
import jax.numpy as jnp

from placement_tpu.utils.compile_cache import enable_compile_cache
from placement_tpu.utils.device import card_description, require_gpu

BASELINE = 100_000.0  # env-steps/s per device target (BASELINE.md)
BATCH = 4096
INNER = 50            # env steps per chunk
TIMED_CHUNKS = 20


def dummy_states(env_params, batch):
    """All-done zero states (no generator compile): the first step of any
    auto-reset path replaces every board with a generated instance."""
    from placement_tpu.env import core
    shapes = jax.eval_shape(lambda k: core.reset(env_params, k),
                            jax.random.PRNGKey(0))
    states = jax.tree_util.tree_map(
        lambda s: jnp.zeros((batch,) + s.shape, s.dtype), shapes)
    return states.replace(done=jnp.ones((batch,), bool))


def bench_pooled(env_params) -> float:
    """Steady-state env-steps/s of chained pooled-rollout chunks."""
    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import pooled
    # route_budget: flagship episodes are exactly 5 placements, so 4 of 5
    # steps have zero finishers and skip the terminal routing entirely
    # (pooled.gated_terminal_rewards); the all-done step falls back to the
    # full batch. Values match eager to one f32 ulp.
    chunk = jax.jit(pooled.rollout_chunk(env_params, random_action, INNER,
                                         INNER // 5 + 2,
                                         route_budget=BATCH // 4))
    states, key = dummy_states(env_params, BATCH), jax.random.PRNGKey(7)
    states, key, racc, _, wraps = chunk(states, key)  # compile + first regen
    float(racc)
    t0 = time.perf_counter()
    for _ in range(TIMED_CHUNKS):
        states, key, r, _, w = chunk(states, key)
        racc, wraps = racc + r, wraps + w
    racc = float(racc)  # forces execution of every chained chunk
    dt = time.perf_counter() - t0
    if not math.isfinite(racc) or int(wraps):
        raise RuntimeError(f"pooled rollout: reward sum {racc}, "
                           f"{int(wraps)} pool wraps")
    return BATCH * INNER * TIMED_CHUNKS / dt


def main():
    from placement_tpu.utils.config import load_experiment

    enable_compile_cache()
    dev = require_gpu()
    print(f"devices={jax.devices()} kind={dev.device_kind!r}",
          file=sys.stderr, flush=True)
    print(f"card: {card_description()}", file=sys.stderr, flush=True)
    env_params, _, _ = load_experiment("rectangle_pin")
    per_device = bench_pooled(env_params)   # runs on the first device only
    print(json.dumps({
        "metric": "env_steps_per_sec_per_chip",
        "value": round(per_device, 1),
        "unit": (f"steps/s per {dev.device_kind} (rectangle_pin, {BATCH} "
                 f"boards, auto-reset, pooled engine)"),
        "vs_baseline": round(per_device / BASELINE, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
