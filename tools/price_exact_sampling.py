"""Measure what ``exact_sampling=True`` actually costs (VERDICT r4 item 3).

The fidelity guard (``env/fidelity.py``) tells users entering cap-bound
sampling regimes that the fix is ``exact_sampling=True`` — reference-process
instance sampling (``sample_truncated_multinomial``,
dummy_env_rectangular_pin.py:258-295) via a sequential per-trial
``lax.scan``/``while_loop`` (``generator._capped_multinomial_exact`` and the
exact per-net allocator round loop) instead of the vectorized
draw-clip-waterfill rounds. A recommendation with an unpriced cost is half a
recommendation, so this tool measures both modes on the GPU:

  * instance generation alone (``pooled.make_pool``) — µs/board both ways
  * a full pooled rollout chunk (generation + stepping) at training-like
    scale — steps/s both ways

on the flagship ``rectangle_pin`` config (area-tight: 18 pins over ~20
cells, the regime the guard talks about) and the web-app maximum.

    python tools/price_exact_sampling.py

Writes experiments/results/exact_sampling_price.json.
"""

import argparse
import json
import os
import pathlib
import signal
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

T_START = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "520"))
OUT = (pathlib.Path(__file__).resolve().parents[1]
       / "experiments/results/exact_sampling_price.json")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _note(msg):
    print(f"[price +{time.monotonic() - T_START:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def _remaining():
    return BUDGET_S - (time.monotonic() - T_START)


class PhaseTimeout(Exception):
    pass


def _on_alarm(*_):
    raise PhaseTimeout()


def _phase(seconds):
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(int(min(seconds, _remaining())), 1))


def _dummy_states(env_params, batch):
    from placement_tpu.env import core
    shapes = jax.eval_shape(lambda k: core.reset(env_params, k),
                            jax.random.PRNGKey(0))
    states = jax.tree_util.tree_map(
        lambda s: jnp.zeros((batch,) + s.shape, s.dtype), shapes)
    return states.replace(done=jnp.ones((batch,), bool))


def _time_calls(call, state, budget_frac=0.12):
    t0 = time.perf_counter()
    state, acc = call(state, jnp.zeros(()))
    float(acc)
    first = time.perf_counter() - t0
    n_calls = max(2, min(25, int(max(_remaining(), 5.0) * budget_frac
                                 / max(first, 1e-4))))
    acc = jnp.zeros(())
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state, acc = call(state, acc)
    float(acc)
    return first, (time.perf_counter() - t0) / n_calls


def measure_config(name, params, batch, pool_size, chunk, results,
                   out_path, route_budget=None, slice_size=4):
    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import pooled

    row = {"batch": batch, "pool_size": pool_size, "chunk_steps": chunk}
    for mode in ("fast", "exact"):
        p = params.replace(exact_sampling=(mode == "exact")).validate()

        pool_fn = jax.jit(lambda k, p=p: pooled.make_pool(
            p, k, pool_size, batch, slice_size))

        def call_pool(state, acc):
            key = state
            key, k = jax.random.split(key)
            pool = pool_fn(k)
            return key, acc + pool.comp_h.sum().astype(jnp.float32)

        try:
            _phase(min(_remaining() - 30, 170))
            first, per = _time_calls(call_pool, jax.random.PRNGKey(1))
            signal.alarm(0)
            row[f"gen_{mode}_us_per_board"] = round(
                per * 1e6 / (pool_size * batch), 2)
            row[f"gen_{mode}_first_call_s"] = round(first, 2)
            _note(f"{name}/{mode}: gen {row[f'gen_{mode}_us_per_board']}"
                  f" us/board (first {first:.1f}s)")
        except PhaseTimeout:
            _note(f"{name}/{mode}: generation phase timed out")
            continue

        chunk_fn = jax.jit(pooled.rollout_chunk(
            p, random_action, chunk, pool_size, slice_size,
            route_budget=route_budget))

        def call_chunk(state, acc):
            states, key = state
            states, key, r, _, _ = chunk_fn(states, key)
            return (states, key), acc + r

        try:
            _phase(min(_remaining() - 15, 170))
            first, per = _time_calls(
                call_chunk, (_dummy_states(p, batch), jax.random.PRNGKey(2)))
            signal.alarm(0)
            row[f"rollout_{mode}_steps_per_sec"] = round(batch * chunk / per, 1)
            _note(f"{name}/{mode}: rollout "
                  f"{row[f'rollout_{mode}_steps_per_sec']:.0f} steps/s")
        except PhaseTimeout:
            _note(f"{name}/{mode}: rollout phase timed out")

    if ("gen_fast_us_per_board" in row and "gen_exact_us_per_board" in row):
        row["gen_slowdown_x"] = round(
            row["gen_exact_us_per_board"] / row["gen_fast_us_per_board"], 1)
    if ("rollout_fast_steps_per_sec" in row
            and "rollout_exact_steps_per_sec" in row):
        row["rollout_slowdown_x"] = round(
            row["rollout_fast_steps_per_sec"]
            / row["rollout_exact_steps_per_sec"], 1)
    results["configs"][name] = row
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from placement_tpu.utils.config import load_experiment

    pin, _, _ = load_experiment("rectangle_pin")
    spatial, _, _ = load_experiment("rectangle_spatial_pin")
    web_max = spatial.replace(
        height=30, width=30,
        min_component_h=2, max_component_h=5,
        min_component_w=2, max_component_w=5,
        min_num_components=40, max_num_components=40,
        min_num_nets=10, max_num_nets=10,
        min_num_pins_per_net=2, max_num_pins_per_net=10).validate()

    results = {"device": str(jax.devices()[0]), "configs": {}}
    _note(f"devices={jax.devices()}")
    # flagship: 5-step episodes, training-like pool depth
    measure_config("rectangle_pin", pin, args.batch, pool_size=12, chunk=50,
                   results=results, out_path=args.out)
    if _remaining() > 120:
        measure_config("web_max", web_max, args.batch, pool_size=2, chunk=50,
                       results=results, out_path=args.out, route_budget=256,
                       slice_size=2)
    print(json.dumps(results["configs"]), flush=True)


if __name__ == "__main__":
    main()
