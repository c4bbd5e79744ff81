"""Phase breakdown of the pooled fallback path at the web-app-max config.

VERDICT r4 weakness 1: ``web_max_pooled`` (30x30 grid, 40 components,
10 nets x <=10 pins — the web app's slider maximum,
``web_app/pages/2_Train_new_agent.py:29-44``) measures 66.5k env-steps/s on
the pooled path with no committed profile of WHERE the time goes. This tool
answers that with four isolated measurements on the GPU:

  pool_gen      make_pool alone (instance generation, amortized per chunk)
  step_full     the step scan with a pre-drawn pool (no generation)
  step_noroute  the same scan with ``routing.terminal_reward`` stubbed to a
                constant — isolates the per-step all-boards routing cost that
                ``core.step`` computes and discards for non-done boards
                (env/core.py:186-195, the VERDICT's prime suspect)
  chunk_shipped the shipped ``rollout_chunk`` (generation inside), i.e. the
                configuration bench_matrix.py measured at 66.5k

Reference anchor for the path being profiled: the per-step hot loop
``dummy_env_rectangular_pin.py:1846-1850`` and the episode-end routing loop
``:663-739``.

    python tools/pooled_profile.py [--batch 4096] [--inner 10] [--pool 4]

Writes experiments/results/pooled_profile_web_max.json.
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
       / "experiments/results/pooled_profile_web_max.json")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _note(msg):
    print(f"[pprof +{time.monotonic() - T_START:.0f}s] {msg}",
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


def _web_max_params():
    from placement_tpu.utils.config import load_experiment
    spatial, _, _ = load_experiment("rectangle_spatial_pin")
    return spatial.replace(
        height=30, width=30,
        min_component_h=2, max_component_h=5,
        min_component_w=2, max_component_w=5,
        min_num_components=40, max_num_components=40,
        min_num_nets=10, max_num_nets=10,
        min_num_pins_per_net=2, max_num_pins_per_net=10).validate()


def _dummy_states(env_params, batch):
    from placement_tpu.env import core
    shapes = jax.eval_shape(lambda k: core.reset(env_params, k),
                            jax.random.PRNGKey(0))
    states = jax.tree_util.tree_map(
        lambda s: jnp.zeros((batch,) + s.shape, s.dtype), shapes)
    return states.replace(done=jnp.ones((batch,), bool))


def _time_calls(call, state, budget_frac=0.15):
    """First (compile+run) call, then steady-state secs/call."""
    t0 = time.perf_counter()
    state, acc = call(state, jnp.zeros(()))
    float(acc)
    first = time.perf_counter() - t0
    n_calls = max(2, min(30, int(max(_remaining(), 5.0) * budget_frac
                                 / max(first, 1e-4))))
    acc = jnp.zeros(())
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state, acc = call(state, acc)
    float(acc)
    dt = time.perf_counter() - t0
    return first, dt / n_calls, n_calls


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--pool", type=int, default=4)
    p.add_argument("--slice-size", type=int, default=4)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import pooled, routing

    params = _web_max_params()
    batch, inner = args.batch, args.inner
    _note(f"devices={jax.devices()} batch={batch} inner={inner} "
          f"pool={args.pool}")
    results = {"batch": batch, "inner": inner, "pool_size": args.pool,
               "grid": [params.height, params.width], "phases": {}}

    def record(name, first, per_call, n_calls, steps_per_call):
        row = {"first_call_s": round(first, 3),
               "steady_s_per_call": round(per_call, 4),
               "n_calls": n_calls}
        if steps_per_call:
            row["steps_per_sec"] = round(batch * steps_per_call / per_call, 1)
        results["phases"][name] = row
        _note(f"{name}: first={first:.2f}s steady={per_call * 1e3:.1f}ms"
              + (f" -> {row['steps_per_sec']:.0f} steps/s"
                 if steps_per_call else ""))
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    # --- phase 1: pool generation alone ------------------------------------
    pool_fn = jax.jit(lambda k: pooled.make_pool(
        params, k, args.pool, batch, args.slice_size))

    def call_pool(state, acc):
        key = state
        key, k = jax.random.split(key)
        pool = pool_fn(k)
        return key, acc + pool.comp_h.sum().astype(jnp.float32)

    try:
        _phase(_remaining() - 60)
        first, per, n = _time_calls(call_pool, jax.random.PRNGKey(0))
        signal.alarm(0)
        record("pool_gen", first, per, n, 0)
        results["phases"]["pool_gen"]["boards_per_call"] = args.pool * batch
        results["phases"]["pool_gen"]["us_per_board"] = round(
            per * 1e6 / (args.pool * batch), 2)
    except PhaseTimeout:
        _note("pool_gen timed out")

    # --- step-scan chunks with a pre-drawn pool ----------------------------
    pool = pool_fn(jax.random.PRNGKey(3))
    pool = jax.tree_util.tree_map(jax.block_until_ready, pool)

    def make_step_chunk():
        def fn(states, key):
            counts = jnp.zeros((batch,), jnp.int32)

            def one(carry, _):
                states, counts, key = carry
                key, k = jax.random.split(key)
                actions = random_action(k, params, states.action_mask)
                states, counts, reward, done, _ = \
                    pooled.step_autoreset_pooled(
                        params, states, actions, pool, counts)
                return (states, counts, key), reward.sum()

            (states, counts, key), r = jax.lax.scan(
                one, (states, counts, key), None, length=inner)
            return states, key, r.sum()
        return jax.jit(fn)

    def run_chunk(chunk):
        def call(state, acc):
            states, key = state
            states, key, r = chunk(states, key)
            return (states, key), acc + r
        return _time_calls(call, (_dummy_states(params, batch),
                                  jax.random.PRNGKey(7)))

    try:
        _phase(_remaining() - 45)
        first, per, n = run_chunk(make_step_chunk())
        signal.alarm(0)
        record("step_full", first, per, n, inner)
    except PhaseTimeout:
        _note("step_full timed out")

    # --- the same scan with routing stubbed out ----------------------------
    real_terminal = routing.terminal_reward

    def stub(params_, abs_x, abs_y, pin_net, placed_all):
        z = jnp.zeros((), jnp.float32)
        return (jnp.where(placed_all, z, -1.0), z + 1.0, z + 1.0)

    routing.terminal_reward = stub
    try:
        _phase(_remaining() - 30)
        first, per, n = run_chunk(make_step_chunk())
        signal.alarm(0)
        record("step_noroute", first, per, n, inner)
    except PhaseTimeout:
        _note("step_noroute timed out")
    finally:
        routing.terminal_reward = real_terminal

    # --- the shipped chunk (generation inside), bench_matrix's config ------
    chunk = jax.jit(pooled.rollout_chunk(params, random_action, inner,
                                         args.pool, args.slice_size))

    def call_shipped(state, acc):
        states, key = state
        states, key, r, _, _ = chunk(states, key)
        return (states, key), acc + r

    try:
        _phase(_remaining() - 10)
        first, per, n = _time_calls(
            call_shipped, (_dummy_states(params, batch),
                           jax.random.PRNGKey(9)))
        signal.alarm(0)
        record("chunk_shipped", first, per, n, inner)
    except PhaseTimeout:
        _note("chunk_shipped timed out")

    print(json.dumps(results["phases"]), flush=True)


if __name__ == "__main__":
    main()
