"""Smoke test of the system on an NVIDIA GPU, through its normal entry points.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the data-parallel trainer on four

Phases on one card:

1. Device: JAX's first device must be a GPU; prints the devices, the device
   kind, and the card's name and power limit from ``nvidia-smi``.
2. Env stepping through the engine training uses (``env/pooled`` with
   random legal actions and auto-reset): the flagship ``rectangle_pin`` at
   4096 boards (env-steps/s), one chunk of the web app's largest board at
   1024 boards, and the same keys stepped on the GPU and on the CPU, which
   must give the same boards exactly and rewards to 1e-5.
3. Policy forward of the ``rectangle_spatial_pin`` preset on 4096
   observations, on the GPU and on the CPU: equal to 1e-5 under "highest"
   matmul precision, and within ``TF32_BOUND`` under the default (TF32).
4. PPO training through ``agent.trainer.Trainer``: the full-size job
   (4096 envs, ``num_sgd_iter=10``) for two iterations, a checkpoint
   restored into a fresh trainer that trains one more, and a small job
   whose metrics on the GPU and on the CPU agree to ``rtol=2e-3``.

``--four-cards`` runs only the data-parallel trainer over a 4-card mesh
(4096 envs per card, each card holding a quarter of the env batch) and the
small sharded job against the one-card job from the same seed.

Every check raises on failure, so the script exits non-zero; only when all
pass does it print, as its last line,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import math
import shutil
import tempfile
import time

import numpy as np

BOARDS = 4096           # flagship board count and full-size num_envs
WEB_MAX_BOARDS = 1024
CHECK_BOARDS, CHECK_STEPS = 64, 60
EXACT = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=2e-3, atol=1e-5)   # tests/parallel/test_mesh.py
# Largest |GPU - CPU| of the policy outputs under the default precision,
# as a fraction of max(1, largest |CPU output|). TF32 rounds each operand
# of a product to 10 mantissa bits (relative error 2^-11 ~ 5e-4); the
# spatial preset chains about five matmul or conv layers, so errors of a
# few 1e-3 of the output scale are expected.
TF32_BOUND = 1e-2
FULL_SGD_ITER = 10      # the validated faster preset (README.md)
FULL_UNROLL = 32        # PPOConfig's default
SMALL_JOB = dict(num_envs=64, unroll_length=8, minibatch_size=128,
                 num_sgd_iter=2)
TIME_KEYS = ("time_total_s",)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ------------------------------------------------------------------

def phase_device(count: int):
    import jax

    from placement_tpu.utils.device import card_description, require_gpu

    dev = require_gpu()
    devices = jax.devices()
    log(f"devices: {devices}")
    log(f"device_kind: {dev.device_kind}")
    card = card_description()
    log(card)
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, found {len(devices)}")
    return dev, card.splitlines()[0]


# -- phase 2 ------------------------------------------------------------------

def web_max_params():
    """The web app's slider maximum (web_app/pages/2_Train_new_agent.py)."""
    from placement_tpu.utils.config import load_experiment
    params, _, _ = load_experiment("rectangle_pin")
    return params.replace(
        height=30, width=30, min_component_h=2, max_component_h=5,
        min_component_w=2, max_component_w=5, min_num_components=40,
        max_num_components=40, min_num_nets=10, max_num_nets=10,
        min_num_pins_per_net=2, max_num_pins_per_net=10,
        reward_type="both", reward_beam_width=6).validate()


def phase_env_flagship(card: str) -> None:
    import bench
    from placement_tpu.utils.config import load_experiment

    params, _, _ = load_experiment("rectangle_pin")
    sps = bench.bench_pooled(params)
    log(f"flagship rectangle_pin, {bench.BATCH} boards, {bench.INNER}-step "
        f"chunks x {bench.TIMED_CHUNKS}: {sps:.1f} env-steps/s on {card}")


def phase_env_web_max(card: str) -> None:
    import jax

    from bench import dummy_states
    from placement_tpu.agent.ppo import default_pool_size
    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import pooled

    params = web_max_params()
    steps = 50
    chunk = jax.jit(pooled.rollout_chunk(
        params, random_action, steps, default_pool_size(params, steps),
        route_budget=max(WEB_MAX_BOARDS // 8, 16)))   # the web app's rule
    t0 = time.perf_counter()
    states, key, rsum, dsum, wraps = chunk(
        dummy_states(params, WEB_MAX_BOARDS), jax.random.PRNGKey(3))
    rsum, dsum, wraps = float(rsum), int(dsum), int(wraps)
    first = time.perf_counter() - t0
    if not math.isfinite(rsum) or dsum == 0 or wraps:
        raise RuntimeError(f"web-max chunk: reward sum {rsum}, {dsum} "
                           f"episodes done, {wraps} pool wraps")
    t0 = time.perf_counter()
    _, _, r2, _, _ = chunk(states, key)
    float(r2)
    dt = time.perf_counter() - t0
    log(f"web-max 30x30/40 comps/10 nets/beam 6/'both', {WEB_MAX_BOARDS} "
        f"boards: first chunk (compile + run) {first:.1f} s, {dsum} "
        f"episodes, reward sum {rsum:.3f}; second chunk "
        f"{WEB_MAX_BOARDS * steps / dt:.1f} env-steps/s on {card}")


def _trajectory_fn(params):
    """jit(key -> per-step records) of CHECK_BOARDS boards stepped
    CHECK_STEPS times by random legal actions with pooled auto-reset."""
    import jax
    import jax.numpy as jnp

    from placement_tpu.agent.ppo import default_pool_size
    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import core, pooled
    from placement_tpu.env.types import Variant

    spatial = params.variant == Variant.PIN_SPATIAL

    def run(key):
        k_reset, k_pool, k_act = jax.random.split(key, 3)
        states = jax.vmap(lambda k: core.reset(params, k))(
            jax.random.split(k_reset, CHECK_BOARDS))
        pool = pooled.make_pool(params, k_pool,
                                default_pool_size(params, CHECK_STEPS),
                                CHECK_BOARDS)

        def one(carry, k):
            states, counts = carry
            actions = random_action(k, params, states.action_mask)
            states, counts, reward, done, _ = pooled.step_autoreset_pooled(
                params, states, actions, pool, counts)
            rec = {"state": states, "reward": reward, "done": done}
            if spatial:
                obs = jax.vmap(lambda s: core.observe(params, s))(states)
                rec["pin_grid"] = obs["pin_grid"]
                rec["component_grid"] = obs["component_grid"]
            return (states, counts), rec

        counts = jnp.zeros((CHECK_BOARDS,), jnp.int32)
        _, recs = jax.lax.scan(one, (states, counts),
                               jax.random.split(k_act, CHECK_STEPS))
        return recs

    return jax.jit(run)


def _compare_trajectories(name, gpu, cpu) -> float:
    """Integer and boolean leaves and the observation planes exactly; the
    float reward terms to EXACT (f32 summation order in env/routing.py,
    which does not feed back into the state)."""
    import jax

    worst = 0.0
    for (path, g), c in zip(jax.tree_util.tree_leaves_with_path(gpu),
                            jax.tree_util.tree_leaves(cpu), strict=True):
        key = jax.tree_util.keystr(path)
        g, c = np.asarray(g), np.asarray(c)
        if key.startswith("['reward']") or "info_" in key:
            np.testing.assert_allclose(g, c, err_msg=f"{name} {key}",
                                       **EXACT)
            worst = max(worst, float(np.max(np.abs(g - c), initial=0.0)))
        else:
            np.testing.assert_array_equal(g, c, err_msg=f"{name} {key}")
    return worst


def phase_env_gpu_vs_cpu() -> None:
    import jax

    from placement_tpu.utils.config import load_experiment

    pin, _, _ = load_experiment("rectangle_pin")
    spatial, _, _ = load_experiment("rectangle_spatial_pin")
    cases = [(f"rectangle_pin/{r}", pin.replace(reward_type=r))
             for r in ("centroid", "beam", "both")]
    cases.append(("rectangle_spatial_pin", spatial))
    gpu_dev, cpu_dev = jax.devices()[0], jax.devices("cpu")[0]
    for name, params in cases:
        fn = _trajectory_fn(params)
        key = jax.random.PRNGKey(11)
        gpu = fn(jax.device_put(key, gpu_dev))
        cpu = fn(jax.device_put(key, cpu_dev))
        worst = _compare_trajectories(name, gpu, cpu)
        dones = int(np.asarray(gpu["done"]).sum())
        log(f"env GPU == CPU: {name}, {CHECK_BOARDS} boards x {CHECK_STEPS} "
            f"steps, {dones} episodes: states equal, max |reward diff| "
            f"{worst:.3g}")


# -- phase 3 ------------------------------------------------------------------

def spatial_observations(params, batch: int):
    """``batch`` mid-episode observations of ``params``' boards on the GPU."""
    import jax

    from placement_tpu.agent.random_policy import random_action
    from placement_tpu.env import core

    @jax.jit
    def obs_after(key):
        k_reset, k1, k2 = jax.random.split(key, 3)
        states = jax.vmap(lambda k: core.reset(params, k))(
            jax.random.split(k_reset, batch))
        for k in (k1, k2):
            actions = random_action(k, params, states.action_mask)
            states, _, _, _ = jax.vmap(
                lambda s, a: core.step_autoreset(params, s, a))(
                    states, actions)
        return jax.vmap(lambda s: core.observe(params, s))(states)

    return obs_after(jax.random.PRNGKey(5))


def phase_policy() -> None:
    import jax

    from placement_tpu.agent.policy import Policy
    from placement_tpu.utils.config import load_experiment

    params, model_cfg, _ = load_experiment("rectangle_spatial_pin")
    policy = Policy(params, model_cfg)
    obs = spatial_observations(params, BOARDS)
    variables = policy.init(jax.random.PRNGKey(0), obs)
    cpu_dev = jax.devices("cpu")[0]
    obs_cpu, vars_cpu = jax.device_put((obs, variables), cpu_dev)
    fwd = jax.jit(lambda v, o: policy.model.apply(v, o)[0])
    valid = np.asarray(obs["action_mask"]).reshape(BOARDS, -1) > 0

    def outputs(out):
        out = jax.tree_util.tree_map(np.asarray, out)
        return out["logits"], out["value"]

    with jax.default_matmul_precision("highest"):
        gl, gv = outputs(fwd(variables, obs))
        cl, cv = outputs(fwd(vars_cpu, obs_cpu))
    np.testing.assert_allclose(gl, cl, err_msg="logits", **EXACT)
    np.testing.assert_allclose(gv, cv, err_msg="value", **EXACT)
    hi = max(np.max(np.abs(gl[valid] - cl[valid])), np.max(np.abs(gv - cv)))
    log(f"policy rectangle_spatial_pin x {BOARDS}, 'highest': max |GPU-CPU| "
        f"{hi:.3g} (valid logits and value)")

    dl, dv = outputs(fwd(variables, obs))
    diff = max(np.max(np.abs(dl[valid] - cl[valid])), np.max(np.abs(dv - cv)))
    scale = max(1.0, np.max(np.abs(cl[valid])), np.max(np.abs(cv)))
    log(f"policy default precision (TF32): max |GPU-CPU| {diff:.3g}, "
        f"{diff / scale:.3g} of scale {scale:.3g} (bound {TF32_BOUND})")
    if not diff / scale <= TF32_BOUND:
        raise RuntimeError(f"TF32 policy difference {diff / scale:.3g} of "
                           f"the output scale exceeds {TF32_BOUND}")


# -- phase 4 ------------------------------------------------------------------

def _train(root, name, cfg, iterations, mesh=None, restore_from=None):
    """Train through Trainer, from seed 0 or from ``restore_from``'s newest
    checkpoint; -> (trainer, result, rows, seconds per iteration)."""
    from placement_tpu.agent.trainer import Trainer

    trainer = Trainer("rectangle_spatial_pin", results_root=root,
                      ppo_config=cfg, use_tensorboard=False, run_name=name,
                      mesh=mesh)
    state = (None if restore_from is None
             else trainer.restore(run_dir=restore_from))
    rows, stamps = [], [time.perf_counter()]

    def on_iteration(it, row):
        rows.append(dict(row))
        stamps.append(time.perf_counter())

    result = trainer.run(num_iterations=iterations, seed=0, state=state,
                         on_iteration=on_iteration)
    trainer.close()
    return trainer, result, rows, np.diff(stamps)


def _check_rows(name, rows) -> None:
    for row in rows:
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        if bad or row["pool_wraps"] != 0:
            raise RuntimeError(f"{name}: non-finite {bad}, "
                               f"pool_wraps {row['pool_wraps']}")


def _compare_rows(name, rows_a, rows_b) -> None:
    for a, b in zip(rows_a, rows_b, strict=True):
        for k in a:
            if k not in TIME_KEYS:
                np.testing.assert_allclose(a[k], b[k], err_msg=f"{name} {k}",
                                           **TRAIN_TOL)


def phase_training(card: str) -> None:
    import jax

    from placement_tpu.agent.ppo import PPOConfig

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = PPOConfig(num_envs=BOARDS, unroll_length=FULL_UNROLL,
                        minibatch_size=128, num_sgd_iter=FULL_SGD_ITER)
        first, res, rows, secs = _train(root, "full", cfg, 2)
        _check_rows("full-size", rows)
        log(f"train rectangle_spatial_pin {BOARDS} envs x unroll "
            f"{FULL_UNROLL}, num_sgd_iter {FULL_SGD_ITER}: iteration "
            f"seconds {[round(float(s), 2) for s in secs]} (first compiles), "
            f"{cfg.train_batch / secs[-1]:.1f} env-steps/s on {card}; "
            f"episode_reward_mean {rows[-1]['episode_reward_mean']:.4f}")
        _, res2, rows2, _ = _train(root, "resumed", cfg, 1,
                                   restore_from=first.run_dir)
        _check_rows("resumed", rows2)
        if (rows2[0]["training_iteration"] != 3
                or int(res2.state.steps) != 3 * cfg.train_batch):
            raise RuntimeError(
                f"restored run did not continue: iteration "
                f"{rows2[0]['training_iteration']}, steps "
                f"{int(res2.state.steps)}")
        log(f"checkpoint restored into a fresh Trainer; iteration 3 at "
            f"{int(res2.state.steps)} steps")

        small = PPOConfig(**SMALL_JOB)
        with jax.default_matmul_precision("highest"):
            _, _, gpu_rows, _ = _train(root, "small_gpu", small, 2)
            with jax.default_device(jax.devices("cpu")[0]):
                _, _, cpu_rows, _ = _train(root, "small_cpu", small, 2)
        _compare_rows("small job GPU vs CPU", gpu_rows, cpu_rows)
        log(f"train small job GPU == CPU ('highest', rtol 2e-3): "
            f"episode_reward_mean {gpu_rows[-1]['episode_reward_mean']:.6f}"
            f" vs {cpu_rows[-1]['episode_reward_mean']:.6f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- four cards ---------------------------------------------------------------

def phase_four_cards(card: str) -> None:
    import jax

    from placement_tpu.agent.ppo import PPOConfig
    from placement_tpu.parallel.mesh import make_mesh

    devices = jax.devices()[:4]
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = PPOConfig(num_envs=4 * BOARDS, unroll_length=FULL_UNROLL,
                        minibatch_size=128, num_sgd_iter=FULL_SGD_ITER)
        _, res, rows, secs = _train(root, "dp4", cfg, 2, mesh=make_mesh(4))
        _check_rows("4-card", rows)
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                res.state.env_states):
            shards = {s.device: s.data.shape for s in leaf.addressable_shards}
            if (set(shards) != set(devices)
                    or any(sh[0] != BOARDS for sh in shards.values())):
                raise RuntimeError(
                    f"env_states{jax.tree_util.keystr(path)} is not split "
                    f"in quarters over the 4 cards: {shards}")
        grid = res.state.env_states.grid
        log(f"4-card mesh: env_states.grid {grid.shape} held as "
            f"{[(str(s.device), s.data.shape) for s in grid.addressable_shards]}")
        log(f"train rectangle_spatial_pin {cfg.num_envs} envs on 4 cards x "
            f"unroll {FULL_UNROLL}, num_sgd_iter {FULL_SGD_ITER}: "
            f"iteration seconds {[round(float(s), 2) for s in secs]} (first "
            f"compiles), {cfg.train_batch / secs[-1]:.1f} env-steps/s on "
            f"4 x {card}")

        small = PPOConfig(**SMALL_JOB)
        with jax.default_matmul_precision("highest"):
            _, _, one_rows, _ = _train(root, "small_1", small, 1)
            _, _, dp_rows, _ = _train(root, "small_4", small, 1,
                                      mesh=make_mesh(4))
        _compare_rows("small job 4-card vs 1-card", dp_rows, one_rows)
        log(f"train small job 4-card == 1-card ('highest', rtol 2e-3): "
            f"episode_reward_mean {dp_rows[-1]['episode_reward_mean']:.6f} "
            f"vs {one_rows[-1]['episode_reward_mean']:.6f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    p = argparse.ArgumentParser(
        description="Run the system's main path on the GPU and check it "
                    "against the CPU.")
    p.add_argument("--four-cards", action="store_true",
                   help="run only the data-parallel trainer over 4 GPUs "
                        "and its comparison with one GPU")
    args = p.parse_args()

    from placement_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    count = 4 if args.four_cards else 1
    dev, card = phase_device(count)
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_env_flagship(card)
        phase_env_web_max(card)
        phase_env_gpu_vs_cpu()
        phase_policy()
        phase_training(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
