"""Trainer / checkpoint / metrics / rollout-export tests.

The reference has no tests for this layer; these cover this package's
replacements for Ray Tune checkpointing (experiments/PPO/PPO.py:39-47),
progress.csv + TensorBoard logging, and the rollout exporter
(utils/agent/utils.py:154-259).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from placement_tpu.agent.ppo import PPOConfig
from placement_tpu.agent.trainer import Trainer, latest_run_dir
from placement_tpu.utils.metrics import read_progress
from placement_tpu.viz.rollout import (generate_rollouts, load_pickle,
                                       sample_rollout)

TINY = PPOConfig(num_envs=4, unroll_length=4, minibatch_size=8,
                 num_sgd_iter=2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("results"))
    trainer = Trainer("rectangle_pin", results_root=root, ppo_config=TINY,
                      run_name="PPO_rectangle_pin_test")
    result = trainer.run(num_iterations=2, seed=0)
    yield trainer, result, root
    trainer.close()


def test_progress_csv_columns(run):
    trainer, result, _ = run
    cols = read_progress(result.run_dir)
    assert len(cols["training_iteration"]) == 2
    for name in ("episode_reward_mean", "timesteps_total",
                 "custom_metrics/normalized_wirelengths_mean",
                 "custom_metrics/num_intersections_mean", "kl", "vf_loss"):
        assert name in cols, name
    assert cols["timesteps_total"][-1] == 2 * TINY.train_batch


def test_tensorboard_events_written(run):
    _, result, _ = run
    assert glob.glob(os.path.join(result.run_dir, "events.out.tfevents*"))


def test_params_json_written(run):
    trainer, result, _ = run
    import json
    with open(os.path.join(result.run_dir, "params.json")) as f:
        payload = json.load(f)
    assert payload["model_type"] == "rectangle_pin"
    assert payload["ppo"]["num_envs"] == TINY.num_envs
    assert payload["env_config"]["height"] == trainer.env_params.height


def test_checkpoint_restore_roundtrip(run):
    trainer, result, _ = run
    restored = trainer.restore()
    leaves_a = jax.tree_util.tree_leaves(result.state.variables)
    leaves_b = jax.tree_util.tree_leaves(restored.variables)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(restored.steps) == int(result.state.steps)
    # restored state trains further without error
    state, metrics = trainer.learner.jitted_train_step()(restored)
    assert np.isfinite(float(metrics["episode_reward_mean"]))


def test_keep_n_checkpoints(tmp_path):
    trainer = Trainer("square", results_root=str(tmp_path), ppo_config=TINY,
                      keep_checkpoints=2, run_name="PPO_square_keep")
    trainer.run(num_iterations=4, seed=0)
    assert len(trainer.ckpt.all_steps()) <= 2
    assert trainer.ckpt.latest_step() == 4
    trainer.close()


def test_latest_run_dir(run):
    _, result, root = run
    assert latest_run_dir("rectangle_pin", results_root=root) \
        == result.run_dir


def test_rollout_export(run):
    trainer, result, _ = run
    comps, actions, infos = sample_rollout(
        trainer.env_params, trainer.policy, result.state.variables,
        num_samples=2, seed=0)
    assert len(comps) == len(actions) == len(infos) == 2
    for comp_list, act_list in zip(comps, actions):
        n = int(trainer.env_params.max_num_components)
        assert len(comp_list) == n  # fixed count in flagship config
        assert 1 <= len(act_list) <= n
        for o, x, y in act_list:
            assert 0 <= o < trainer.env_params.num_orientations
            assert 0 <= x < trainer.env_params.height
            assert 0 <= y < trainer.env_params.width
        total_pins = sum(len(c.pins) for c in comp_list)
        assert total_pins >= 2 * trainer.env_params.min_num_nets

    run_dir = generate_rollouts(trainer, state=result.state, num_samples=2)
    params, loaded_actions, loaded_comps = load_pickle(run_dir)
    assert params["model_type"] == "rectangle_pin"
    assert len(loaded_actions) == 2 and len(loaded_comps) == 2
    assert os.path.exists(os.path.join(run_dir, "rectangle_pin.csv"))


def test_render_smoke(run):
    import matplotlib
    matplotlib.use("Agg")
    from placement_tpu.viz.grid import render

    trainer, result, _ = run
    comps, actions, _ = sample_rollout(
        trainer.env_params, trainer.policy, result.state.variables,
        num_samples=1, seed=1)
    fig = render(trainer.env_params.height, trainer.env_params.width,
                 comps[0], actions[0])
    assert fig is not None
    import matplotlib.pyplot as plt
    plt.close(fig)


def test_random_policy_plot(tmp_path):
    from placement_tpu.agent.random_policy import simulate
    from placement_tpu.env.types import EnvParams, Variant
    from placement_tpu.viz.grid import plot_episode_returns

    params = EnvParams(variant=Variant.SQUARE, height=5, width=5,
                       component_n=2).validate()
    returns = simulate(params, jax.random.PRNGKey(0), 16)
    out = plot_episode_returns(list(map(float, returns)),
                               str(tmp_path / "returns.png"))
    assert os.path.exists(out)


def test_resume_is_bit_identical_to_uninterrupted_run(tmp_path):
    """checkpoint.py's contract: 'a restored run continues bit-identically'.
    Train 3 iterations straight; separately train 2, checkpoint, restore
    into a FRESH trainer, train 1 more — iteration-3 metrics must be
    bit-equal (the checkpoint carries the full TrainState: params,
    optimizer, env states, PRNG key, accumulators)."""
    a = Trainer("square", results_root=str(tmp_path), ppo_config=TINY,
                use_tensorboard=False, run_name="PPO_square_straight")
    rows_a = []
    a.run(num_iterations=3, seed=0,
          on_iteration=lambda it, row: rows_a.append(dict(row)))
    a.close()

    b = Trainer("square", results_root=str(tmp_path), ppo_config=TINY,
                use_tensorboard=False, run_name="PPO_square_part1")
    b.run(num_iterations=2, seed=0)
    b.close()
    c = Trainer("square", results_root=str(tmp_path), ppo_config=TINY,
                use_tensorboard=False, run_name="PPO_square_resumed")
    state = c.restore(run_dir=b.run_dir, seed=0)
    rows_c = []
    c.run(num_iterations=1, seed=0, state=state,
          on_iteration=lambda it, row: rows_c.append(dict(row)))
    c.close()

    assert rows_c[0]["training_iteration"] == 3
    skip = {"time_total_s"}                       # wall clock, not state
    for k, v in rows_a[2].items():
        if k in skip:
            continue
        assert rows_c[0][k] == v, (k, rows_c[0][k], v)
