"""The NumPy checkpoint writer: exact TrainState roundtrip, keep-N, and
refusal of a checkpoint whose tree does not match the target."""

import os

import jax
import numpy as np
import pytest

from placement_tpu.agent.policy import Policy, model_config_for
from placement_tpu.agent.ppo import PPOConfig, PPOLearner
from placement_tpu.env import EnvParams, Variant
from placement_tpu.utils.checkpoint import CheckpointManager

SQUARE = EnvParams(variant=Variant.SQUARE, height=5, width=5, component_n=2)


@pytest.fixture(scope="module")
def train_state():
    learner = PPOLearner(SQUARE, Policy(SQUARE, model_config_for(
        SQUARE, "square")), PPOConfig(num_envs=4, unroll_length=4,
                                      minibatch_size=8, num_sgd_iter=1))
    return learner.init(jax.random.PRNGKey(3))


def test_train_state_roundtrip_is_bit_exact(tmp_path, train_state):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(7, train_state)
    assert os.path.isdir(tmp_path / "checkpoint_7")
    restored = mgr.restore(train_state)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(train_state))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(train_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keep_n_prunes_oldest_and_tracks_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval=2)
    tree = {"w": np.zeros(3, np.float32)}
    assert mgr.latest_step() is None
    saved = [mgr.save(step, tree) for step in range(1, 7)]
    assert saved == [False, True, False, True, False, True]
    assert mgr.save(7, tree, force=True)
    assert mgr.all_steps() == [6, 7]
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_6", "checkpoint_7"]


def test_restore_refuses_a_mismatched_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.zeros((2, 3), np.float32), "n": np.int32(0)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"w": np.zeros((3, 2), np.float32), "n": np.int32(0)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"w": np.zeros((2, 3), np.float64), "n": np.int32(0)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"v": np.zeros((2, 3), np.float32), "n": np.int32(0)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})
