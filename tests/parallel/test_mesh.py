"""Multi-device mesh tests on the 8-device virtual CPU mesh (conftest.py).

Covers what the driver's dryrun validates, in-repo: a data-parallel Mesh
over all 8 devices, the full PPO train step jitted over it with the
production shardings (boards on ``dp``, replicated params, psum-reduced
metrics/grads), env-batch sharding round-trips, and the
``__graft_entry__.dryrun_multichip`` path itself.
"""

import sys
import pathlib

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from placement_tpu.agent.policy import Policy, model_config_for
from placement_tpu.agent.ppo import PPOConfig, PPOLearner
from placement_tpu.env import EnvParams, Variant, core
from placement_tpu.parallel import mesh as pmesh

PIN = EnvParams(variant=Variant.PIN, height=6, width=6,
                min_component_w=2, max_component_w=3,
                min_component_h=2, max_component_h=3,
                max_num_components=3, min_num_components=2,
                min_num_nets=2, max_num_nets=2,
                min_num_pins_per_net=2, max_num_pins_per_net=3,
                reward_type="centroid")

CFG = PPOConfig(num_envs=16, unroll_length=8, minibatch_size=16,
                num_sgd_iter=2)


def _learner():
    pol = Policy(PIN, model_config_for(PIN, "rectangle_pin"))
    return PPOLearner(PIN, pol, CFG)


def test_make_mesh_spans_devices():
    mesh = pmesh.make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == (pmesh.DATA_AXIS,)


def test_env_batch_sharding_roundtrip():
    mesh = pmesh.make_mesh(8)
    reset_b = jax.jit(jax.vmap(lambda k: core.reset(PIN, k)))
    states = reset_b(jax.random.split(jax.random.PRNGKey(0), 16))
    host = jax.tree_util.tree_map(np.asarray, states)

    sharded = pmesh.shard_env_batch(mesh, states)
    grid_sharding = sharded.grid.sharding
    assert grid_sharding.is_equivalent_to(
        NamedSharding(mesh, P(pmesh.DATA_AXIS)), sharded.grid.ndim)
    # values untouched by the relayout
    np.testing.assert_array_equal(np.asarray(sharded.grid), host.grid)

    # a vmapped step runs on the sharded batch and keeps the layout
    step_b = jax.jit(jax.vmap(lambda s, a: core.step_autoreset(PIN, s, a)))
    from placement_tpu.agent.random_policy import random_action
    actions = random_action(jax.random.PRNGKey(1), PIN, sharded.action_mask)
    out, reward, done, _ = step_b(sharded, actions)
    assert out.grid.sharding.is_equivalent_to(
        NamedSharding(mesh, P(pmesh.DATA_AXIS)), out.grid.ndim)
    assert np.isfinite(np.asarray(reward)).all()


@pytest.mark.slow
def test_sharded_train_step_matches_unsharded():
    """The dp-sharded train step computes the same metrics as the
    single-device step from the same initial state (f32 reduction-order
    tolerance only)."""
    learner = _learner()
    state = learner.init(jax.random.PRNGKey(42))

    # unsharded baseline
    base_step = jax.jit(learner.train_step)
    _, base_metrics = base_step(state)

    mesh = pmesh.make_mesh(8)
    place, train_step = pmesh.shard_learner(learner, mesh)
    sharded_state = place(learner.init(jax.random.PRNGKey(42)))
    assert sharded_state.env_states.grid.sharding.is_equivalent_to(
        NamedSharding(mesh, P(pmesh.DATA_AXIS)),
        sharded_state.env_states.grid.ndim)
    new_state, metrics = train_step(sharded_state)

    for k in ("episode_reward_mean", "episodes_this_iter", "policy_loss",
              "vf_loss", "kl", "normalized_wirelengths_mean"):
        np.testing.assert_allclose(
            np.asarray(metrics[k]), np.asarray(base_metrics[k]),
            rtol=2e-3, atol=1e-5, err_msg=k)

    # a second step still runs (state pytree keeps consistent shardings)
    _, metrics2 = train_step(new_state)
    assert np.isfinite(float(metrics2["policy_loss"]))


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    """The driver's multichip dryrun must never regress silently."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_trainer_with_mesh_and_profiler(tmp_path):
    """The Trainer's mesh + profiling wiring (experiments/ppo.py
    --data-parallel / --profile-dir): 2 iterations on the 8-device mesh
    produce finite metrics, and the jax.profiler trace lands on disk."""
    from placement_tpu.agent.trainer import Trainer

    mesh = pmesh.make_mesh(8)
    trainer = Trainer(
        "rectangle_pin",
        results_root=str(tmp_path),
        ppo_config=PPOConfig(num_envs=16, unroll_length=8,
                             minibatch_size=16, num_sgd_iter=2),
        env_overrides=dict(height=6, width=6,
                           min_component_w=2, max_component_w=3,
                           min_component_h=2, max_component_h=3,
                           max_num_components=3, min_num_components=2,
                           min_num_nets=2, max_num_nets=2,
                           min_num_pins_per_net=2, max_num_pins_per_net=3,
                           reward_type="centroid"),
        use_tensorboard=False,
        mesh=mesh,
        profile_dir=str(tmp_path / "trace"))
    rows = []
    trainer.run(num_iterations=3, seed=0,
                on_iteration=lambda it, row: rows.append(row))
    trainer.close()
    assert len(rows) == 3
    assert np.isfinite(rows[-1]["episode_reward_mean"])
    trace_files = list((tmp_path / "trace").rglob("*"))
    assert any(f.is_file() for f in trace_files), trace_files


# ---------------------------------------------------------------------------
# Partitioning evidence (VERDICT r3 item 4): prove GSPMD actually shards the
# rollout instead of silently replicating it — via compiled per-device
# memory under weak/strong scaling and the lowered HLO's collectives.
# ---------------------------------------------------------------------------

def _compiled_train_step(n_devices: int, num_envs: int):
    mesh = pmesh.make_mesh(n_devices)
    cfg = PPOConfig(num_envs=num_envs, unroll_length=8,
                    minibatch_size=num_envs, num_sgd_iter=2)
    pol = Policy(PIN, model_config_for(PIN, "rectangle_pin"))
    learner = PPOLearner(PIN, pol, cfg)
    place, train_step = pmesh.shard_learner(learner, mesh)
    state = place(learner.init(jax.random.PRNGKey(0)))
    compiled = train_step.lower(state).compile()
    return compiled, state, mesh


@pytest.mark.slow
def test_weak_scaling_memory_and_collectives():
    """Same per-device board count at 1/2/4/8 devices: per-device temp
    memory must stay ~flat (each device holds only ITS boards' rollout
    buffers — silent replication would grow it linearly with device count),
    and the multi-device HLO must contain the cross-replica all-reduce that
    implements the psum gradient/metric reduction (SURVEY §2.4)."""
    per_device = 4
    temps = {}
    for n in (1, 2, 4, 8):
        compiled, _, _ = _compiled_train_step(n, per_device * n)
        stats = compiled.memory_analysis()
        assert stats is not None, "backend reports no memory analysis"
        temps[n] = stats.temp_size_in_bytes
        hlo = compiled.as_text()
        if n > 1:
            assert "all-reduce" in hlo, (
                f"{n}-device train step lowered without any all-reduce — "
                f"gradients are not being psum-reduced across the mesh")
    # weak scaling: total work grows with n but per-device share is fixed;
    # allow fixed overheads (replicated params/optimizer, fusion slack)
    assert temps[8] <= temps[1] * 2.0 + (1 << 20), temps


@pytest.mark.slow
def test_strong_scaling_rollout_not_replicated():
    """Fixed TOTAL batch, 1 vs 8 devices, rollout phase jitted alone (the
    piece VERDICT r3 flagged as silently-replicable — the SGD phase's
    random minibatch permutation is inherently global, so full-step temp
    bytes can't distinguish sharded from replicated): if GSPMD replicated
    the rollout, each device would materialize the full [T, B, ...]
    trajectory, per-device output bytes would match the single-device
    compile, and every trajectory leaf would come back fully replicated.
    Sharded correctly, the per-device share drops by ~the device count and
    each leaf's addressable shard covers only B/8 boards."""
    total = 32

    def _compiled_rollout(n_devices):
        mesh = pmesh.make_mesh(n_devices)
        cfg = PPOConfig(num_envs=total, unroll_length=8,
                        minibatch_size=total, num_sgd_iter=1)
        pol = Policy(PIN, model_config_for(PIN, "rectangle_pin"))
        learner = PPOLearner(PIN, pol, cfg)
        place, _ = pmesh.shard_learner(learner, mesh)
        state = place(learner.init(jax.random.PRNGKey(0)))

        def rollout(s):
            _, traj, last_value, _ = learner._rollout(s)
            return traj, last_value

        fn = jax.jit(rollout)
        return fn.lower(state).compile(), state, mesh

    c1, s1, _ = _compiled_rollout(1)
    c8, s8, mesh = _compiled_rollout(8)
    out1 = c1.memory_analysis().output_size_in_bytes
    out8 = c8.memory_analysis().output_size_in_bytes
    assert out8 < 0.3 * out1, (
        f"8-device per-device rollout output {out8} is not substantially "
        f"below 1-device {out1} — the trajectory looks replicated")

    traj, _ = c8(s8)
    grid = traj.obs["grid"]                      # [T, B, H, W]
    assert grid.shape[1] == total
    shard_shapes = {sh.data.shape for sh in grid.addressable_shards}
    assert shard_shapes == {(grid.shape[0], total // 8) + grid.shape[2:]}, (
        f"trajectory not sharded over boards: shards {shard_shapes}")
