"""Pooled auto-reset parity: step_autoreset_pooled must match the semantics
of core.step_autoreset — identical transition for live boards, a fresh
independently-keyed instance for done boards — with the generator amortized
into one pool call per chunk."""

import jax
import jax.numpy as jnp
import numpy as np

from placement_tpu.agent.random_policy import random_action
from placement_tpu.env import core, pooled
from placement_tpu.env.types import EnvParams, Variant

PARAMS = EnvParams(variant=Variant.PIN).validate()


@jax.jit
def _reset8(keys):
    return jax.vmap(lambda k: core.reset(PARAMS, k))(keys)


def _reset_batch(key, batch):
    return jax.vmap(lambda k: core.reset(PARAMS, k))(
        jax.random.split(key, batch))


_step_plain = jax.jit(jax.vmap(lambda s, a: core.step(PARAMS, s, a)))
_step_pooled = jax.jit(
    lambda s, a, p, c: pooled.step_autoreset_pooled(PARAMS, s, a, p, c))


def test_pooled_step_matches_plain_step_until_done():
    batch, k = 8, jax.random.PRNGKey(0)
    states = _reset_batch(k, batch)
    pool = pooled.make_pool(PARAMS, jax.random.PRNGKey(1), 4, batch)
    counts = jnp.zeros((batch,), jnp.int32)

    key = jax.random.PRNGKey(2)
    for _ in range(3):  # flagship episodes last 5 steps; stay pre-terminal
        key, kk = jax.random.split(key)
        actions = random_action(kk, PARAMS, states.action_mask)
        plain, r_plain, d_plain, _ = _step_plain(states, actions)
        states, counts, r_pool, d_pool, _ = _step_pooled(
            states, actions, pool, counts)
        np.testing.assert_array_equal(np.asarray(r_plain), np.asarray(r_pool))
        np.testing.assert_array_equal(np.asarray(d_plain), np.asarray(d_pool))
        assert not bool(jnp.any(d_pool))
        np.testing.assert_array_equal(
            np.asarray(plain.grid), np.asarray(states.grid))
    assert int(counts.sum()) == 0


def test_done_board_becomes_next_pool_entry():
    batch, k = 4, jax.random.PRNGKey(3)
    states = _reset_batch(k, batch)
    pool = pooled.make_pool(PARAMS, jax.random.PRNGKey(4), 3, batch)
    counts = jnp.zeros((batch,), jnp.int32)

    key = jax.random.PRNGKey(5)
    done_seen = jnp.zeros((batch,), bool)
    for step_i in range(6):
        key, kk = jax.random.split(key)
        actions = random_action(kk, PARAMS, states.action_mask)
        prev_counts = counts
        states, counts, _, done, _ = _step_pooled(
            states, actions, pool, counts)
        for b in np.argwhere(np.asarray(done)).ravel():
            entry = jax.tree_util.tree_map(
                lambda x, b=b, i=int(prev_counts[b]) % 3: x[i, b], pool)
            np.testing.assert_array_equal(
                np.asarray(states.grid[b]), np.asarray(entry.grid))
            np.testing.assert_array_equal(
                np.asarray(states.comp_h[b]), np.asarray(entry.comp_h))
            assert int(states.cursor[b]) == 0
        done_seen = done_seen | done
    # flagship config: every board finishes within 5 legal steps
    assert bool(done_seen.all())
    np.testing.assert_array_equal(np.asarray(counts >= 1),
                                  np.ones(batch, bool))


def test_rollout_chunk_throughput_semantics():
    """Pooled rollout chunk: reward sum finite, done count == chunk/5 * batch
    for the flagship config (episodes are exactly 5 legal placements)."""
    batch, chunk = 8, 10
    states = _reset_batch(jax.random.PRNGKey(6), batch)
    fn = jax.jit(pooled.rollout_chunk(PARAMS, random_action, chunk,
                                      pool_size=4))
    states, _, r, d, wrapped = fn(states, jax.random.PRNGKey(7))
    assert np.isfinite(float(r))
    assert int(d) == batch * chunk // 5
    assert int(wrapped) == 0  # pool_size 4 >= 10/5 resets per board


def test_gated_routing_matches_eager():
    """route_budget is a pure throughput knob: dones, grids, and rewards
    match the eager path whether the step hits the none-done branch
    (pre-terminal steps), the compacted branch (a lone invalid-action
    finisher, n_done=1 <= budget) or the full-batch fallback (all 8
    boards finish in lockstep at step 5 > budget 2). Float comparisons
    allow one-ulp f32 rounding: the crossing count is exact integer
    arithmetic at any width, but the wirelength reduction may fuse
    differently under the compacted vmap width."""
    batch = 8
    start = _reset_batch(jax.random.PRNGKey(10), batch)
    pool = pooled.make_pool(PARAMS, jax.random.PRNGKey(11), 6, batch)
    bad = jnp.asarray([0, -5, -5], jnp.int32)      # out of bounds -> invalid

    for budget in (2, batch):
        gated = jax.jit(lambda s, a, c, bu=budget: pooled.step_autoreset_pooled(
            PARAMS, s, a, pool, c, route_budget=bu))
        eager = jax.jit(lambda s, a, c: pooled.step_autoreset_pooled(
            PARAMS, s, a, pool, c))
        s_e = s_g = start
        c_e = c_g = jnp.zeros((batch,), jnp.int32)
        key = jax.random.PRNGKey(12)
        saw_partial = saw_full = False
        for i in range(12):
            key, kk = jax.random.split(key)
            actions = random_action(kk, PARAMS, s_e.action_mask)
            if i == 2:
                actions = actions.at[0].set(bad)   # lone finisher
            s_e, c_e, r_e, d_e, i_e = eager(s_e, actions, c_e)
            s_g, c_g, r_g, d_g, i_g = gated(s_g, actions, c_g)
            np.testing.assert_array_equal(np.asarray(d_e), np.asarray(d_g))
            np.testing.assert_allclose(np.asarray(r_e), np.asarray(r_g),
                                       rtol=3e-7, atol=1e-6)
            for k in ("wirelength", "num_intersections"):
                np.testing.assert_allclose(np.asarray(i_e[k]),
                                           np.asarray(i_g[k]),
                                           rtol=3e-7, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(s_e.grid),
                                          np.asarray(s_g.grid))
            np.testing.assert_allclose(
                np.asarray(s_e.info_wirelength),
                np.asarray(s_g.info_wirelength), rtol=3e-7, atol=1e-6)
            n_done = int(np.asarray(d_e).sum())
            saw_partial |= 0 < n_done <= budget
            saw_full |= n_done > budget
        assert saw_partial
        assert saw_full or budget == batch


def test_gated_routing_budget_extremes():
    """budget=1 (compaction almost always falls back) and budget=batch
    (never falls back) both reproduce the eager chunk totals; a non-pin
    variant silently ignores route_budget."""
    batch, chunk = 8, 12
    states = _reset_batch(jax.random.PRNGKey(20), batch)
    base = jax.jit(pooled.rollout_chunk(PARAMS, random_action, chunk,
                                        pool_size=4))
    _, _, r0, d0, _ = base(states, jax.random.PRNGKey(21))
    for budget in (1, batch):
        fn = jax.jit(pooled.rollout_chunk(PARAMS, random_action, chunk,
                                          pool_size=4,
                                          route_budget=budget))
        _, _, r, d, _ = fn(states, jax.random.PRNGKey(21))
        np.testing.assert_allclose(float(r), float(r0), rtol=1e-6)
        assert int(d) == int(d0)

    sq = EnvParams(variant=Variant.SQUARE).validate()
    sq_states = jax.vmap(lambda k: core.reset(sq, k))(
        jax.random.split(jax.random.PRNGKey(22), 4))
    fn_sq = jax.jit(pooled.rollout_chunk(sq, random_action, 6,
                                         pool_size=2, route_budget=2))
    _, _, r_sq, _, _ = fn_sq(sq_states, jax.random.PRNGKey(23))
    assert np.isfinite(float(r_sq))


def test_rollout_chunk_wrap_counter_detects_reuse():
    """A pool smaller than chunk_len/episode_len forces index wrap-around;
    the chunk must report it (round-1 weak spot: silent instance replay)."""
    batch, chunk = 4, 25        # 5 resets per board
    states = _reset_batch(jax.random.PRNGKey(8), batch)
    fn = jax.jit(pooled.rollout_chunk(PARAMS, random_action, chunk,
                                      pool_size=2))
    _, _, _, d, wrapped = fn(states, jax.random.PRNGKey(9))
    assert int(d) == batch * chunk // 5
    assert int(wrapped) == batch  # every board consumed > 2 pool entries
