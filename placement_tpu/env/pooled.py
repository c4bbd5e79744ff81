"""Pooled auto-reset: amortized instance generation for rollout loops.

``core.step_autoreset`` draws a fresh instance inside the step, so under
``vmap`` the generator's ~50 small kernels execute for every board on every
step even though only done boards consume the result (the done-branch lowers
to a ``select``, so the whole generator runs every step).

This module replaces the per-step draw with a *pool*: one big batched
generator call per rollout chunk produces ``[K, B]`` fresh board states
outside the step scan (amortizing the generator's fixed per-call overhead
across K*B instances), and each board consumes its next pool entry when it
finishes an episode. Semantics match ``core.step_autoreset`` exactly as long
as no board resets more than K times per chunk — every reset still receives
an independently-keyed fresh instance, same distribution as
``DummyPlacementEnv.reset`` (dummy_env_rectangular_pin.py:1544). If a board
exhausts its K entries the index wraps around and re-uses an instance from
the same chunk (fresh *values*, repeated *instance*) — size K with headroom
over ``chunk_len / min_episode_len`` to keep that a cold path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from placement_tpu.env import core, routing
from placement_tpu.env.types import EnvParams, EnvState

I32 = jnp.int32


def make_pool(params: EnvParams, key, pool_size: int, batch: int,
              slice_size: int = 4) -> EnvState:
    """Draw ``pool_size`` fresh instances per board, batched in big slices.

    Returns an ``EnvState`` pytree whose leaves have leading dims
    ``[pool_size, batch]``; entry ``[i, b]`` is board ``b``'s (i+1)-th
    replacement episode. Generation runs as ``pool_size / slice_size``
    sequential ``lax.map`` iterations of ``slice_size * batch`` boards each —
    a handful of wide generator calls instead of one per step (or one giant
    call whose intermediates scale with the full pool).
    """
    slice_size = min(slice_size, pool_size)
    n_slices = -(-pool_size // slice_size)
    keys = jax.random.split(key, n_slices * slice_size * batch)
    keys = keys.reshape((n_slices, slice_size * batch) + keys.shape[1:])
    gen = jax.vmap(lambda k: core.reset(params, k))
    stacked = jax.lax.map(gen, keys)  # leaves [n_slices, slice*B, ...]
    return jax.tree_util.tree_map(
        lambda x: x.reshape((n_slices * slice_size, batch)
                            + x.shape[2:])[:pool_size], stacked)


def take(pool: EnvState, counts) -> EnvState:
    """Per-board gather of the next pool entry: ``pool[counts[b] % K, b]``."""
    k = jax.tree_util.tree_leaves(pool)[0].shape[0]
    b = counts.shape[0]
    idx = counts % k
    rows = jnp.arange(b)
    return jax.tree_util.tree_map(lambda x: x[idx, rows], pool)


def gated_terminal_rewards(params: EnvParams, stepped: EnvState, done,
                           placed_all_eff, budget: int) -> tuple:
    """Terminal routing rewards for the done boards only.

    ``core.step`` evaluates ``routing.terminal_reward`` — an O(P^2)
    all-pairs crossing count — for EVERY board on EVERY step and throws the
    result away unless the board finished (env/core.py:186-195); under
    ``vmap`` the done-branch is a ``select``, so nothing short-circuits. On
    big boards (the web-app maximum's 10 nets of up to 10 pins) that
    discarded work dominates the pooled step.

    This computes the identical per-board quantity but only where it is
    consumed: the (at most ``budget``) boards that finished this step are
    compacted to the front with a stable argsort, routed with one
    ``vmap(terminal_reward)`` of width ``budget``, and scattered back. Two
    nested ``lax.cond`` levels keep the cost honest at batch level:

      * no board finished            -> no routing at all (the common step)
      * <= budget boards finished    -> route ``budget`` boards
      * more than ``budget`` boards  -> route the full batch (rare fallback,
                                        exact same values as the eager path)

    Returns ``(reward, info_wl, info_int)`` f32[B], already masked to zero
    on non-done boards. Per board the routing math is the same pure
    function either way; the crossing count (exact integer arithmetic) is
    bit-identical, while the wirelength reduction can differ by one f32
    ulp when XLA fuses the compacted-width vmap differently than the
    full-batch one (observed 6e-8 on the CPU backend; locked within
    rounding by tests/tooling/test_pooled.py).
    """
    b = done.shape[0]
    n_done = jnp.sum(done.astype(I32))

    def routed(x, y, net, pa):
        return jax.vmap(
            lambda xi, yi, ni, pi: routing.terminal_reward(
                params, xi, yi, ni, pi))(x, y, net, pa)

    def none_done(_):
        z = jnp.zeros((b,), jnp.float32)
        return z, z, z

    def some_done(_):
        def compact(_):
            order = jnp.argsort(~done)          # stable: done boards first
            idx = order[:budget]
            r, wl, ni = routed(stepped.pin_abs_x[idx],
                               stepped.pin_abs_y[idx],
                               stepped.pin_net[idx], placed_all_eff[idx])
            z = jnp.zeros((b,), jnp.float32)
            # rows with rank >= n_done land on non-done boards and are
            # masked out by the caller's where(done, ...)
            return (z.at[idx].set(r), z.at[idx].set(wl), z.at[idx].set(ni))

        def full(_):
            return routed(stepped.pin_abs_x, stepped.pin_abs_y,
                          stepped.pin_net, placed_all_eff)

        return jax.lax.cond(n_done <= budget, compact, full, None)

    r, wl, ni = jax.lax.cond(n_done == 0, none_done, some_done, None)
    zero = jnp.zeros((), jnp.float32)
    return (jnp.where(done, r, zero), jnp.where(done, wl, zero),
            jnp.where(done, ni, zero))


def step_autoreset_pooled(
    params: EnvParams, states: EnvState, actions, pool: EnvState, counts,
    route_budget: "int | None" = None,
) -> Tuple[EnvState, jnp.ndarray, jnp.ndarray, jnp.ndarray, dict]:
    """Batched step; done boards are replaced by their next pool entry.

    Same contract as ``vmap(core.step_autoreset)`` — the returned state for a
    done board is the first state of a fresh episode — but the fresh instance
    comes from ``pool`` instead of running the generator inline. ``counts``
    (i32[B]) tracks how many pool entries each board has consumed.

    ``route_budget`` (static, pin variants only): compute the terminal
    routing reward just for boards that finished this step via
    ``gated_terminal_rewards`` instead of for every board every step. Value
    = the per-step finisher budget (e.g. ``batch // 16``); rewards/infos
    match the eager path to one f32 ulp (see ``gated_terminal_rewards``).
    """
    if route_budget is not None and params.has_pins:
        stepped, _, done, aux = jax.vmap(
            lambda s, a: core.step(params, s, a, defer_routing=True))(
                states, actions)
        reward, wl, ni = gated_terminal_rewards(
            params, stepped, done, aux["placed_all_eff"], route_budget)
        stepped = stepped.replace(info_wirelength=wl,
                                  info_intersections=ni)
        info = {"wirelength": wl, "num_intersections": ni}
    else:
        stepped, reward, done, info = jax.vmap(
            lambda s, a: core.step(params, s, a))(states, actions)
    fresh = take(pool, counts)
    new_states = jax.tree_util.tree_map(
        lambda f, s: jnp.where(
            done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s),
        fresh, stepped)
    return new_states, counts + done.astype(I32), reward, done, info


def rollout_chunk(params: EnvParams, policy_fn, chunk_len: int,
                  pool_size: int, slice_size: int = 4,
                  route_budget: "int | None" = None) -> "Callable":
    """Build a jittable pooled-rollout chunk.

    ``policy_fn(key, params, mask) -> actions`` (e.g.
    ``agent.random_policy.random_action``). Returns
    ``fn(states, key) -> (states, key, reward_sum, done_count, wrap_count)``
    where the pool for the chunk is drawn inside the call (so steady-state
    throughput measured over the chunk includes generation cost honestly).

    ``wrap_count`` is the number of boards that consumed more than
    ``pool_size`` entries this chunk — i.e. boards whose index wrapped and
    replayed an instance from the same pool. It is exactly 0 whenever
    ``pool_size >= chunk_len / min_episode_len``; callers with
    variable-length episodes MUST check it (a nonzero value means sample
    reuse silently biased the run).
    """

    def fn(states: EnvState, key):
        batch = states.done.shape[0]
        key, k_pool = jax.random.split(key)
        pool = make_pool(params, k_pool, pool_size, batch, slice_size)
        counts = jnp.zeros((batch,), I32)

        def one(carry, _):
            states, counts, key = carry
            key, k = jax.random.split(key)
            actions = policy_fn(k, params, states.action_mask)
            states, counts, reward, done, _ = step_autoreset_pooled(
                params, states, actions, pool, counts,
                route_budget=route_budget)
            return (states, counts, key), (reward.sum(), done.sum())

        (states, counts, key), (r, d) = jax.lax.scan(
            one, (states, counts, key), None, length=chunk_len)
        wrapped = jnp.sum((counts > pool_size).astype(I32))
        return states, key, r.sum(), d.sum(), wrapped

    return fn
