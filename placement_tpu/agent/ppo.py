"""On-device PPO actor-learner.

Replaces Ray RLlib 2.2's PPO (tune.run("PPO", ...) at
experiments/PPO/PPO.py:39-47) with a single jitted train step: rollout
(lax.scan over the batched env) -> GAE -> minibatched clipped-surrogate
updates, with RLlib 2.2's default hyperparameters so learning curves are
comparable (clip 0.3, lr 5e-5, gamma 0.99, lambda 1.0, vf_clip 10,
kl_coeff 0.2 with adaptive update, entropy 0.0, 30 SGD iters over
128-sized minibatches of a 4000-sample train batch).

The whole step — env physics, model forward/backward, optimizer — runs on
device; the host only sees scalar metrics. Under a sharded batch axis this
same code runs data-parallel on a Mesh (see placement_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from placement_tpu.agent.policy import Policy
from placement_tpu.env import core, pooled
from placement_tpu.env.types import EnvParams, EnvState, Variant
from placement_tpu.utils import pytree


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """RLlib 2.2 PPO defaults (ray.rllib.algorithms.ppo.PPOConfig)."""

    gamma: float = 0.99
    gae_lambda: float = 1.0
    lr: float = 5e-5
    clip_param: float = 0.3
    vf_clip_param: float = 10.0
    vf_loss_coeff: float = 1.0
    entropy_coeff: float = 0.0
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    num_envs: int = 128
    unroll_length: int = 32           # num_envs * unroll = train batch
    minibatch_size: int = 128
    num_sgd_iter: int = 30
    grad_clip: Optional[float] = None
    # Fresh-instance pool entries per board per rollout window (None =
    # derived from the env's minimum episode length; see env/pooled.py).
    reset_pool_size: Optional[int] = None
    # Per-step finisher budget for gated terminal routing in the rollout
    # (pin variants; None = eager routing every step for every board).
    # Rewards match the eager path to one f32 ulp — see
    # pooled.gated_terminal_rewards.
    # Worth setting on big boards where the O(P^2) routing dominates the
    # env step (docs/performance.md "Inside the rollout").
    route_budget: Optional[int] = None

    def __post_init__(self) -> None:
        if self.reset_pool_size is not None and self.reset_pool_size < 1:
            raise ValueError(
                f"reset_pool_size must be >= 1 (or None to derive it), "
                f"got {self.reset_pool_size}")
        if self.route_budget is not None and self.route_budget < 1:
            raise ValueError(
                f"route_budget must be >= 1 (or None for eager routing), "
                f"got {self.route_budget}")
        for field in ("num_envs", "unroll_length", "minibatch_size",
                      "num_sgd_iter"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, "
                                 f"got {getattr(self, field)}")

    @property
    def train_batch(self) -> int:
        return self.num_envs * self.unroll_length


def default_pool_size(params: EnvParams, unroll_length: int) -> int:
    """Pool entries per board so that no board exhausts its pool within one
    rollout window under normal episode lengths (env/pooled.py contract).

    The estimate divides the window by a lower bound on episode length:
    for component-sampling variants the smaller of ``min_num_components``
    and the area-fill bound ``area // max_component_area`` (episodes can
    end by a mask-full board well before min_num_components placements
    when more components are sampled than fit — e.g. the rect config
    samples 20 components of which only ~7 fit a 10x10 board); for the
    square variant the worst-case packing bound ``area // (2n-1)^2``.

    This is a heuristic, not a guarantee: RECT/PIN episodes can also end
    by origin-blocking (no legal origin for the current component) in
    fewer placements than the area-fill bound — the true worst-case
    blocking bound is 1 placement for shipped configs, which would force
    ``pool == unroll_length`` (a ~4x pool memory/generation cost) against
    a regime the shipped configs never enter (locked by
    tests/agent/test_ppo.py's no-wraps tests). Underestimates
    are surfaced at run time by the ``pool_wraps`` metric with escalating
    trainer logs when sustained (agent/trainer.py); set
    ``PPOConfig.reset_pool_size`` explicitly to override.
    """
    if params.variant == Variant.SQUARE:
        # worst-case packing over the VALID-ORIGIN grid (origins live in
        # [0, H-n] x [0, W-n]; one placement blocks a (2n-1)^2 origin patch)
        n = params.component_n
        origins = ((params.height - n + 1) * (params.width - n + 1))
        est = max(origins // ((2 * n - 1) ** 2), 1)
    else:
        fill = params.area // max(
            params.max_component_h * params.max_component_w, 1)
        est = max(min(params.min_num_components, fill), 1)
    return max(min(unroll_length, unroll_length // est + 2), 2)


@pytree.dataclass
class TrainState:
    variables: Any                   # {'params': ..., 'batch_stats': ...}
    opt_state: Any
    kl_coeff: jnp.ndarray
    env_states: EnvState             # batched [num_envs]
    key: jnp.ndarray
    steps: jnp.ndarray
    # Per-env episode accumulators carried ACROSS rollout windows so
    # episode_reward_mean reports full completed-episode returns like RLlib
    # (episodes longer than unroll_length would otherwise be truncated at
    # the window edge).
    ep_return_acc: jnp.ndarray       # f32[num_envs]
    ep_len_acc: jnp.ndarray          # i32[num_envs]


class Transition(NamedTuple):
    obs: Dict[str, jnp.ndarray]
    action: jnp.ndarray
    logp: jnp.ndarray
    value: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    dist_inputs: jnp.ndarray


class PPOLearner:
    """Compiled PPO over a batched placement env."""

    def __init__(self, env_params: EnvParams, policy: Policy,
                 cfg: PPOConfig = PPOConfig()):
        self.env_params = env_params
        self.policy = policy
        self.cfg = cfg
        self.tx = self._make_tx()
        self._jitted_train_step = None

    def _make_tx(self):
        chain = []
        if self.cfg.grad_clip is not None:
            chain.append(optax.clip_by_global_norm(self.cfg.grad_clip))
        chain.append(optax.adam(self.cfg.lr))
        return optax.chain(*chain)

    # -- init --------------------------------------------------------------

    def init(self, key) -> TrainState:
        k_env, k_model, k_run = jax.random.split(key, 3)
        env_keys = jax.random.split(k_env, self.cfg.num_envs)
        env_states = jax.vmap(lambda k: core.reset(self.env_params, k))(
            env_keys)
        obs = jax.vmap(lambda s: core.observe(self.env_params, s))(env_states)
        variables = self.policy.init(k_model, obs)
        opt_state = self.tx.init(variables["params"])
        return TrainState(
            variables=variables, opt_state=opt_state,
            kl_coeff=jnp.asarray(self.cfg.kl_coeff, jnp.float32),
            env_states=env_states, key=k_run,
            steps=jnp.asarray(0, jnp.int32),
            ep_return_acc=jnp.zeros((self.cfg.num_envs,), jnp.float32),
            ep_len_acc=jnp.zeros((self.cfg.num_envs,), jnp.int32))

    # -- rollout -----------------------------------------------------------

    def _rollout(self, state: TrainState):
        """Collect one rollout window with pooled auto-reset.

        The naive ``vmap(core.step_autoreset)`` runs the fresh-instance
        generator inside every step for every board (~75% of step cost,
        env/pooled.py) — instead the pool of replacement instances is drawn
        ONCE per window outside the scan and done boards consume pool
        entries (``pooled.step_autoreset_pooled``). ``pool_wraps`` counts
        boards that exhausted the pool (instance reuse); it is reported in
        the train metrics and must stay 0 for unbiased sampling.
        """
        env_params = self.env_params
        pool_size = (default_pool_size(env_params, self.cfg.unroll_length)
                     if self.cfg.reset_pool_size is None
                     else self.cfg.reset_pool_size)
        key, k_pool, k_roll = jax.random.split(state.key, 3)
        # loop-invariant: closed over by step_fn (like env_params), not
        # threaded through the scan carry
        pool = pooled.make_pool(env_params, k_pool, pool_size,
                                self.cfg.num_envs)

        def step_fn(carry, _):
            env_states, counts, key, ret_acc, len_acc = carry
            key, k_act = jax.random.split(key)
            obs = jax.vmap(lambda s: core.observe(env_params, s))(env_states)
            action, logp, value, dist_inputs = self.policy.act(
                state.variables, obs, k_act)
            next_states, counts, reward, done, info = (
                pooled.step_autoreset_pooled(
                    env_params, env_states, action, pool, counts,
                    route_budget=self.cfg.route_budget))
            tr = Transition(obs=obs, action=action, logp=logp, value=value,
                            reward=reward, done=done,
                            dist_inputs=dist_inputs)
            ret_total = ret_acc + reward
            len_total = len_acc + 1
            metrics = {
                "done": done, "reward": reward,
                # full-episode return/length, emitted at episode end
                "ep_return": jnp.where(done, ret_total, 0.0),
                "ep_len": jnp.where(done, len_total, 0),
                "wirelength": info.get("wirelength", jnp.zeros_like(reward)),
                "intersections": info.get("num_intersections",
                                          jnp.zeros_like(reward)),
            }
            ret_acc = jnp.where(done, 0.0, ret_total)
            len_acc = jnp.where(done, 0, len_total)
            return (next_states, counts, key, ret_acc, len_acc), (
                tr, metrics)

        counts = jnp.zeros((self.cfg.num_envs,), jnp.int32)
        (env_states, counts, _, ret_acc, len_acc), (traj, metrics) = (
            jax.lax.scan(
                step_fn,
                (state.env_states, counts, k_roll,
                 state.ep_return_acc, state.ep_len_acc),
                None, length=self.cfg.unroll_length))
        metrics["pool_wraps"] = jnp.sum(
            (counts > pool_size).astype(jnp.int32))
        # bootstrap value for the final observation
        obs = jax.vmap(lambda s: core.observe(env_params, s))(env_states)
        out, _ = self.policy.model.apply(state.variables, obs)
        last_value = out["value"]
        new_state = state.replace(env_states=env_states, key=key,
                                  ep_return_acc=ret_acc, ep_len_acc=len_acc)
        return new_state, traj, last_value, metrics

    # -- GAE (Postprocessing.compute_gae_for_sample_batch) ------------------

    def _gae(self, traj: Transition, last_value):
        cfg = self.cfg

        def back(carry, inp):
            adv_next, v_next = carry
            reward, value, done = inp
            nonterminal = 1.0 - done.astype(jnp.float32)
            delta = reward + cfg.gamma * v_next * nonterminal - value
            adv = delta + cfg.gamma * cfg.gae_lambda * nonterminal * adv_next
            return (adv, value), adv

        (_, _), advantages = jax.lax.scan(
            back, (jnp.zeros_like(last_value), last_value),
            (traj.reward, traj.value, traj.done), reverse=True)
        value_targets = advantages + traj.value
        return advantages, value_targets

    # -- loss (ray.rllib.algorithms.ppo.ppo_tf_policy loss) -----------------

    def _loss(self, params, batch_stats, mb, kl_coeff, key):
        cfg = self.cfg
        variables = {"params": params, **batch_stats}
        logp, entropy, value, kl, updates = self.policy.evaluate(
            variables, mb["obs"], mb["action"], mb["dist_inputs"], key,
            train=True)
        ratio = jnp.exp(logp - mb["logp"])
        adv = mb["advantages"]
        surrogate = jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv)
        vf_err = jnp.square(value - mb["value_targets"])
        vf_loss = jnp.clip(vf_err, 0.0, cfg.vf_clip_param)
        mean_kl = jnp.mean(kl)
        total = (-jnp.mean(surrogate)
                 + cfg.vf_loss_coeff * jnp.mean(vf_loss)
                 - cfg.entropy_coeff * jnp.mean(entropy)
                 + kl_coeff * mean_kl)
        aux = {"policy_loss": -jnp.mean(surrogate),
               "vf_loss": jnp.mean(vf_loss),
               "entropy": jnp.mean(entropy), "kl": mean_kl,
               "bn_updates": updates}
        return total, aux

    # -- one full train iteration ------------------------------------------

    def train_step(self, state: TrainState
                   ) -> "tuple[TrainState, dict]":
        cfg = self.cfg
        state, traj, last_value, roll_metrics = self._rollout(state)
        advantages, value_targets = self._gae(traj, last_value)

        # flatten [T, B, ...] -> [N, ...]
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        batch = {
            "obs": jax.tree_util.tree_map(flat, traj.obs),
            "action": flat(traj.action), "logp": flat(traj.logp),
            "value": flat(traj.value), "dist_inputs": flat(traj.dist_inputs),
            "advantages": flat(advantages),
            "value_targets": flat(value_targets),
        }
        # standardize advantages (RLlib standardize_fields=["advantages"])
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / jnp.maximum(adv.std(), 1e-4)

        n = cfg.train_batch
        n_mb = max(n // cfg.minibatch_size, 1)

        def sgd_epoch(carry, key_epoch):
            variables, opt_state, kl_coeff = carry
            perm = jax.random.permutation(key_epoch, n)

            def mb_step(carry2, idx):
                variables, opt_state = carry2
                sel = jax.lax.dynamic_slice_in_dim(
                    perm, idx * cfg.minibatch_size, cfg.minibatch_size)
                take = jax.tree_util.tree_map(
                    lambda x: jnp.take(x, sel, axis=0), batch)
                k = jax.random.fold_in(key_epoch, idx)
                batch_stats = {k2: v for k2, v in variables.items()
                               if k2 != "params"}
                (loss, aux), grads = jax.value_and_grad(
                    self._loss, has_aux=True)(
                    variables["params"], batch_stats, take, kl_coeff, k)
                updates, opt_state = self.tx.update(grads, opt_state,
                                                    variables["params"])
                new_params = optax.apply_updates(variables["params"], updates)
                new_vars = {"params": new_params}
                if aux["bn_updates"]:
                    new_vars.update(aux["bn_updates"])
                else:
                    new_vars.update(batch_stats)
                aux = {k2: v for k2, v in aux.items() if k2 != "bn_updates"}
                return (new_vars, opt_state), aux

            (variables, opt_state), aux = jax.lax.scan(
                mb_step, (variables, opt_state), jnp.arange(n_mb))
            return (variables, opt_state, kl_coeff), aux

        key, k_sgd = jax.random.split(state.key)
        (variables, opt_state, kl_coeff), aux = jax.lax.scan(
            sgd_epoch, (state.variables, state.opt_state, state.kl_coeff),
            jax.random.split(k_sgd, cfg.num_sgd_iter))

        # adaptive KL coefficient (RLlib update_kl)
        mean_kl = aux["kl"][-1].mean()
        kl_coeff = jnp.where(mean_kl > 2.0 * cfg.kl_target, kl_coeff * 1.5,
                             jnp.where(mean_kl < 0.5 * cfg.kl_target,
                                       kl_coeff * 0.5, kl_coeff))

        done = roll_metrics["done"]
        n_done = jnp.maximum(done.sum(), 1)
        metrics = {
            "policy_loss": aux["policy_loss"].mean(),
            "vf_loss": aux["vf_loss"].mean(),
            "entropy": aux["entropy"].mean(),
            "kl": mean_kl,
            "kl_coeff": kl_coeff,
            # full completed-episode returns (accumulators carried across
            # rollout windows in TrainState — no window-edge truncation)
            "episode_reward_mean": roll_metrics["ep_return"].sum() / n_done,
            "episode_len_mean":
                roll_metrics["ep_len"].sum() / n_done,
            "episodes_this_iter": done.sum(),
            # custom metrics parity (utils/agent/callbacks.py:35-42)
            "normalized_wirelengths_mean":
                (roll_metrics["wirelength"] * done).sum() / n_done,
            "num_intersections_mean":
                (roll_metrics["intersections"] * done).sum() / n_done,
            # boards that exhausted the reset pool this window (instance
            # reuse — must be 0 for unbiased sampling; raise
            # reset_pool_size if it isn't)
            "pool_wraps": roll_metrics["pool_wraps"],
        }
        new_state = state.replace(
            variables=variables, opt_state=opt_state, kl_coeff=kl_coeff,
            key=key, steps=state.steps + cfg.train_batch)
        return new_state, metrics

    def jitted_train_step(self) -> Any:
        """Jitted train step, cached on the learner so repeated
        ``Trainer.run()`` calls (e.g. web-app Train clicks) reuse one
        ``jax.jit`` wrapper instead of re-tracing each time."""
        if self._jitted_train_step is None:
            self._jitted_train_step = jax.jit(self.train_step,
                                              donate_argnums=(0,))
        return self._jitted_train_step
