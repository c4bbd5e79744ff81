"""Policy wrapper: one interface over joint-logits and factorized models.

Replaces RLlib's ModelV2/ActionDistribution plumbing
(utils/agent/utils.py:262-314 registration, models' ``forward``): a policy
turns observations into actions + log-probs + values and re-evaluates stored
transitions for the PPO loss. All methods are pure and jit/vmap/pjit-safe.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from placement_tpu.env.types import EnvParams, Variant
from placement_tpu.env.wrappers import decode_flat_action
from placement_tpu.models import distributions as D
from placement_tpu.models.zoo import ModelConfig, PlacementModel, build_model


def model_config_for(params: EnvParams, model_type: str,
                     **overrides) -> ModelConfig:
    base = dict(
        model_type=model_type,
        height=params.height, width=params.width,
        num_orientations=params.num_orientations,
        max_num_components=params.max_components,
        max_num_nets=params.max_num_nets,
        max_num_pins_per_component=params.max_num_pins_per_component,
        component_feature_vector_width=(
            5 + params.max_num_pins_per_component
            if params.variant == Variant.PIN_SPATIAL else 5),
        pin_feature_vector_width=4 + params.max_num_nets + 1,
    )
    base.update(overrides)
    return ModelConfig(**base)


@dataclasses.dataclass
class Policy:
    """A (model, env) pair with pure act/evaluate functions."""

    env_params: EnvParams
    cfg: ModelConfig

    def __post_init__(self):
        self.model: PlacementModel = build_model(self.cfg)

    # -- lifecycle ---------------------------------------------------------

    def init(self, key, sample_obs) -> Dict:
        return self.model.init(key, sample_obs)

    # -- helpers -----------------------------------------------------------

    def _heads(self, variables) -> D.FactorizedHeads:
        m = self.model
        return D.FactorizedHeads(
            o=lambda enc, xn, yn: m.o_logits(variables, enc, xn, yn),
            x=lambda enc, oh: m.x_logits(variables, enc, oh),
            y=lambda enc, oh, xn: m.y_logits(variables, enc, oh, xn),
            num_orientations=self.cfg.num_orientations,
            height=self.cfg.height, width=self.cfg.width)

    def _factorized_dist(self, variables, enc, mask) -> D.Factorized:
        return D.Factorized(self._heads(variables), enc, mask,
                            self.cfg.factorization)

    # -- acting ------------------------------------------------------------

    def act(self, variables, obs, key, deterministic: bool = False
            ) -> "tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]":
        """obs (batched) -> (action i32[B,3], logp f32[B], value f32[B],
        dist_inputs). dist_inputs is what PPO stores to rebuild the behavior
        distribution (masked logits, or the encoding for factorized heads) —
        mirroring RLlib's SampleBatch.ACTION_DIST_INPUTS."""
        out, _ = self.model.apply(variables, obs)
        value = out["value"]
        if self.cfg.is_factorized:
            enc = out["encoding"]
            dist = self._factorized_dist(variables, enc, obs["action_mask"])
            action = dist.sample(key, deterministic)
            logp = dist.logp(action)
            return action, logp, value, enc
        logits = out["logits"]
        flat = (jnp.argmax(logits, axis=-1) if deterministic
                else jax.random.categorical(key, logits, axis=-1))
        action = decode_flat_action(self.env_params, flat)
        logp = D.cat_logp(logits, flat)
        return action, logp, value, logits

    # -- training-time evaluation -----------------------------------------

    def evaluate(self, variables, obs, actions, behavior_inputs, key,
                 train: bool = True) -> tuple:
        """Recompute (logp, entropy, value, kl_vs_behavior, bn_updates) for
        stored transitions under the current parameters."""
        out, updates = self.model.apply(variables, obs, train=train)
        value = out["value"]
        if self.cfg.is_factorized:
            enc = out["encoding"]
            dist = self._factorized_dist(variables, enc, obs["action_mask"])
            prev = self._factorized_dist(variables, behavior_inputs,
                                         obs["action_mask"])
            k_e, k_kl = jax.random.split(key)
            logp = dist.logp(actions)
            entropy = dist.entropy(k_e)
            kl = prev.kl(dist, k_kl)
            return logp, entropy, value, kl, updates
        from placement_tpu.env.wrappers import encode_flat_action
        flat = encode_flat_action(self.env_params, actions)
        logits = out["logits"]
        logp = D.cat_logp(logits, flat)
        entropy = D.cat_entropy(logits)
        kl = D.cat_kl(behavior_inputs, logits)
        return logp, entropy, value, kl, updates
