"""placement_tpu — a JAX PCB component-placement RL framework.

A from-scratch JAX/XLA re-design of the capabilities of
``PBozmarov/RL-Environment-for-Component-Placement``: four placement
environments (square, rectangular, rectangular-pin, rectangular-pin-spatial)
expressed as one pure-functional, fully batched stepper; a policy-model zoo
of plain-function layers; factorized action distributions; an on-device PPO
actor-learner; and data-parallel scale-out over a device mesh.

Reference parity map (reference file -> this package):
  environment/dummy_env_square.py              -> placement_tpu.env (Variant.SQUARE)
  environment/dummy_env_rectangular.py         -> placement_tpu.env (Variant.RECT)
  environment/dummy_env_rectangular_pin.py     -> placement_tpu.env (Variant.PIN)
  environment/dummy_env_rectangular_pin_spatial.py -> placement_tpu.env (Variant.PIN_SPATIAL)
  agent/models/*                               -> placement_tpu.models
  utils/agent/factorized_action_distributions.py -> placement_tpu.models.distributions
  utils/agent/utils.py + experiments/PPO       -> placement_tpu.agent
  agent/random/*                               -> placement_tpu.agent.random_policy
  utils/visualization + web_app                -> placement_tpu.utils
"""

__version__ = "0.1.0"

from placement_tpu.env.types import EnvParams, EnvState, Variant  # noqa: F401
