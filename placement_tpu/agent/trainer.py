"""Training orchestration: the ``tune.run("PPO", ...)`` replacement.

The reference trains via Ray Tune (``experiments/PPO/PPO.py:36-47``):
register env/model/action-dist, build an RLlib PPOConfig from
``agent/config/<type>.json``, run N iterations with per-iteration
checkpointing (keep 5), then export rollouts. Here the same lifecycle is a
plain Python loop around one jitted train step: no actor framework — the
rollout worker, the learner, and the "driver" all live in a single compiled
XLA program; the host only resolves configs, logs metric scalars, and saves
checkpoints.

Run-dir layout mirrors what the reference documents
(``docs/source/usage.rst:284-311``): ``<results_root>/PPO/PPO_<type>_<ts>/``
containing ``progress.csv``, TensorBoard events, ``params.json`` (full run
config), and ``checkpoint_<iter>/`` directories.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import jax

from placement_tpu.agent.policy import Policy
from placement_tpu.agent.ppo import PPOConfig, PPOLearner, TrainState
from placement_tpu.utils.checkpoint import CheckpointManager, find_latest_run
from placement_tpu.utils.config import MODEL_TYPES, load_experiment
from placement_tpu.utils.metrics import MetricsLogger, NullMetricsLogger

DEFAULT_RESULTS_ROOT = os.path.expanduser("~/placement_tpu_results")


def _run_name(model_type: str) -> str:
    return "PPO_{}_{}".format(model_type,
                              time.strftime("%Y-%m-%d_%H-%M-%S"))


@dataclasses.dataclass
class TrainResult:
    run_dir: str
    checkpoint_dir: str
    final_metrics: Dict[str, float]
    state: TrainState


class Trainer:
    """Config-driven PPO training with checkpointing and metric logging."""

    def __init__(self, model_type: str,
                 config_dir: Optional[str] = None,
                 results_root: str = DEFAULT_RESULTS_ROOT,
                 ppo_config: Optional[PPOConfig] = None,
                 env_overrides: Optional[Dict[str, Any]] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 keep_checkpoints: int = 5,
                 checkpoint_freq: int = 1,
                 use_tensorboard: bool = True,
                 run_name: Optional[str] = None,
                 mesh: Optional["jax.sharding.Mesh"] = None,
                 profile_dir: Optional[str] = None):
        if model_type not in MODEL_TYPES:
            raise KeyError(f"unknown model type {model_type!r}; "
                           f"one of {sorted(MODEL_TYPES)}")
        self.model_type = model_type
        env_params, model_cfg, raw = load_experiment(model_type, config_dir)
        if env_overrides:
            env_params = env_params.replace(**env_overrides).validate()
            # User-supplied generation parameters (web-app sliders, API
            # overrides) can move a pin config into a cap-bound sampling
            # regime the shipped-config fidelity evidence doesn't cover —
            # measure it and warn rather than silently biasing sampling
            # (env/fidelity.py; the fix is exact_sampling=True).
            from placement_tpu.env.fidelity import (GENERATION_FIELDS,
                                                    check_sampling_fidelity)
            if GENERATION_FIELDS & set(env_overrides):
                check_sampling_fidelity(
                    env_params,
                    context=f"Trainer(model_type={model_type!r}, "
                            f"env_overrides=...)")
            # re-derive the geometry-coupled model fields (grid size, mask
            # planes, feature widths) so env sliders/overrides can't desync
            # the model heads from the environment (the reference rebuilds
            # the model from env_config on every run, utils.py:262-314)
            from placement_tpu.agent.policy import model_config_for
            arch = {f.name: getattr(model_cfg, f.name)
                    for f in dataclasses.fields(model_cfg)}
            geom = model_config_for(env_params, model_type)
            for f in ("height", "width", "num_orientations",
                      "max_num_components", "max_num_nets",
                      "max_num_pins_per_component",
                      "component_feature_vector_width",
                      "pin_feature_vector_width"):
                arch[f] = getattr(geom, f)
            model_cfg = type(model_cfg)(**arch)
        if model_overrides:
            model_cfg = dataclasses.replace(model_cfg, **model_overrides)
        self.env_params = env_params
        self.model_cfg = model_cfg
        self.raw_config = raw
        self.policy = Policy(env_params, model_cfg)
        self.ppo_config = ppo_config or PPOConfig()
        self.learner = PPOLearner(env_params, self.policy, self.ppo_config)

        self.run_dir = os.path.join(results_root, "PPO",
                                    run_name or _run_name(model_type))
        os.makedirs(self.run_dir, exist_ok=True)
        self.checkpoint_dir = os.path.join(self.run_dir, "checkpoints")
        self.ckpt = CheckpointManager(self.checkpoint_dir,
                                      max_to_keep=keep_checkpoints,
                                      save_interval=checkpoint_freq)
        # Multi-host: every process calls save (gathering the sharded env
        # batch is collective) and process 0 writes; metric files also have
        # one writer — process 0 (metrics are replicated anyway).
        self.is_main_process = jax.process_index() == 0
        self.logger = (MetricsLogger(self.run_dir,
                                     use_tensorboard=use_tensorboard)
                       if self.is_main_process else NullMetricsLogger())
        # Data-parallel scale-out (SURVEY §2.4): boards shard over the mesh's
        # "dp" axis, params replicate, gradients psum — shard_learner wires
        # the shardings; everything else in this class is layout-agnostic.
        self.mesh = mesh
        self._place = None
        self._mesh_step = None
        if mesh is not None:
            from placement_tpu.parallel.mesh import shard_learner
            self._place, self._mesh_step = shard_learner(self.learner, mesh)
        self._profiler = None
        if profile_dir:
            from placement_tpu.utils.profiling import trace_iterations
            self._profiler = trace_iterations(profile_dir)
        if self.is_main_process:
            self._write_params()

    # -- persistence ---------------------------------------------------------

    def _write_params(self) -> None:
        """params.json: the full run config (reference run dirs carry
        params.pkl + the input-parameter CSV, usage.rst:284-311)."""
        payload = {
            "model_type": self.model_type,
            "ppo": dataclasses.asdict(self.ppo_config),
            "env_config": {**{f.name: getattr(self.env_params, f.name)
                              for f in dataclasses.fields(self.env_params)},
                           "variant": int(self.env_params.variant)},
            "model_config": dataclasses.asdict(self.model_cfg),
            "raw_config": self.raw_config,
        }
        with open(os.path.join(self.run_dir, "params.json"), "w") as f:
            json.dump(payload, f, indent=2, default=str)

    # -- lifecycle -------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        return self.learner.init(jax.random.PRNGKey(seed))

    def restore(self, run_dir: Optional[str] = None,
                step: Optional[int] = None, seed: int = 0) -> TrainState:
        """Restore the newest checkpoint of ``run_dir`` (default: this run's
        directory) into a freshly-initialised state template."""
        ckpt = self.ckpt if run_dir is None else CheckpointManager(
            os.path.join(run_dir, "checkpoints"))
        return ckpt.restore(self.init_state(seed), step=step)

    def run(self, num_iterations: int = 1, seed: int = 0,
            state: Optional[TrainState] = None,
            on_iteration: Optional[Callable[[int, Dict[str, float]], None]]
            = None) -> TrainResult:
        """Train ``num_iterations`` iterations (reference default:
        ``stop={"training_iteration": 1}``, experiments/PPO/PPO.py:42)."""
        if state is None:
            state = self.init_state(seed)
        if self._place is not None:
            state = self._place(state)
            step_fn = self._mesh_step
        else:
            step_fn = self.learner.jitted_train_step()
        start = int(state.steps) // max(self.ppo_config.train_batch, 1)
        row: Dict[str, float] = {}
        wrap_windows = 0       # consecutive windows with pool exhaustion
        wrapped_boards = 0     # cumulative boards that replayed an instance
        for it in range(start + 1, start + num_iterations + 1):
            if self._profiler is not None:
                self._profiler.maybe_start(it - start)
            state, metrics = step_fn(state)
            row = self.logger.log(it, int(jax.device_get(state.steps)),
                                  metrics)
            wraps = int(row.get("pool_wraps", 0))
            if wraps > 0:
                # Escalate sustained exhaustion instead of warning once:
                # repeat on the 1st and every 10th consecutive window, at
                # ERROR once it has persisted 10 windows (the derived pool
                # bound was too optimistic — e.g. episodes ending early by
                # blocking rather than area fill).
                wrap_windows += 1
                wrapped_boards += wraps
                if wrap_windows == 1 or wrap_windows % 10 == 0:
                    level = (logging.ERROR if wrap_windows >= 10
                             else logging.WARNING)
                    logging.getLogger(__name__).log(
                        level,
                        "iteration %d: %d board(s) exhausted the reset pool "
                        "and replayed an instance this window (%d boards "
                        "over %d consecutive windows) — sampling is biased; "
                        "raise PPOConfig.reset_pool_size (episodes are "
                        "ending faster than the derived pool assumed)",
                        it, wraps, wrapped_boards, wrap_windows)
            else:
                wrap_windows = 0
            if self._profiler is not None:
                self._profiler.maybe_stop(it - start)
            self.ckpt.save(it, state)
            if on_iteration is not None:
                on_iteration(it, row)
        # checkpoint_at_end=True parity (skip if the loop already saved it)
        if self.ckpt.latest_step() != start + num_iterations:
            self.ckpt.save(start + num_iterations, state, force=True)
        self.ckpt.wait()
        return TrainResult(run_dir=self.run_dir,
                           checkpoint_dir=self.checkpoint_dir,
                           final_metrics=row, state=state)

    def close(self) -> None:
        if self._profiler is not None:
            self._profiler.close()
        self.logger.close()
        self.ckpt.close()


def latest_run_dir(model_type: str,
                   results_root: str = DEFAULT_RESULTS_ROOT) -> str:
    """Newest run dir for a model type — generate_rollouts' lookup
    (utils/agent/utils.py:165-178)."""
    return find_latest_run(os.path.join(results_root, "PPO"),
                           prefix=f"PPO_{model_type}")
