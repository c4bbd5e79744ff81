"""Checkpointing of PPO train state (SURVEY §5.4).

Replaces Ray Tune's checkpointing (``tune.run(..., checkpoint_freq=1,
checkpoint_at_end=True, keep_checkpoints_num=5)``,
``experiments/PPO/PPO.py:43-45``) with a keep-N manager over the full
``TrainState`` pytree (params, optimizer state, adaptive KL coefficient,
batched env states, PRNG key, step counter), so a restored run continues
bit-identically. On-disk layout mirrors the reference's documented
``checkpoint_N/`` directories (``docs/source/usage.rst:284-311``).

Each ``checkpoint_N/`` holds ``arrays.npz`` (leaf ``i`` under key ``"i"``)
and ``tree.json`` (each leaf's path, shape and dtype). A checkpoint is
written into a temporary directory and renamed into place, so a reader
never sees a partial one. In a multi-process run every process calls
``save`` (gathering a sharded array is collective), process 0 writes, and
all wait for the write before going on.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import jax
import numpy as np

_ARRAYS = "arrays.npz"
_TREE = "tree.json"
_STEP_DIR = re.compile(r"^checkpoint_(\d+)$")


def _host_array(x: Any) -> np.ndarray:
    """The whole value of a leaf on this host (collective when the leaf is
    sharded over devices of other processes)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _leaf_specs(tree: Any) -> list:
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return [{"path": jax.tree_util.keystr(p), "shape": list(np.shape(x)),
             "dtype": np.dtype(getattr(x, "dtype", type(x))).name}
            for p, x in leaves]


class CheckpointManager:
    """Keep-N checkpointing of an arbitrary pytree (the TrainState)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}")

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` as checkpoint ``step``. Without ``force`` only
        every ``save_interval``-th step is written. Returns whether it
        was."""
        if not force and step % self.save_interval:
            return False
        arrays = [_host_array(x) for x in jax.tree_util.tree_leaves(state)]
        if jax.process_index() == 0:
            self._write(step, arrays, _leaf_specs(state))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices(f"checkpoint_{step}")
        return True

    def _write(self, step: int, arrays: list, specs: list) -> None:
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _ARRAYS),
                 **{str(i): a for i, a in enumerate(arrays)})
        with open(os.path.join(tmp, _TREE), "w") as f:
            json.dump({"step": step, "leaves": specs}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``target`` (e.g. ``learner.init(k)``).

        ``step=None`` restores the latest checkpoint, mirroring
        ``PPO.restore(checkpoint_path)`` (utils/agent/utils.py:218-219).
        Raises ``ValueError`` when the saved tree's leaf paths, shapes or
        dtypes differ from ``target``'s.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, _TREE)) as f:
            saved = json.load(f)["leaves"]
        expected = _leaf_specs(target)
        if saved != expected:
            diff = next(((s, e) for s, e in zip(saved, expected) if s != e),
                        (len(saved), len(expected)))
            raise ValueError(
                f"checkpoint {path} does not match the target tree: "
                f"saved {diff[0]} vs expected {diff[1]}")
        with np.load(os.path.join(path, _ARRAYS), allow_pickle=False) as z:
            arrays = [jax.device_put(z[str(i)]) for i in range(len(saved))]
        treedef = jax.tree_util.tree_structure(target)
        return jax.tree_util.tree_unflatten(treedef, arrays)

    def all_steps(self) -> list:
        """Steps of the complete checkpoints on disk, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 _TREE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous; kept for callers that wait on them."""

    def close(self) -> None:
        """Nothing is held open between saves."""


def find_latest_run(results_root: str, prefix: str = "") -> str:
    """Newest run directory under ``results_root`` by mtime — the analogue of
    generate_rollouts' newest-``~/ray_results/PPO/*`` lookup
    (utils/agent/utils.py:165-178)."""
    entries = [os.path.join(results_root, d) for d in os.listdir(results_root)
               if d.startswith(prefix)
               and os.path.isdir(os.path.join(results_root, d))]
    if not entries:
        raise FileNotFoundError(
            f"no run directories under {results_root!r} with prefix {prefix!r}")
    return max(entries, key=os.path.getmtime)
