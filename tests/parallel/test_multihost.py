"""Multi-host execution: 2 real processes over ``jax.distributed``.

BASELINE.md asks for multi-host scale-out; the CLI ships
``--coordinator/--num-processes/--process-id`` flags wired to
``parallel.mesh.initialize_distributed``. This test makes that code path
real: it spawns two CPU-backend subprocesses that form a 2-process
``jax.distributed`` world (localhost coordinator), run a cross-process
collective and one sharded PPO train step over the global mesh, and must
agree on every metric. (Reference analogue: the Ray actor layer replaced
here, experiments/PPO/PPO.py:38.)
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import pytest

# slow tier: 2-process jax.distributed spawns
pytestmark = pytest.mark.slow

REPO = str(pathlib.Path(__file__).resolve().parents[2])
WORKER = str(pathlib.Path(__file__).with_name("_multihost_worker.py"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_import_does_not_initialize_backend():
    """Importing the package must not initialize the XLA backend:
    ``jax.distributed.initialize`` requires a pristine backend, and the CLI
    imports the package before calling it (experiments/ppo.py). A stray
    module-level ``jnp`` constant once broke this (env/routing.py BIG)."""
    code = (
        "import jax\n"
        "import placement_tpu.agent.trainer, placement_tpu.parallel.mesh\n"
        "import placement_tpu.viz.rollout\n"
        # private JAX internals can move across upgrades — fall back to a
        # no-op check rather than failing on an attribute rename
        "try:\n"
        "    import jax._src.xla_bridge as xb\n"
        "    backends = getattr(xb, '_backends', None)\n"
        "except ImportError:\n"
        "    backends = None\n"
        "assert not backends, 'import initialized the XLA backend'\n")
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, XLA_FLAGS="")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-2000:]


def test_two_process_distributed_train_step():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               # don't inherit the parent's single-process test settings
               XLA_FLAGS="")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coordinator, "2", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, (
                f"worker rc={p.returncode}\n--- stderr ---\n"
                f"{err.decode(errors='replace')[-4000:]}")
            outs.append(json.loads(
                out.decode(errors="replace").strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    a, b = outs
    assert a["process_count"] == b["process_count"] == 2
    assert a["global_devices"] == b["global_devices"] == 2
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-6, (k, a[k], b[k])
    assert a["episodes_this_iter"] > 0
    assert a["pool_wraps"] == 0


def test_two_process_training_cli(tmp_path):
    """The SHIPPED multi-host entry point end-to-end: two processes run
    ``experiments/ppo.py --coordinator ... --data-parallel`` against one
    shared run directory. Process 0 writes progress.csv/params.json and the
    checkpoint, after both processes gather the sharded env batch."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, XLA_FLAGS="")
    cli = str(pathlib.Path(REPO) / "experiments" / "ppo.py")
    procs = [subprocess.Popen(
        [sys.executable, cli, "--type", "rectangle_pin",
         "--iterations", "1", "--num-envs", "4", "--unroll-length", "4",
         "--data-parallel",
         "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(i),
         "--run-name", "multihost_cli_test",
         "--results-root", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env)
        for i in range(2)]
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, (
                f"process {i} rc={p.returncode}\n--- stderr ---\n"
                f"{err.decode(errors='replace')[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    run_dir = tmp_path / "PPO" / "multihost_cli_test"
    assert (run_dir / "progress.csv").is_file()
    assert (run_dir / "params.json").is_file()
    ckpts = list((run_dir / "checkpoints").glob("checkpoint_*"))
    assert ckpts, list(run_dir.rglob("*"))
    rows = (run_dir / "progress.csv").read_text().strip().splitlines()
    assert len(rows) == 2            # header + 1 iteration, single writer
    # rollout export ran on process 0 against host-localized variables
    assert (run_dir / "components.pkl").is_file()
    assert (run_dir / "actions.pkl").is_file()
    assert (run_dir / "rectangle_pin.csv").is_file()

    # restore-and-continue across processes: a second 2-process run resumes
    # from the first run's collective checkpoint and keeps counting
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, cli, "--type", "rectangle_pin",
         "--iterations", "1", "--num-envs", "4", "--unroll-length", "4",
         "--data-parallel", "--no-rollouts",
         "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(i),
         "--run-name", "multihost_cli_resume",
         "--restore", str(run_dir),
         "--results-root", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env)
        for i in range(2)]
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, (
                f"resume process {i} rc={p.returncode}\n--- stderr ---\n"
                f"{err.decode(errors='replace')[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    resume_csv = tmp_path / "PPO" / "multihost_cli_resume" / "progress.csv"
    line = resume_csv.read_text().strip().splitlines()[-1]
    # restored step counter continues: iteration 2, timesteps 32 (2 x 16)
    assert line.startswith("2,32,"), line
