"""Argparse wiring smoke test for every CLI entry point.

Each script must at minimum parse ``--help`` and exit 0 — catches import
errors and argparse rot in the tools/experiments surface without running
any compute.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]

CLIS = [
    "experiments/ppo.py",
    "experiments/learning_curve.py",
    "experiments/seed_sweep.py",
    "experiments/random_policy/run_policy_square.py",
    "experiments/random_policy/run_policy_rectangular.py",
    "experiments/random_policy/run_policy_rectangular_pin.py",
    "tools/train_throughput.py",
    "chip_smoke.py",
]


@pytest.mark.parametrize("script", CLIS, ids=lambda s: s.split("/")[-1])
def test_cli_help_exits_zero(script):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, str(REPO / script), "--help"],
                       capture_output=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-2000:]
    assert b"usage" in r.stdout.lower()
