"""``chip_smoke.py`` refuses to report without a GPU."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode != 0
    assert b'"ok": true' not in r.stdout
    assert b"needs a GPU" in r.stderr
