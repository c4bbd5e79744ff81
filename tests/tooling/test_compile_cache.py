"""Where the persistent compilation cache goes."""

import pathlib

from placement_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_environment_variable_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_is_a_fixed_ignored_directory_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(compile_cache.cache_dir())
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert f"{path.name}/" in ignored
