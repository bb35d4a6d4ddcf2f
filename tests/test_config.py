"""Compile-cache path rules (config.compilation_cache_dir)."""

import os
import subprocess
import sys

import pytest

from idg_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_cache_dir_is_fixed_in_checkout():
    assert config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_cache_dir_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compilation_cache_dir() == config.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("env", ["/some/where/jax", "relative/cache"])
def test_cache_dir_follows_env(monkeypatch, env):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert config.compilation_cache_dir() == env


def test_empty_env_means_default(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert config.compilation_cache_dir() == config.DEFAULT_CACHE_DIR


def test_default_is_not_derived_from_process_or_time():
    """Two processes agree on the directory (a moving path never hits)."""
    code = "from idg_tpu import config; print(config.compilation_cache_dir())"
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    outs = {subprocess.run([sys.executable, "-c", code], env=env, text=True,
                           capture_output=True, check=True).stdout.strip()
            for _ in range(2)}
    assert outs == {config.DEFAULT_CACHE_DIR}


@pytest.mark.parametrize("env", [None, "cache_here"])
def test_setup_writes_entries_to_the_chosen_dir(tmp_path, env):
    """A compile in a fresh process lands in the directory the rules name."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from idg_tpu.config import setup_compilation_cache\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "print(setup_compilation_cache())\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.arange(7.0)).block_until_ready()\n"
    )
    run_env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    run_env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    want = None
    if env is not None:
        want = str(tmp_path / env)
        run_env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", code], env=run_env, text=True,
                         capture_output=True, cwd=str(tmp_path), check=True)
    path = out.stdout.strip().splitlines()[-1]
    assert path == (want or config.DEFAULT_CACHE_DIR)
    assert os.path.isdir(path) and os.listdir(path)
