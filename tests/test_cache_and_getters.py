"""Compile-cache placement and engine-getter caching (a fresh jit per
dispatch would mean a fresh XLA compile per dispatch)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and no directory is set in code;
    without it the cache lives at <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("from miniwfa_tpu.utils.cache import cache_dir, "
            "enable_compile_cache\n"
            "enable_compile_cache()\n"
            "import jax\n"
            "print(cache_dir())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    assert out[0] == want
    assert out[1] == want


def _spec(B):
    from miniwfa_tpu.ops.wavefront import MODE_SCORE, WfSpec
    return WfSpec(B=B, W=128, S_CAP=128, LT=128, LQ=128,
                  x=4, o1=4, e1=2, o2=15, e2=1, mode=MODE_SCORE)


def test_get_aligner_is_cached():
    from miniwfa_tpu.ops.wavefront import get_aligner
    assert get_aligner(_spec(4)) is get_aligner(_spec(4))
    assert get_aligner(_spec(4)) is not get_aligner(_spec(8))


def test_get_sharded_aligner_is_cached():
    import jax
    from jax.sharding import Mesh
    from miniwfa_tpu.ops.wavefront import get_sharded_aligner
    mesh = Mesh(np.array(jax.devices()), ("data",))
    f1 = get_sharded_aligner(_spec(8), mesh, "data")
    assert get_sharded_aligner(_spec(8), mesh, "data") is f1
