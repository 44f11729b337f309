"""Driver-contract tests for ``__graft_entry__`` in its SHIPPED form.

A ``dryrun_multichip`` that only works under the test conftest (which
pre-sets the virtual-CPU env) fails when it is called with an accelerator
backend eligible and no XLA_FLAGS.  These tests spawn clean subprocesses so
the exact code path a caller hits is what runs — no conftest environment
leaks in.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env(**extra):
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env.update(extra)
    return env


@pytest.mark.slow
def test_dryrun_multichip_from_clean_env():
    """No XLA_FLAGS, no JAX_PLATFORMS: dryrun_multichip must still build an
    8-device mesh (via its subprocess fallback) and run the sharded step."""
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    assert "dryrun_multichip OK" in r.stdout
    assert "'paths': 4" in r.stdout and "'symbols': 2" in r.stdout


@pytest.mark.slow
def test_dryrun_multichip_after_backend_init():
    """Even after jax.devices() has initialized a 1-device backend in the
    calling process (CPU stands in for a GPU here), the dryrun must recover
    via the subprocess path."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); jax.devices(); "
        "import __graft_entry__ as g; g.dryrun_multichip(8)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    assert "dryrun_multichip OK" in r.stdout


@pytest.mark.slow
def test_dryrun_multichip_inproc_when_env_ready():
    """With the virtual-CPU env pre-set (the conftest/driver-happy case) the
    run stays in-process — no nested subprocess env mangling."""
    code = (
        "import __graft_entry__ as g; "
        "assert g._cpu_mesh_ready(8); g.dryrun_multichip(8)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_clean_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu",
        ),
        capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    assert "dryrun_multichip OK" in r.stdout


@pytest.mark.slow
def test_dryrun_gated_scalars_match_single_device():
    """The dryrun's gated/engine scalars are REAL values: the 8-device mesh
    result must equal a single-device run of the same blocks (block RNG is
    keyed by global block index, so the mesh shape cannot matter; sums agree
    to reduction-order ulps, trade counts exactly)."""
    import re

    import jax
    import numpy as np

    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO,
        env=_clean_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu",
        ),
        capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    m = re.search(
        r"gated_sum_r=(-?[\d.]+) gated_trades=(\d+) "
        r"engine_sum_r=(-?[\d.]+) engine_trades=(\d+)", r.stdout)
    assert m, r.stdout
    gated_sum_r, gated_trades = float(m.group(1)), float(m.group(2))
    engine_sum_r, engine_trades = float(m.group(3)), float(m.group(4))
    # single-device reference: same key, same (levels, params, shapes, block
    # layout) as __graft_entry__._dryrun_multichip_impl (4 paths-shards x 256)
    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
    from qmmx_monolithic_monte_carlo_tpu.sim.gatedpath import (
        GateConfig,
        mc_paths_gated,
    )
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    levels = Levels.from_rows(
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0}],
        max_levels=4)
    params = EngineParams.default()
    key = jax.random.key(0)
    want_g = mc_paths_gated(
        key, levels, params, GateConfig.from_params(params),
        num_paths=1024, num_bars=16, sigma=0.3, block_paths=256)
    assert gated_trades == float(want_g.sum_trades)
    np.testing.assert_allclose(gated_sum_r, float(want_g.sum_r),
                               rtol=2e-4, atol=2e-3)
    want_e, _, _ = EP.mc_paths_engine(
        key, levels, params, num_paths=1024, num_bars=16, sigma=0.3,
        block_paths=256)
    assert engine_trades == float(want_e.sum_trades)
    np.testing.assert_allclose(engine_sum_r, float(want_e.sum_r),
                               rtol=2e-4, atol=2e-3)


def test_entry_traces_cheaply_in_default_set():
    """Default-set driver-contract smoke (the full dryruns are slow-marked):
    entry() must import and its (fn, args) must TRACE — jax.eval_shape runs
    the whole jit trace without compiling or executing, so a broken
    signature/shape contract fails here in seconds."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');\n"
         "import __graft_entry__ as g\n"
         "fn, args = g.entry()\n"
         "out = jax.eval_shape(fn, *args)\n"
         "print('entry trace ok', jax.tree_util.tree_structure(out))"],
        cwd=REPO, env=_clean_env(JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    assert "entry trace ok" in r.stdout
