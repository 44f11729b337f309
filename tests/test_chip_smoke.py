"""chip_smoke.py off the card: its refusals and its comparison helpers."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as CS
from qmmx_monolithic_monte_carlo_tpu.sim.pathsim import PathStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_to_run_without_a_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_refuses_to_run_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _stats(n_tp, sum_r):
    s = PathStats.zero()
    return s.replace(n=np.float32(100), n_tp=np.float32(n_tp),
                     n_entered=np.float32(90), sum_r=np.float32(sum_r),
                     hist=np.zeros(128, np.float32))


def test_flip_budget_and_count_diffs():
    assert set(CS.BUDGET) == {"mc", "kernel", "first contact", "engine", "tail",
                              "book", "flywheel", "mesh"}
    assert all(2 <= v <= 40 for v in CS.BUDGET.values())
    a, b = _stats(40, 1.0), _stats(43, 1.0)
    assert CS.count_diffs(a, b) == 3
    assert CS.count_diffs((a, np.arange(4.0)), (a, np.arange(4.0) + 1)) == 1


def test_compare_stats_enforces_the_budget(capsys):
    CS.compare_stats("same", _stats(40, 1.25), _stats(42, 1.5), n_paths=100,
                     budget=2)
    with pytest.raises(CS.SmokeFailure, match="count difference 3"):
        CS.compare_stats("over", _stats(40, 1.0), _stats(43, 1.0), n_paths=100,
                         budget=2)
    with pytest.raises(CS.SmokeFailure, match="sum_r"):
        CS.compare_stats("sums", _stats(40, 1.25), _stats(40, 100.5), n_paths=100,
                         budget=2)
    with pytest.raises(ValueError):
        CS.compare_stats("big", _stats(40, 1.0), _stats(40, 1.0),
                         n_paths=1 << 24, budget=2)
    assert "ok" in capsys.readouterr().out


def test_near_threshold_inputs_sit_within_1e4_of_the_threshold():
    q = 0.6
    coef, b, stop, x, want = CS.near_threshold_ml(1 << 16, q, 0)
    p64 = 1 / (1 + np.exp(-(coef.astype(np.float64) @ x.astype(np.float64) + b)))
    m = np.abs(p64 - q)
    assert want.size > 1000 and m.min() >= 1e-5 and m.max() <= 1e-4
    assert np.array_equal(want, p64 >= q) and 0 < want.mean() < 1
    w, xp, want_p = CS.near_threshold_policy(1 << 16, q, 1)
    head0 = 1 / (1 + np.exp(-(xp.astype(np.float64) @ w[0].astype(np.float64))))
    assert want_p.shape[0] > 1000 and np.abs(head0 - q).max() <= 1e-4


def test_replay_on_both_compares_every_count_and_label(capsys):
    """With the CPU standing in for the card, the identical-input check of
    an engine replay with harvest passes and returns the card's outcome."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
    from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    cpu = jax.devices("cpu")[0]
    ctx = type("Ctx", (), {"gpu": cpu, "cpu": cpu})()
    levels = Levels.from_rows([{"color": "blue", "type": "solid", "index": 0,
                                "price": 100.0}], max_levels=4)
    bars = pathsim.sample_block(
        jax.random.key(1), block_paths=64, num_bars=16, s0=100.0, mu=0.0,
        sigma=0.3, dt=1.0 / (390.0 * 252.0), sampler="gbm", hist_bars=None,
        antithetic=False)
    tie = jax.random.uniform(jax.random.key(2), (64, 16))
    g = CS.replay_on_both("tiny", ctx, lambda b, t: EP.engine_path_replay(
        b, levels, EngineParams.default(), t, harvest=True), bars, tie)
    assert g.harvest is not None and g.trades.shape == (64,)
    assert "ok   tiny" in capsys.readouterr().out
