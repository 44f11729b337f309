"""Samplers through the correlated-book XLA pipelines (parallel/portfolio.py).

``bootstrap``/``block_bootstrap`` replay JOINT recorded days: the per-bar
resample indices come from the shared MARKET stream, so every book member
replays the SAME historical bar each step — the book's cross-sectional
co-movement is exactly what the joint history had (the reference MC replays
one symbol's recorded bars, qmmx_monolithic.py:3353-3538; a book replays the
joint days).  ``heston`` correlates BOTH the price shock and the variance
shock through the same beta loading.
"""

import jax
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as U

from .samples import stacked_histories as _stacked_histories

ROWS2 = [
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
     {"color": "teal", "type": "dashed", "index": 0, "price": 100.4}],
    [{"color": "orange", "type": "solid", "index": 0, "price": 50.2}],
]
S0 = np.array([100.0, 50.0], np.float32)
SG = np.array([0.3, 0.4], np.float32)      # unused by bootstrap bars
BETA = np.array([0.8, 0.6], np.float32)
WTS = np.array([0.5, 0.5], np.float32)
HPARAMS = dict(v0=0.09, kappa=2.0, theta=0.05, xi=0.9, rho=-0.6)


def test_portfolio_mc_engine_bootstrap_joint_days():
    """XLA book pipeline under recorded days: two members with the SAME
    history and s0 replay identical joint days (the resample indices are
    drawn once per block from the market stream), and real recorded volumes
    reach the gates."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    lv = U.stack_levels([ROWS2[0], ROWS2[0]], max_levels=4)
    hist2 = _stacked_histories([7, 7], 160)
    params = EngineParams.default(stop_padding=0.25, tp_padding=0.18)
    sym, port, skips, escal = portfolio_mc_engine(
        jax.random.key(5), lv, params,
        np.array([100.0, 100.0], np.float32), SG, BETA, WTS,
        num_paths=1 << 10, num_bars=16, block_paths=1 << 9,
        sampler="bootstrap", hist_bars=hist2)
    # same joint days + same levels/knobs -> identical bar tapes; only the
    # idiosyncratic tie coins differ, and ties need exact stop==target bars
    for fld in ("n", "n_entered", "sum_trades"):
        assert float(getattr(sym, fld)[0]) == float(getattr(sym, fld)[1]), fld
    assert float(port.n) == float(1 << 10)
    assert float(sym.n_entered[0]) > 0


@pytest.mark.slow
def test_portfolio_mc_engine_block_bootstrap_and_heston_run():
    """The remaining XLA book samplers execute and produce sane books."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    lv = U.stack_levels(ROWS2, max_levels=4)
    hist2 = _stacked_histories([11, 23], 160)
    params = EngineParams.default(stop_padding=0.25, tp_padding=0.18)
    sym, port, skips, escal = portfolio_mc_engine(
        jax.random.key(6), lv, params, S0, SG, BETA, WTS,
        num_paths=1 << 9, num_bars=12, block_paths=1 << 9,
        sampler="block_bootstrap", hist_bars=hist2, block_len=4)
    assert float(port.n) == float(1 << 9)
    h_sym, h_port, _, _ = portfolio_mc_engine(
        jax.random.key(6), lv, params, S0, SG, BETA, WTS,
        num_paths=1 << 9, num_bars=12, block_paths=1 << 9,
        sampler="heston", heston=HPARAMS)
    g_sym, g_port, _, _ = portfolio_mc_engine(
        jax.random.key(6), lv, params, S0, SG, BETA, WTS,
        num_paths=1 << 9, num_bars=12, block_paths=1 << 9)
    assert float(h_port.n) == float(1 << 9)
    # same key, different sampler -> different books
    assert (float(h_port.sum_r) != float(g_port.sum_r)
            or float(h_port.sum_trades) != float(g_port.sum_trades))


def test_portfolio_mc_engine_sampler_validation():
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    lv = U.stack_levels(ROWS2, max_levels=4)
    with pytest.raises(ValueError, match="hist_bars"):
        portfolio_mc_engine(
            jax.random.key(0), lv, EngineParams.default(), S0, SG, BETA,
            WTS, num_paths=512, num_bars=8, block_paths=512,
            sampler="bootstrap")
    with pytest.raises(ValueError, match="sampler"):
        portfolio_mc_engine(
            jax.random.key(0), lv, EngineParams.default(), S0, SG, BETA,
            WTS, num_paths=512, num_bars=8, block_paths=512,
            sampler="cauchy")


def test_book_antithetic_validation():
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc,
        portfolio_mc_engine,
    )

    lv = U.stack_levels(ROWS2, max_levels=4)
    hist2 = _stacked_histories([11, 23], 160)
    with pytest.raises(ValueError, match="gbm"):
        portfolio_mc_engine(
            jax.random.key(0), lv, EngineParams.default(), S0, SG, BETA,
            WTS, num_paths=512, num_bars=8, block_paths=512,
            sampler="heston", antithetic=True)
    with pytest.raises(ValueError, match="gbm"):
        portfolio_mc(
            jax.random.key(0), lv, EngineParams.default(), S0, SG, BETA,
            WTS, num_paths=512, num_bars=8, block_paths=512,
            sampler="bootstrap", hist_bars=hist2, antithetic=True)
    with pytest.raises(ValueError, match="even"):
        portfolio_mc_engine(
            jax.random.key(0), lv, EngineParams.default(), S0, SG, BETA,
            WTS, num_paths=511, num_bars=8, block_paths=511, antithetic=True)


@pytest.mark.slow
def test_portfolio_mc_engine_antithetic_runs():
    """XLA book antithetic: n preserved, pairs flip market+idio (differs
    from the plain run on the same key)."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    lv = U.stack_levels(ROWS2, max_levels=4)
    params = EngineParams.default(stop_padding=0.25, tp_padding=0.18)
    a_sym, a_port, _, _ = portfolio_mc_engine(
        jax.random.key(9), lv, params, S0, SG, BETA, WTS,
        num_paths=1 << 10, num_bars=12, block_paths=1 << 9, antithetic=True)
    p_sym, p_port, _, _ = portfolio_mc_engine(
        jax.random.key(9), lv, params, S0, SG, BETA, WTS,
        num_paths=1 << 10, num_bars=12, block_paths=1 << 9)
    assert float(a_port.n) == float(p_port.n) == float(1 << 10)
    assert (float(a_port.sum_r) != float(p_port.sum_r)
            or float(a_port.sum_trades) != float(p_port.sum_trades))


def test_portfolio_mc_gated_samplers_run():
    """The XLA gated book accepts the sampler set: joint-days identity for
    bootstrap, heston differs from gbm on the same key."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc,
    )

    lv = U.stack_levels([ROWS2[0], ROWS2[0]], max_levels=4)
    hist2 = _stacked_histories([7, 7], 160)
    params = EngineParams.default(stop_padding=0.25, tp_padding=0.18)
    sym, port = portfolio_mc(
        jax.random.key(5), lv, params,
        np.array([100.0, 100.0], np.float32), SG, BETA, WTS,
        num_paths=1 << 10, num_bars=16, block_paths=1 << 9,
        sampler="bootstrap", hist_bars=hist2)
    for fld in ("n", "n_entered", "sum_trades"):
        assert float(getattr(sym, fld)[0]) == float(getattr(sym, fld)[1]), fld
    lv2 = U.stack_levels(ROWS2, max_levels=4)
    h_sym, h_port = portfolio_mc(
        jax.random.key(5), lv2, params, S0, SG, BETA, WTS,
        num_paths=1 << 9, num_bars=12, block_paths=1 << 9,
        sampler="heston", heston=HPARAMS)
    g_sym, g_port = portfolio_mc(
        jax.random.key(5), lv2, params, S0, SG, BETA, WTS,
        num_paths=1 << 9, num_bars=12, block_paths=1 << 9)
    assert float(h_port.n) == float(1 << 9)
    assert (float(h_port.sum_r) != float(g_port.sum_r)
            or float(h_port.sum_trades) != float(g_port.sum_trades))
