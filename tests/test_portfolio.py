"""Correlated multi-symbol universes + portfolio risk (parallel/portfolio.py).

The reference has no multi-symbol concept at all (its engine and MC hold one
ticker, qmmx_monolithic.py:3353-3538) — these are joint-law capabilities the
rebuild adds: one-factor correlated shocks, per-path portfolio equity curves,
book-level VaR/CVaR and time-tracked portfolio drawdown."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.parallel import universe as U
from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import portfolio_mc

W = 16
PARAMS = EngineParams.default()

ROWS2 = [
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0}],
    [{"color": "orange", "type": "dashed", "index": 0, "price": 50.2}],
]


def test_portfolio_mc_weighted_sums_and_dd_bound():
    """Portfolio final R is the weighted sum of per-symbol equities (paths
    with no trades carry zero equity, so the entered-mask bookkeeping drops
    out), and the book's time-tracked drawdown is bounded by the weighted
    sum of per-symbol drawdowns (subadditivity of peak-tracked dd)."""
    lv = U.stack_levels(ROWS2, max_levels=4)
    s0 = np.array([100.0, 50.0], np.float32)
    sg = np.array([0.3, 0.4], np.float32)
    w = np.array([0.6, 0.4], np.float32)
    beta = np.array([0.7, 0.7], np.float32)
    sym, port = portfolio_mc(
        jax.random.key(0), lv, PARAMS, s0, sg, beta, w,
        num_paths=1 << 12, num_bars=W, block_paths=1 << 11)
    assert float(port.n) == 1 << 12
    wsum = sum(float(w[s]) * float(sym.sum_r[s]) for s in range(2))
    assert float(port.sum_r) == pytest.approx(wsum, rel=1e-4, abs=1e-3)
    dd_bound = sum(float(w[s]) * float(sym.max_dd[s]) for s in range(2))
    assert 0.0 <= float(port.max_dd) <= dd_bound + 1e-5
    # trade totals aggregate the whole book
    assert float(port.sum_trades) == pytest.approx(
        float(sym.sum_trades.sum()))
    assert float(port.n_tp) == pytest.approx(float(sym.n_tp.sum()))
    assert float(port.hist.sum()) == pytest.approx(float(port.n_entered))


def test_portfolio_mc_correlation_raises_book_variance():
    """Diversification is visible ONLY in the joint law: four identical
    symbols at beta=1 co-move (book variance ~ single-symbol variance)
    while beta=0 diversifies (variance ~ 1/S) — per-symbol marginals are
    identical in both runs."""
    rows = [[{"color": "blue", "type": "solid", "index": 0,
              "price": 100.0}]] * 4
    lv = U.stack_levels(rows, max_levels=4)
    s0 = np.full(4, 100.0, np.float32)
    sg = np.full(4, 0.3, np.float32)
    w = np.full(4, 0.25, np.float32)

    def var_at(beta):
        _, port = portfolio_mc(
            jax.random.key(0), lv, PARAMS, s0, sg,
            np.full(4, beta, np.float32), w,
            num_paths=1 << 13, num_bars=W, block_paths=1 << 12)
        m = float(port.sum_r) / float(port.n_entered)
        return float(port.sum_r2) / float(port.n_entered) - m * m

    v0, v1 = var_at(0.0), var_at(1.0)
    assert v1 > 2.0 * v0  # expected ratio ~S=4


@pytest.mark.slow
def test_portfolio_mc_engine_weighted_sums_and_aggregates():
    """The FULL-engine book pipeline: portfolio final R is the weighted sum
    of per-symbol engine equities, book drawdown is subadditive, and the
    skip table / escalation counts come back per symbol (the log-analyzer
    diagnostics at book scale)."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )
    from qmmx_monolithic_monte_carlo_tpu.sim.enginepath import SKIP_REASONS

    lv = U.stack_levels(ROWS2, max_levels=4)
    s0 = np.array([100.0, 50.0], np.float32)
    sg = np.array([0.3, 0.4], np.float32)
    w = np.array([0.6, 0.4], np.float32)
    beta = np.array([0.7, 0.7], np.float32)
    sym, port, skips, escal = portfolio_mc_engine(
        jax.random.key(0), lv, PARAMS, s0, sg, beta, w,
        num_paths=1 << 11, num_bars=W, block_paths=1 << 10)
    assert float(port.n) == 1 << 11
    wsum = sum(float(w[s]) * float(sym.sum_r[s]) for s in range(2))
    assert float(port.sum_r) == pytest.approx(wsum, rel=1e-4, abs=1e-3)
    dd_bound = sum(float(w[s]) * float(sym.max_dd[s]) for s in range(2))
    assert 0.0 <= float(port.max_dd) <= dd_bound + 1e-5
    assert float(port.sum_trades) == pytest.approx(
        float(sym.sum_trades.sum()))
    assert float(port.hist.sum()) == pytest.approx(float(port.n_entered))
    # per-symbol diagnostics: every (path, bar) evaluation lands in some
    # bucket or enters — totals are bounded by paths*bars
    assert skips.shape == (2, len(SKIP_REASONS))
    assert np.all(np.asarray(skips) >= 0.0)
    assert np.all(np.asarray(skips).sum(axis=1) <= (1 << 11) * W)
    assert escal.shape == (2,)


def test_portfolio_mc_engine_correlation_raises_book_variance():
    """Same joint-law check as the gated surface, under the full engine:
    beta=1 co-movement concentrates book risk vs beta=0 diversification."""
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    rows = [[{"color": "blue", "type": "solid", "index": 0,
              "price": 100.0}]] * 4
    lv = U.stack_levels(rows, max_levels=4)
    s0 = np.full(4, 100.0, np.float32)
    sg = np.full(4, 0.3, np.float32)
    w = np.full(4, 0.25, np.float32)

    def var_at(beta):
        _, port, _, _ = portfolio_mc_engine(
            jax.random.key(0), lv, PARAMS, s0, sg,
            np.full(4, beta, np.float32), w,
            num_paths=1 << 12, num_bars=W, block_paths=1 << 11)
        m = float(port.sum_r) / float(port.n_entered)
        return float(port.sum_r2) / float(port.n_entered) - m * m

    v0, v1 = var_at(0.0), var_at(1.0)
    assert v1 > 1.5 * v0


@pytest.mark.slow
def test_portfolio_mc_engine_harvest_accumulates_and_refreshes():
    """The XLA book pipeline's harvest=True: per-symbol label counts equal
    the book's closed-trade counts across scan blocks, and the harvested
    statistics drive the per-symbol batched LR refresh (BASELINE config 4's
    shape) end to end."""
    from qmmx_monolithic_monte_carlo_tpu.models import harvest as HV
    from qmmx_monolithic_monte_carlo_tpu.parallel.portfolio import (
        portfolio_mc_engine,
    )

    lv = U.stack_levels(ROWS2, max_levels=4)
    s0 = np.array([100.0, 50.0], np.float32)
    sg = np.array([0.4, 0.5], np.float32)
    w = np.array([0.6, 0.4], np.float32)
    beta = np.array([0.7, 0.7], np.float32)
    params = EngineParams.default(stop_padding=0.15, tp_padding=0.10)
    sym, port, skips, escal, hv = portfolio_mc_engine(
        jax.random.key(0), lv, params, s0, sg, beta, w,
        num_paths=1 << 11, num_bars=24, block_paths=1 << 10, harvest=True)
    assert hv.ml_counts.shape == (2, HV.ML_BUCKETS, 2)
    np.testing.assert_allclose(
        np.asarray(hv.n_labeled), np.asarray(sym.n_tp + sym.n_stop))
    assert float(hv.n_labeled.sum()) > 0

    # harvest must not perturb the book stats
    b_sym, b_port, _, _ = portfolio_mc_engine(
        jax.random.key(0), lv, params, s0, sg, beta, w,
        num_paths=1 << 11, num_bars=24, block_paths=1 << 10)
    for f in ("n", "n_entered", "n_tp", "n_stop", "sum_trades", "sum_r"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sym, f)), np.asarray(getattr(b_sym, f)), f)

    # the harvested book feeds the per-symbol batched refresh (config 4)
    xs, ys, ws = HV.ml_batch_from_harvest(
        hv, stop_padding=params.stop_padding)
    assert xs.shape == (2, 2 * HV.ML_BUCKETS, 4)
    m = U.universe_policy_refresh(None, xs, ys, ws)
    assert np.all(np.isfinite(np.asarray(m.coef)))
