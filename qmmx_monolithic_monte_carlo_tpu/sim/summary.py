"""Summary reductions for the sims: R distributions, VaR/CVaR, drawdowns.

Exact re-expression of the reference's summary math:

* replay summary (qmmx_monolithic.py:3650-3666): wins/losses/open counts, total R
  (sum of per-trade R **rounded to 2 decimals**, as the reference stores rounded
  R in each trade record), avg R over closed, max win/loss in R and $.
* Monte Carlo summary (:3512-3525): per-trial totals → mean/median/pstdev/best/
  worst, VaR(5%) = sorted[max(0, int(0.05·T)-1)], CVaR(5%) = mean of that prefix,
  drawdown stats and mean outcome counts.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP


def _round2(x):
    return jnp.round(jnp.asarray(x, jnp.float32) * 100.0) / 100.0


@struct.dataclass
class ReplaySummary:
    trades: jnp.ndarray        # i32
    wins: jnp.ndarray          # i32
    losses: jnp.ndarray        # i32
    open: jnp.ndarray          # i32
    total_r: jnp.ndarray       # f32 (2-dp-rounded per trade, then summed)
    avg_r_closed: jnp.ndarray  # f32
    max_win_r: jnp.ndarray     # f32
    max_loss_r: jnp.ndarray    # f32
    max_profit_usd: jnp.ndarray  # f32
    max_loss_usd: jnp.ndarray    # f32


def replay_summary(r, outcome, entry, exit_price, side, mask) -> ReplaySummary:
    """Summaries over per-trade arrays with a candidate mask."""
    mask = jnp.asarray(mask)
    is_tp = jnp.logical_and(mask, outcome == OUTCOME_TP)
    is_stop = jnp.logical_and(mask, outcome == OUTCOME_STOP)
    is_open = jnp.logical_and(mask, outcome == OUTCOME_OPEN)
    closed = jnp.logical_or(is_tp, is_stop)

    r2 = _round2(r)
    total_r = _round2(jnp.sum(jnp.where(mask, r2, 0.0)))
    n_closed = jnp.sum(closed.astype(jnp.int32))
    avg_r = _round2(
        jnp.sum(jnp.where(closed, r2, 0.0)) / jnp.maximum(1, n_closed).astype(jnp.float32)
    )
    # $ pnl per share on rounded prices (:3659-3661 uses the rounded trade record)
    pnl_usd = (_round2(exit_price) - _round2(entry)) * jnp.where(side > 0, 1.0, -1.0)
    max_or_zero = lambda m, v: jnp.max(jnp.where(m, v, -jnp.inf))
    min_or_zero = lambda m, v: jnp.min(jnp.where(m, v, jnp.inf))
    any_closed = n_closed > 0
    return ReplaySummary(
        trades=jnp.sum(mask.astype(jnp.int32)),
        wins=jnp.sum(is_tp.astype(jnp.int32)),
        losses=jnp.sum(is_stop.astype(jnp.int32)),
        open=jnp.sum(is_open.astype(jnp.int32)),
        total_r=total_r,
        avg_r_closed=jnp.where(any_closed, avg_r, 0.0),
        max_win_r=jnp.where(any_closed, _round2(max_or_zero(closed, r2)), 0.0),
        max_loss_r=jnp.where(any_closed, _round2(min_or_zero(closed, r2)), 0.0),
        max_profit_usd=jnp.where(any_closed, _round2(max_or_zero(closed, pnl_usd)), 0.0),
        max_loss_usd=jnp.where(any_closed, _round2(min_or_zero(closed, pnl_usd)), 0.0),
    )


@struct.dataclass
class McSummary:
    candidates: jnp.ndarray    # i32
    trials: jnp.ndarray        # i32
    mean_r: jnp.ndarray
    median_r: jnp.ndarray
    stdev_r: jnp.ndarray       # population stdev (reference pstdev, :3521)
    best_r: jnp.ndarray
    worst_r: jnp.ndarray
    var_05: jnp.ndarray
    cvar_05: jnp.ndarray
    mean_max_dd: jnp.ndarray
    worst_max_dd: jnp.ndarray
    mean_wins: jnp.ndarray
    mean_losses: jnp.ndarray
    mean_open: jnp.ndarray


def mc_summary(totals, max_dds, wins, losses, opens, n_candidates) -> McSummary:
    """Per-trial arrays → the reference's MC summary (:3512-3525)."""
    totals = jnp.asarray(totals, jnp.float32)
    t = totals.shape[0]
    sorted_totals = jnp.sort(totals)
    p05_idx = max(0, int(0.05 * t) - 1)
    var_05 = sorted_totals[p05_idx]
    cvar_05 = jnp.mean(sorted_totals[: p05_idx + 1])
    # statistics.median: mean of the two middle values for even counts
    mid = t // 2
    median = jnp.where(
        t % 2 == 1, sorted_totals[mid], 0.5 * (sorted_totals[mid - 1] + sorted_totals[mid])
    ) if t > 1 else sorted_totals[0]
    return McSummary(
        candidates=jnp.asarray(n_candidates, jnp.int32),
        trials=jnp.int32(t),
        mean_r=jnp.mean(totals),
        median_r=median,
        stdev_r=jnp.std(totals),
        best_r=jnp.max(totals),
        worst_r=jnp.min(totals),
        var_05=var_05,
        cvar_05=cvar_05,
        mean_max_dd=jnp.mean(jnp.asarray(max_dds, jnp.float32)),
        worst_max_dd=jnp.min(jnp.asarray(max_dds, jnp.float32)),
        mean_wins=jnp.mean(jnp.asarray(wins, jnp.float32)),
        mean_losses=jnp.mean(jnp.asarray(losses, jnp.float32)),
        mean_open=jnp.mean(jnp.asarray(opens, jnp.float32)),
    )


def format_mc_summary(s: McSummary) -> str:
    """The human-readable block the reference audits/logs (:3518-3526)."""
    return (
        f"Candidates: {int(s.candidates)} | Trials: {int(s.trials)}\n"
        f"Total R — mean {float(s.mean_r):+.2f}, median {float(s.median_r):+.2f}, "
        f"stdev {float(s.stdev_r):.2f}\n"
        f"Best {float(s.best_r):+.2f} | Worst {float(s.worst_r):+.2f}\n"
        f"VaR(5%) {float(s.var_05):+.2f} | CVaR(5%) {float(s.cvar_05):+.2f}\n"
        f"Max drawdown (R) — mean {float(s.mean_max_dd):+.2f}, "
        f"worst {float(s.worst_max_dd):+.2f}\n"
        f"Avg counts — wins {float(s.mean_wins):.1f}, losses {float(s.mean_losses):.1f}, "
        f"open {float(s.mean_open):.1f}"
    )


def format_replay_summary(s: ReplaySummary, *, n, prox, sp, tp) -> str:
    """The replay audit line (:3669-3674)."""
    r2 = lambda v: round(float(v), 2)
    return (
        f"N={n} | trades={int(s.trades)} | wins={int(s.wins)} loss={int(s.losses)} "
        f"open={int(s.open)} | total_R={r2(s.total_r)} "
        f"avg_R(closed)={r2(s.avg_r_closed)} | "
        f"max_win_R={r2(s.max_win_r)} max_loss_R={r2(s.max_loss_r)} | "
        f"max_profit=${r2(s.max_profit_usd)} max_loss=${r2(s.max_loss_usd)} | "
        f"prox={prox} stop={sp} tp={tp}"
    )
