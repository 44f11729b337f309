"""Monte Carlo robustness simulation (``simulate_monte_carlo``) — the north star.

Re-expression of qmmx_monolithic.py:3353-3538 as a fully-batched device program:

* candidates discovered once (proximity → side → touch-limit → optional gates,
  with the gate result allowed to override level/side, :3380-3442);
* per (trial, candidate) noise: level jitter N(0, 0.02), entry slip N(0, 0.01),
  optional stop/target slips, each on its own threefry stream keyed by
  (trial, candidate) — order-independent where the reference burns one serial RNG
  (:3449-3461, :3489);
* first-hit walk with the distance-weighted same-bar coin flip (:3467-3480);
* per-trial equity curve → total R, peak-tracked max drawdown, win/loss/open
  counts (:3491-3510) and the summary statistics (:3512-3525).

The O(bars) walk per (trial, candidate) collapses to two ``searchsorted`` probes
into per-candidate running-extremum arrays (hitscan.first_hit_monotone_*): the
running min of lows / max of highs after the candidate bar is monotone, so the
first threshold crossing is a binary search.  Cost per trial-candidate is
O(log N) instead of O(N), and everything vmaps across trials.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import CompatFlags, EngineParams
from ..engine.state import EngineCarry, MlModel
from ..ops import hitscan as H
from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP, SIDE_LONG, Bars, Levels
from ..utils import prng
from .candidates import Candidates, find_candidates
from .summary import McSummary, mc_summary


@struct.dataclass
class McNoise:
    entry_slip_std: jnp.ndarray
    level_jitter_std: jnp.ndarray
    stop_slip_std: jnp.ndarray
    target_slip_std: jnp.ndarray

    @classmethod
    def default(cls) -> "McNoise":
        # reference defaults (:3353-3355)
        return cls(
            entry_slip_std=jnp.float32(0.01),
            level_jitter_std=jnp.float32(0.02),
            stop_slip_std=jnp.float32(0.0),
            target_slip_std=jnp.float32(0.0),
        )

    @classmethod
    def make(cls, entry_slip_std=0.01, level_jitter_std=0.02,
             stop_slip_std=0.0, target_slip_std=0.0) -> "McNoise":
        return cls(
            entry_slip_std=jnp.float32(entry_slip_std),
            level_jitter_std=jnp.float32(level_jitter_std),
            stop_slip_std=jnp.float32(stop_slip_std),
            target_slip_std=jnp.float32(target_slip_std),
        )


@struct.dataclass
class McResult:
    candidates: Candidates
    totals: jnp.ndarray     # f32[T] per-trial total R
    max_dds: jnp.ndarray    # f32[T] (negative)
    wins: jnp.ndarray       # i32[T]
    losses: jnp.ndarray     # i32[T]
    opens: jnp.ndarray      # i32[T]
    summary: McSummary


def _precompute_runs(bars: Bars):
    """Per-candidate-bar running extremes over subsequent bars: [N, N] arrays where
    row i covers bars j>i (inf/-inf elsewhere), monotone along j."""
    n = bars.num_bars
    i = jnp.arange(n)
    after = jnp.logical_and(i[None, :] > i[:, None], bars.valid[None, :])
    lows = jnp.where(after, bars.low[None, :], jnp.inf)
    highs = jnp.where(after, bars.high[None, :], -jnp.inf)
    return H.running_min(lows), H.running_max(highs)


def trial_outcomes(
    key: jax.Array,
    bars: Bars,
    cands: Candidates,
    noise: McNoise,
    params: EngineParams,
    trial_index,
    run_min_low=None,
    run_max_high=None,
    side_aware_tie: bool = False,
):
    """All candidate outcomes for one trial. Returns (r, outcome) f32/i32 [N]."""
    n = bars.num_bars
    if run_min_low is None:
        run_min_low, run_max_high = _precompute_runs(bars)
    cand_ids = jnp.arange(n, dtype=jnp.uint32)

    def draws(stream, std):
        k = prng.key_for(key, stream, trial_index)
        return jax.random.normal(k, (n,), jnp.float32) * std

    lvl_j = cands.level_price + draws(prng.STREAM_LEVEL_JITTER, noise.level_jitter_std)
    entry = cands.entry + draws(prng.STREAM_ENTRY_SLIP, noise.entry_slip_std)
    is_long = cands.side == SIDE_LONG
    stop = jnp.where(is_long, lvl_j - params.stop_padding, lvl_j + params.stop_padding)
    stop = stop + draws(prng.STREAM_STOP_SLIP, noise.stop_slip_std)
    target = jnp.where(is_long, lvl_j + params.tp_padding, lvl_j - params.tp_padding)
    target = target + draws(prng.STREAM_TARGET_SLIP, noise.target_slip_std)
    tie_u = jax.random.uniform(
        prng.key_for(key, prng.STREAM_TIE_COIN, trial_index), (n,), jnp.float32
    )

    # first-hit via monotone searchsorted per candidate row
    vseq = jax.vmap(H.first_hit_monotone_leq)
    vseq_geq = jax.vmap(H.first_hit_monotone_geq)
    j_stop_long = vseq(run_min_low, stop)
    j_stop_short = vseq_geq(run_max_high, stop)
    j_tgt_long = vseq_geq(run_max_high, target)
    j_tgt_short = vseq(run_min_low, target)
    j_stop = jnp.where(is_long, j_stop_long, j_stop_short)
    j_tgt = jnp.where(is_long, j_tgt_long, j_tgt_short)

    none_hit = jnp.logical_and(j_stop >= n, j_tgt >= n)
    j_first = jnp.minimum(j_stop, j_tgt)
    tie = jnp.logical_and(j_stop == j_tgt, jnp.logical_not(none_hit))

    jj = jnp.clip(j_first, 0, n - 1)
    hh = bars.high[jj]
    ll = bars.low[jj]
    up_span = jnp.maximum(0.0, hh - entry)
    down_span = jnp.maximum(0.0, entry - ll)
    p_tp = up_span / (up_span + down_span + 1e-9)  # the reference uses the UP
    if side_aware_tie:                              # share for BOTH sides (:3472-3480)
        p_tp = jnp.where(is_long, p_tp, 1.0 - p_tp)
    coin_tp = tie_u < p_tp

    target_first = jnp.where(tie, coin_tp, j_tgt < j_stop)
    risk = jnp.maximum(jnp.abs(entry - stop), 1e-9)
    reward = jnp.abs(target - entry)
    r = jnp.where(none_hit, 0.0, jnp.where(target_first, reward / risk, -1.0))
    outcome = jnp.where(
        none_hit, OUTCOME_OPEN, jnp.where(target_first, OUTCOME_TP, OUTCOME_STOP)
    ).astype(jnp.int32)
    return r.astype(jnp.float32), outcome


def run_trials(
    key: jax.Array,
    bars: Bars,
    cands: Candidates,
    params: EngineParams,
    *,
    trials: int = 500,
    noise: McNoise | None = None,
    side_aware_tie: bool = False,
) -> McResult:
    if noise is None:
        noise = McNoise.default()
    run_min_low, run_max_high = _precompute_runs(bars)
    mask = cands.is_cand

    def one_trial(t):
        r, outcome = trial_outcomes(
            key, bars, cands, noise, params, t,
            run_min_low=run_min_low, run_max_high=run_max_high,
            side_aware_tie=side_aware_tie,
        )
        r = jnp.where(mask, r, 0.0)
        # equity curve over candidates in bar order (:3497-3504)
        eq = jnp.cumsum(r)
        peak = jax.lax.associative_scan(jnp.maximum, jnp.maximum(eq, 0.0))
        max_dd = jnp.min(jnp.minimum(eq - peak, 0.0))
        wins = jnp.sum(jnp.logical_and(mask, outcome == OUTCOME_TP).astype(jnp.int32))
        losses = jnp.sum(jnp.logical_and(mask, outcome == OUTCOME_STOP).astype(jnp.int32))
        opens = jnp.sum(jnp.logical_and(mask, outcome == OUTCOME_OPEN).astype(jnp.int32))
        return jnp.sum(r), max_dd, wins, losses, opens

    totals, max_dds, wins, losses, opens = jax.vmap(one_trial)(
        jnp.arange(trials, dtype=jnp.uint32)
    )
    s = mc_summary(totals, max_dds, wins, losses, opens, cands.count)
    return McResult(
        candidates=cands, totals=totals, max_dds=max_dds,
        wins=wins, losses=losses, opens=opens, summary=s,
    )


def simulate_monte_carlo(
    key: jax.Array,
    bars: Bars,
    levels: Levels,
    params: EngineParams,
    *,
    touch_limit: int = 1,
    trials: int = 500,
    with_gates: bool = True,
    noise: McNoise | None = None,
    carry: EngineCarry | None = None,
    ml_model: MlModel | None = None,
    t0_ms=0,
    side_aware_tie: bool = False,
    compat: CompatFlags = CompatFlags(),
) -> McResult:
    """The full MC pipeline (:3353-3538), pure and jit-able end to end."""
    cands = find_candidates(
        bars, levels, params,
        touch_limit=touch_limit, with_gates=with_gates, mode="mc",
        carry=carry, ml_model=ml_model, t0_ms=t0_ms, compat=compat,
    )
    return run_trials(
        key, bars, cands, params, trials=trials, noise=noise,
        side_aware_tie=side_aware_tie,
    )
