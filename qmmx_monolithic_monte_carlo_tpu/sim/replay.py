"""Deterministic replay simulation (``simulate_last_bars``) — fully vectorized.

Re-expression of qmmx_monolithic.py:3540-3699: detect candidates on the last N
minute bars (proximity → side → optional gate re-run → per-level touch limit),
scaffold stop/target off the level, then walk forward to the first stop/target
hit.  In the deterministic walk the **stop is checked before the target within a
bar** (:3623-3628), so a same-bar tie resolves to the stop — unlike the Monte
Carlo's coin flip.  Exit price is the stop/target level itself, not the bar price
(:3636); an unresolved trade exits at the final close with R=0 (:3630-3633).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..config import CompatFlags, EngineParams
from ..engine.state import EngineCarry, MlModel
from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP, SIDE_LONG, Bars, Levels
from .candidates import Candidates, find_candidates
from .summary import ReplaySummary, replay_summary


@struct.dataclass
class ReplayResult:
    candidates: Candidates
    r: jnp.ndarray          # f32[N] per-candidate R
    outcome: jnp.ndarray    # i32[N] OUTCOME_*
    exit_price: jnp.ndarray  # f32[N]
    hit_bar: jnp.ndarray    # i32[N] (num_bars when open)
    summary: ReplaySummary


def replay_outcomes(bars: Bars, cands: Candidates):
    """First-hit walk for every candidate bar, stop-before-target tie order."""
    n = bars.num_bars
    i = jnp.arange(n)
    # forward mask per candidate row: bars strictly after the candidate bar
    after = jnp.logical_and(i[None, :] > i[:, None], bars.valid[None, :])  # [N, N]

    is_long = (cands.side == SIDE_LONG)[:, None]
    lows = bars.low[None, :]
    highs = bars.high[None, :]
    stop_hit = jnp.where(is_long, lows <= cands.stop[:, None], highs >= cands.stop[:, None])
    tgt_hit = jnp.where(is_long, highs >= cands.target[:, None], lows <= cands.target[:, None])
    stop_hit = jnp.logical_and(stop_hit, after)
    tgt_hit = jnp.logical_and(tgt_hit, after)

    def first_idx(hit):
        any_hit = jnp.any(hit, axis=-1)
        return jnp.where(any_hit, jnp.argmax(hit, axis=-1), n)

    j_stop = first_idx(stop_hit)
    j_tgt = first_idx(tgt_hit)
    # stop checked first within a bar (:3623-3628): ties go to the stop
    stopped = j_stop <= j_tgt
    j_first = jnp.minimum(j_stop, j_tgt)
    none_hit = j_first >= n

    risk = jnp.maximum(jnp.abs(cands.entry - cands.stop), 1e-9)
    reward = jnp.abs(cands.target - cands.entry)
    r = jnp.where(none_hit, 0.0, jnp.where(stopped, -1.0, reward / risk))
    outcome = jnp.where(
        none_hit, OUTCOME_OPEN, jnp.where(stopped, OUTCOME_STOP, OUTCOME_TP)
    ).astype(jnp.int32)

    last_close = bars.close[
        jnp.maximum(0, jnp.sum(bars.valid.astype(jnp.int32)) - 1)
    ]
    exit_price = jnp.where(
        none_hit, last_close, jnp.where(stopped, cands.stop, cands.target)
    )
    return r.astype(jnp.float32), outcome, exit_price, j_first.astype(jnp.int32)


def simulate_last_bars(
    bars: Bars,
    levels: Levels,
    params: EngineParams,
    *,
    touch_limit: int = 2,           # method default (:3540); UI button passes 1
    with_gates: bool = False,       # method default (:3540); UI button passes True
    carry: EngineCarry | None = None,
    ml_model: MlModel | None = None,
    t0_ms=0,
    compat: CompatFlags = CompatFlags(),
) -> ReplayResult:
    cands = find_candidates(
        bars, levels, params,
        touch_limit=touch_limit, with_gates=with_gates, mode="replay",
        carry=carry, ml_model=ml_model, t0_ms=t0_ms, compat=compat,
    )
    r, outcome, exit_price, hit_bar = replay_outcomes(bars, cands)
    mask = cands.is_cand
    s = replay_summary(r, outcome, cands.entry, exit_price, cands.side, mask)
    return ReplayResult(
        candidates=cands, r=jnp.where(mask, r, 0.0),
        outcome=jnp.where(mask, outcome, OUTCOME_OPEN).astype(jnp.int32),
        exit_price=exit_price, hit_bar=hit_bar, summary=s,
    )
