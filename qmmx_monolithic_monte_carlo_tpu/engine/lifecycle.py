"""Live-loop trade lifecycle as a pure ``lax.scan`` state machine.

Re-expression of the reference's 0.7 s engine loop (qmmx_monolithic.py:2905-3195)
— tick ingest/bar roll-up (:1857-1883), minute-close pipeline (:1813-1855), the
entry evaluation + state updates (:2936-2955), stop/target/cooldown position
management with target escalation (:2966-3014, :1950-2012), and the app-level
OnlinePolicy gate before opening (:3046-3112).

One ``tick_step`` call == one loop iteration; ``run_ticks`` scans a whole tick
tape, which is both the deterministic live-replay engine and the parity fixture
for the host loop (the host calls the same jitted ``tick_step`` per real tick).

Reference quirks handled explicitly:
* Q2 double evaluation — ``CompatFlags.double_evaluate`` re-runs ``evaluate_entry``
  with identical args, doubling latch/touch side effects (:2936-2949).
* Q8 (new, found while rebuilding): live escalation never fires in the reference
  because ``get_minute_bars`` returns ``{t,o,h,l,c}`` dicts while ``ExitStrategy``
  indexes tuples — the KeyError is swallowed and ``should_exit`` reports no basis
  (:2972, :986-987, :781-782).  ``CompatFlags.escalation_broken`` reproduces that;
  the default implements escalation as designed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import CompatFlags, EngineParams
from ..ops import features as F
from ..ops import guard as G
from ..ops import touch as T
from ..types import DIR_DOWN, DIR_UP, SIDE_LONG, Levels
from . import exits
from .gates import EntryDecision, TickInput, evaluate_entry, tree_select
from .state import CurrentBar, EngineCarry, MlModel, Position
from ..models import online_policy as OP

CLOSE_NONE = 0
CLOSE_STOP = 1
CLOSE_TARGET = 2


@struct.dataclass
class TickEvent:
    """Per-tick observable outputs (the audit/policy-event feed)."""

    decision: EntryDecision
    opened: jnp.ndarray        # bool
    closed: jnp.ndarray        # bool
    close_reason: jnp.ndarray  # i32 CLOSE_*
    exit_price: jnp.ndarray    # f32
    pnl: jnp.ndarray           # f32
    escalated: jnp.ndarray     # bool
    new_stop: jnp.ndarray      # f32 (valid when escalated)
    new_target: jnp.ndarray    # f32
    policy_pass: jnp.ndarray   # bool
    policy_scores: jnp.ndarray  # f32[3]
    exit_scores: jnp.ndarray   # f32[2] exit head [exit_now, hold]
    minute_closed: jnp.ndarray  # bool


def _minute_close(
    carry: EngineCarry,
    levels: Levels,
    touch_params: T.TouchMemoryParams,
    guard_params: G.GuardParams,
    *,
    ts0_ms, o, h, l, c, v,
) -> EngineCarry:
    """The ``_on_minute_close`` pipeline (:1813-1855): push recent bar, compute
    5/20 volume MAs, feed the guard, register accumulation touches, reset the
    touch box on breakout."""
    bars = carry.bars.push(ts0_ms, c, v)
    _, vols, valid = bars.ordered()
    n = jnp.sum(valid.astype(jnp.int32))
    pos_from_end = jnp.cumsum(valid[::-1].astype(jnp.int32))[::-1] - 1

    def tail_mean(k):
        kk = jnp.maximum(1, jnp.minimum(k, n))
        sel = jnp.logical_and(valid, pos_from_end < k)
        return jnp.sum(jnp.where(sel, vols, 0.0)) / kk.astype(jnp.float32)

    vol_ma_s = tail_mean(5)    # :1827 (denominator max(1, min(5, len)))
    vol_ma_l = tail_mean(20)

    guard = G.push_minute_bar(
        carry.guard, guard_params, ts_ms=ts0_ms, high=h, low=l, close=c, volume=v
    )

    accumulating = guard.regime == G.REGIME_ACCUMULATION
    tm_registered = T.register_touch_bar(
        carry.touchmem, touch_params, levels,
        ts_ms=ts0_ms, high=h, low=l, close=c,
        box_low=guard.box_low, box_high=guard.box_high, box_valid=guard.box_valid,
        vol_ma_s=vol_ma_s, vol_ma_l=vol_ma_l,
    )
    touchmem = tree_select(accumulating, tm_registered, carry.touchmem)
    breakout = jnp.logical_or(
        guard.regime == G.REGIME_BREAKOUT_UP, guard.regime == G.REGIME_BREAKOUT_DOWN
    )
    touchmem = tree_select(breakout, touchmem.reset_box(), touchmem)
    return carry.replace(bars=bars, guard=guard, touchmem=touchmem)


def ingest_tick(
    carry: EngineCarry,
    levels: Levels,
    touch_params: T.TouchMemoryParams,
    guard_params: G.GuardParams,
    *,
    ts_ms, price, volume,
) -> tuple[EngineCarry, jnp.ndarray]:
    """``ingest_tick`` 1-minute roll-up (:1857-1883).  Returns (carry, minute_closed)."""
    ts_ms = jnp.asarray(ts_ms, jnp.int32)
    price = jnp.asarray(price, jnp.float32)
    volume = jnp.asarray(volume, jnp.float32)
    m = ts_ms // 60_000
    cur = carry.cur_bar
    rollover = jnp.logical_and(cur.active, cur.minute != m)
    fresh = jnp.logical_not(cur.active)

    closed_carry = _minute_close(
        carry, levels, touch_params, guard_params,
        ts0_ms=cur.ts0_ms, o=cur.open, h=cur.high, l=cur.low, c=cur.close, v=cur.volume,
    )
    carry = tree_select(rollover, closed_carry, carry)

    start_new = jnp.logical_or(rollover, fresh)
    new_bar = CurrentBar(
        minute=m, ts0_ms=ts_ms - (ts_ms % 60_000),
        open=price, high=price, low=price, close=price, volume=volume,
        active=jnp.asarray(True),
    )
    updated = cur.replace(
        close=price,
        high=jnp.maximum(cur.high, price),
        low=jnp.minimum(cur.low, price),
        volume=cur.volume + volume,
    )
    cur_bar = tree_select(start_new, new_bar, updated)
    return carry.replace(cur_bar=cur_bar), rollover


def tick_step(
    carry: EngineCarry,
    levels: Levels,
    params: EngineParams,
    tick: TickInput,
    *,
    volume=0.0,
    policy: OP.PolicyParams | None = None,
    ml_model: MlModel | None = None,
    touch_params: T.TouchMemoryParams | None = None,
    guard_params: G.GuardParams | None = None,
    minutes_since_open=0,
    policy_gate_disabled=False,
    use_exit_head=False,
    exit_head_threshold=0.60,
    compat: CompatFlags = CompatFlags(),
) -> tuple[EngineCarry, TickEvent]:
    """One engine-loop iteration (§3.2).  ``tick.now_ms`` doubles as the bar
    timestamp for ingest (live host passes the trade-print ts separately if it
    differs — the reference uses t_ms for bars and wall-clock for gates).

    ``use_exit_head`` (opt-in, off by default): the reference trains a
    two-head exit policy it never consults in the live loop (``score_exit``
    has no caller, qmmx_monolithic.py:366); behind this flag a strong
    exit_now signal (P >= ``exit_head_threshold``) vetoes target escalation
    so the trade banks the target instead of rolling it."""
    if touch_params is None:
        touch_params = T.TouchMemoryParams.default()
    if guard_params is None:
        guard_params = G.GuardParams.default()
    if ml_model is None:
        ml_model = MlModel.absent()
    if policy is None:
        policy = OP.PolicyParams.init()

    # 1) bar roll-up (:2930-2933)
    carry, minute_closed = ingest_tick(
        carry, levels, touch_params, guard_params,
        ts_ms=tick.now_ms, price=tick.price, volume=volume,
    )

    # 2) entry evaluation BEFORE state update (:2936-2949); twice under Q2
    decision, carry = evaluate_entry(carry, levels, params, tick, ml_model, touch_params)
    if compat.double_evaluate:
        decision, carry = evaluate_entry(carry, levels, params, tick, ml_model, touch_params)

    # 3) state update for the next tick (:2952-2955)
    prev_price = carry.last_price
    prev_valid = carry.last_price_valid
    moved = jnp.logical_and(prev_valid, tick.price != prev_price)
    carry = carry.replace(
        last_ts_ms=tick.now_ms,
        last_ts_valid=jnp.asarray(True),
        last_price=tick.price,
        last_price_valid=tick.price_valid,
        last_direction=jnp.where(
            moved,
            jnp.where(tick.price > prev_price, DIR_UP, DIR_DOWN),
            carry.last_direction,
        ).astype(jnp.int32),
    )

    # 4) position management (:2966-3014)
    pos = carry.position
    is_long = pos.side == SIDE_LONG
    open_now = pos.is_open
    stop_hit = jnp.logical_and(
        open_now,
        jnp.where(is_long, tick.price <= pos.stop, tick.price >= pos.stop),
    )
    target_hit = jnp.logical_and(
        open_now,
        jnp.logical_and(
            jnp.logical_not(stop_hit),
            jnp.where(is_long, tick.price >= pos.target, tick.price <= pos.target),
        ),
    )

    # escalation at target (:1950-2012): only when |price-target| <= CONTACT_PROX
    bar_close, bar_vol, bar_valid = carry.bars.ordered()
    esc = exits.should_escalate_on_target(
        side=pos.side, entry=pos.entry, current_price=tick.price, levels=levels,
        bar_prices=bar_close, bar_volumes=bar_vol, bar_valid=bar_valid,
    )
    near_target = jnp.abs(tick.price - pos.target) <= params.contact_prox
    do_escalate = jnp.logical_and(
        target_hit,
        jnp.logical_and(near_target, esc.escalate),
    )
    # exit-head gating (opt-in): a confident exit_now score vetoes the
    # escalation — the trade closes at target instead of rolling it.
    # volume_trend comes from the same source the host persists into exit
    # policy_events (host/app.py: volume_trend_toward_level over the bar ring
    # at the level reconstructed from the stop) so the retrained exit head
    # sees the features it was trained on.
    lvl_exit = jnp.where(
        is_long, pos.stop + params.stop_padding, pos.stop - params.stop_padding
    )
    vt_exit, vt_exit_def = F.volume_trend_toward_level(
        bar_close, bar_vol, bar_valid, lvl_exit
    )
    x_exit = F.policy_features(
        proximity_abs=jnp.abs(tick.price - pos.target),
        volume_trend=jnp.where(vt_exit_def, vt_exit, 0.0),
        approach=jnp.where(is_long, 1, 0),
        confluence=F.confluence_count(levels, pos.target, 0.6) > 1,
        minutes_since_open=minutes_since_open,
    )
    exit_scores = OP.score_exit(policy, x_exit)
    head_says_exit = exit_scores[OP.A_EXIT_NOW] >= jnp.asarray(
        exit_head_threshold, jnp.float32)
    do_escalate = jnp.logical_and(
        do_escalate,
        jnp.logical_not(
            jnp.logical_and(jnp.asarray(use_exit_head), head_says_exit)
        ),
    )
    if compat.escalation_broken:
        do_escalate = jnp.asarray(False)

    close_on_target = jnp.logical_and(target_hit, jnp.logical_not(do_escalate))
    closed = jnp.logical_or(stop_hit, close_on_target)
    close_reason = jnp.where(
        stop_hit, CLOSE_STOP, jnp.where(close_on_target, CLOSE_TARGET, CLOSE_NONE)
    ).astype(jnp.int32)
    # reference closes at the CURRENT price, not the stop/target level (:2979/:2990)
    exit_price = tick.price
    pnl = jnp.where(
        closed,
        jnp.where(is_long, exit_price - pos.entry, pos.entry - exit_price),
        0.0,
    )
    # R normalizes by the risk AT OPEN (escalation trails the stop toward the
    # entry, which would otherwise divide by ~0); risk0==0 → legacy fallback
    risk = jnp.where(pos.risk0 > 0, pos.risk0, jnp.abs(pos.entry - pos.stop))
    risk = jnp.maximum(risk, 1e-9)
    r_delta = jnp.where(closed, pnl / risk, 0.0)

    position = tree_select(closed, Position.flat(), pos)
    position = tree_select(
        do_escalate,
        position.replace(stop=esc.trail_stop, target=esc.next_target),
        position,
    )
    cooldown_until = jnp.where(
        closed,
        tick.now_ms + (params.cooldown_s * 1000.0).astype(jnp.int32),
        carry.cooldown_until_ms,
    )

    # 5) entry open path (:3046-3112) — only when flat this tick AND decision ok.
    # The reference `continue`s after any close, so a close and an open never
    # happen on the same tick.
    can_open = jnp.logical_and(jnp.logical_not(open_now), decision.ok)
    side_is_long = decision.side == SIDE_LONG
    x = F.policy_features(
        proximity_abs=jnp.abs(tick.price - decision.level_price),
        volume_trend=0.0,  # live loop hardcodes 0.0 (:3072, quirk Q6 adjacent)
        approach=jnp.where(side_is_long, 1, 0),  # from_below if long (:3053)
        confluence=F.confluence_count(levels, decision.level_price, 0.6) > 1,
        minutes_since_open=minutes_since_open,
    )
    scores = OP.score_entry(policy, x)
    policy_pass = jnp.logical_or(
        jnp.asarray(policy_gate_disabled),
        OP.entry_gate(policy, x, side_is_long),
    )
    opened = jnp.logical_and(can_open, policy_pass)
    position = tree_select(
        opened,
        Position(
            side=decision.side,
            entry=tick.price,
            stop=decision.stop,
            target=decision.target,
            open_ts_ms=tick.now_ms,
            risk0=jnp.abs(tick.price - decision.stop),
        ),
        position,
    )

    equity = carry.equity_r + r_delta
    peak = jnp.maximum(carry.peak_r, equity)
    carry = carry.replace(
        position=position,
        cooldown_until_ms=cooldown_until,
        realized_pnl=carry.realized_pnl + pnl,
        equity_r=equity,
        peak_r=peak,
        max_dd_r=jnp.minimum(carry.max_dd_r, equity - peak),
        wins=carry.wins + jnp.logical_and(closed, pnl > 0).astype(jnp.int32),
        losses=carry.losses + jnp.logical_and(closed, pnl <= 0).astype(jnp.int32),
    )

    event = TickEvent(
        decision=decision,
        opened=opened,
        closed=closed,
        close_reason=close_reason,
        exit_price=exit_price,
        pnl=pnl,
        escalated=do_escalate,
        new_stop=esc.trail_stop,
        new_target=esc.next_target,
        policy_pass=policy_pass,
        policy_scores=scores,
        exit_scores=exit_scores,
        minute_closed=minute_closed,
    )
    return carry, event


def run_ticks(
    carry: EngineCarry,
    levels: Levels,
    params: EngineParams,
    ts_ms: jnp.ndarray,
    prices: jnp.ndarray,
    volumes: jnp.ndarray | None = None,
    *,
    policy: OP.PolicyParams | None = None,
    ml_model: MlModel | None = None,
    minutes_since_open: jnp.ndarray | None = None,
    policy_gate_disabled=False,
    use_exit_head=False,
    exit_head_threshold=0.60,
    compat: CompatFlags = CompatFlags(),
) -> tuple[EngineCarry, TickEvent]:
    """Scan ``tick_step`` over a tick tape (deterministic live replay)."""
    n = prices.shape[0]
    if volumes is None:
        volumes = jnp.zeros((n,), jnp.float32)
    if minutes_since_open is None:
        minutes_since_open = jnp.zeros((n,), jnp.int32)
    if policy is None:
        policy = OP.PolicyParams.init()
    if ml_model is None:
        ml_model = MlModel.absent()

    def step(c, inp):
        ts, px, vol, mins = inp
        tick = TickInput(
            price=px,
            price_valid=jnp.asarray(True),
            prev_price=c.last_price,
            prev_price_valid=c.last_price_valid,
            now_ms=ts,
            api_key_present=jnp.asarray(True),
        )
        return tick_step(
            c, levels, params, tick,
            volume=vol, policy=policy, ml_model=ml_model,
            minutes_since_open=mins,
            policy_gate_disabled=policy_gate_disabled,
            use_exit_head=use_exit_head,
            exit_head_threshold=exit_head_threshold,
            compat=compat,
        )

    return jax.lax.scan(
        step, carry,
        (jnp.asarray(ts_ms, jnp.int32), jnp.asarray(prices, jnp.float32),
         jnp.asarray(volumes, jnp.float32), jnp.asarray(minutes_since_open, jnp.int32)),
    )
