"""The FULL 12-gate QMMX engine over generated paths: every gate, at scale.

``sim/gatedpath.py`` runs a 5-gate subset (cooldown / direction / TOO_FAR /
touch latch+budget / confidence).  This module runs the reference's complete
``evaluate_entry`` ladder (qmmx_monolithic.py:1492-1771) plus the app-level
OnlinePolicy gate (:3076-3093) and target escalation (:1950-2012) over every
generated path, vectorized [P]-wide inside one ``lax.scan`` over bars:

  per bar t (close = the bar's decision tick, ts = t*60_000):
    B. position management on the bar's high/low (same-bar ties by the
       distance-weighted coin, :3467-3480); on a target touch,
       ``ExitStrategy.should_escalate_on_target`` (:897-960) may roll the
       target to the next level and trail the stop instead of closing.
    C. entry evaluation at the close against state from bars <= t-1 (the
       live loop's view: bar t is still forming while its ticks gate):
         2 IN_POSITION   3 COOLDOWN (ms)      4 NOLEVELS
         5 DIR_UNKNOWN (eps + last-direction reuse, :1529-1540)
         6 TOO_FAR       7 contact latch + LEVEL_OVERTOUCHED (:1557-1587)
         7b EDGE_FATIGUE / bounce budget / per-level cooldown / decay
            while the guard regime is accumulation (:1589-1621)
         8 CONF_LOW (confidence x decay, :1626-1641)
         9 scaffold      9b ACC_BREAKOUT_GATE (:1652-1666)
         10 soft volume veto (:1773-1794)   11 ML / blend gate (:1707-1756)
         12 OnlinePolicy two-head gate (:3076-3093)
       (gates 0/1 — API key, staleness — are host concerns, always passing
       on generated bars.)
    D. minute-close pipeline for bar t (:1813-1855): push (close, volume)
       into the bar ring, update the accumulation guard, register touch-
       memory taps while accumulating, reset the touch box on breakout.

  The B→C→D order equals the live loop's tick order: a close never re-enters
  the same bar (:2966-3014 ``continue``), and decisions during bar t see
  minute-closed state up to bar t-1 only.

Guard and touch memory run through ``ops/regular.py`` — bar-synchronous
re-expressions exactness-tested against ops/guard.py / ops/touch.py — so the
gate math here is literally the same functions the tick engine uses
(ops.confidence, ops.features, engine.gates._ml_allowed, models.online_policy,
engine.exits).  A scalar Python oracle (tests/oracle/engine.py::EngineOracle)
replays the whole ladder per path — including wicked OHLC bars with the
distance-weighted tie coin — and a flat-wick tape maps this pipeline 1:1 onto
``engine.lifecycle.run_ticks`` for an end-to-end cross-check.

Volume comes from the sampler (real bars under bootstrap, a synthetic
intraday model under GBM/Heston — ops/pathgen.py), which is what lets the
guard / veto / planner-feature gates run at the 1e9-path surface at all.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import EngineParams
from ..engine import exits
from ..engine.gates import _ml_allowed
from ..engine.state import MlModel
from ..models import harvest as HV
from ..models import online_policy as OP
from ..ops import confidence as C
from ..ops import features as F
from ..ops import guard as G
from ..ops import pathgen as PG
from ..ops import regular as R
from ..ops import touch as T
from ..reasons import Reason
from ..types import (
    DIR_DOWN,
    DIR_UNKNOWN,
    DIR_UP,
    KIND_SOLID,
    SIDE_FLAT,
    SIDE_LONG,
    SIDE_SHORT,
    Levels,
)
from ..utils import prng
from . import pathsim
from .hits import bar_hit_outcome
from .pathsim import PathStats

BAR_MS = 60_000
BARS_RING = 32   # volume windows used by the gates are <= 20 bars

# first-fail skip accounting buckets (audit-parity diagnostics at scale)
SKIP_REASONS = (
    Reason.IN_POSITION, Reason.COOLDOWN, Reason.NOLEVELS, Reason.DIR_UNKNOWN,
    Reason.TOO_FAR, Reason.LEVEL_OVERTOUCHED, Reason.EDGE_FATIGUE,
    Reason.TOUCH_BUDGET, Reason.TOUCH_COOLDOWN, Reason.CONF_LOW,
    Reason.ACC_BREAKOUT_GATE, Reason.CONTRA_VOL_LONG, Reason.CONTRA_VOL_SHORT,
    Reason.COMBINED_LOW, Reason.ML_CONF_LOW, Reason.ONLINE_POLICY,
)


def _check_state_envelope(touch_params, guard_params) -> None:
    """Reject params the windowed XLA state forms would SILENTLY mishandle.

    The round-4 diet replaced unbounded rank-cumsum / 64-slot-ring forms with
    windowed ones: ``edge_fatigued``'s 8-deep tap stack never fatigues for
    ``fatigue_hits > TAP_STACK`` (the kth-newest-slot test goes vacuously
    false), and ``lean_guard_push`` zero-pads volume slots past the shared
    ``BARS_RING``(=32)-bar ring, under-summing ``vol_short``/``vol_long``
    windows wider than the ring.  Both would diverge from the reference
    (qmmx_monolithic.py:1199-1220, :1250) without erroring, so check once at
    launch, host-side.  Skipped when the params are tracers (a jitted caller
    validated concrete values before tracing — mc_paths_engine's wrapper)."""
    try:
        fh = int(touch_params.fatigue_hits)
        vs = int(guard_params.vol_short)
        vl = int(guard_params.vol_long)
    except TypeError:  # traced — concrete validation already ran (or n/a)
        return
    if fh > R.TAP_STACK:
        raise ValueError(
            f"fatigue_hits={fh} exceeds the XLA tap stack depth "
            f"({R.TAP_STACK}): edge fatigue would silently never fire. "
            "Raise ops.regular.TAP_STACK or use the trial-scale engine.")
    if vs > BARS_RING or vl > BARS_RING:
        raise ValueError(
            f"guard vol windows ({vs}/{vl}) exceed the shared "
            f"{BARS_RING}-bar volume ring: the MAs would silently "
            "under-sum. Raise sim.enginepath.BARS_RING.")


@struct.dataclass
class EngineLifecycleOutcome:
    """Per-path results of the full-engine lifecycle ([P] each) plus
    aggregate first-fail skip counts over all (path, bar) evaluations."""

    equity: jnp.ndarray       # f32 total R over closed trades
    trades: jnp.ndarray       # i32 entries taken
    wins: jnp.ndarray         # i32 closes with pnl > 0
    losses: jnp.ndarray       # i32 closes with pnl <= 0
    open_at_end: jnp.ndarray  # bool
    max_dd: jnp.ndarray       # f32 peak-tracked max drawdown in R (>= 0)
    escalations: jnp.ndarray  # i32 target rolls taken
    skip_counts: jnp.ndarray  # f32[len(SKIP_REASONS)] first-fail totals
    harvest: HV.EngineHarvest | None = None  # closed-trade label statistics
                              # (models/harvest.py), None unless harvest=True


def engine_path_replay(
    paths: PG.PathBars,
    levels: Levels,
    params: EngineParams,
    tie_uniform,                 # f32[P, W]
    *,
    policy: OP.PolicyParams | None = None,
    ml_model: MlModel | None = None,
    touch_params: T.TouchMemoryParams | None = None,
    guard_params: G.GuardParams | None = None,
    policy_gate_disabled: bool | None = None,
    escalation: bool = True,     # static: include target escalation (:1950-2012)
    bar0_minute=0,               # minutes-since-open of bar 0 (policy features)
    noise=None,                  # montecarlo.McNoise
    noise_normals=None,          # f32[4, P, W]
    exit_at_close: bool = False,  # static: live-loop exit pricing (oracle tests)
    harvest: bool = False,       # static: collect closed-trade label stats
    return_curve: bool = False,  # static: also return the [W, P] equity curve
) -> EngineLifecycleOutcome:
    """Run the complete engine over every path.

    ``policy=None`` disables the OnlinePolicy gate by default (an untrained
    zero policy scores 0.5 < 0.60 and would veto every entry — the reference
    ships DISABLE_POLICY_GATE for exactly this); pass a trained policy to arm
    the gate, or force the flag explicitly.

    ``harvest=True`` additionally accumulates the learning flywheel's
    sufficient statistics (models/harvest.py): every CLOSED trade contributes
    one example labeled ``pnl > 0`` (:1934-1945) with its ENTRY-time ML-gate
    and policy features, returned as ``outcome.harvest``.

    ``return_curve=True`` additionally returns the post-bar equity curve
    ``f32[W, P]`` (equity after bar t's position management, the same point
    sim/gatedpath samples) — the portfolio pipeline sums weighted per-symbol
    curves to track TRUE book drawdown over time
    (parallel/portfolio.portfolio_mc_engine)."""
    if touch_params is None:
        touch_params = T.TouchMemoryParams.default()
    if guard_params is None:
        guard_params = G.GuardParams.default()
    _check_state_envelope(touch_params, guard_params)
    if ml_model is None:
        ml_model = MlModel.absent()
    if policy_gate_disabled is None:
        policy_gate_disabled = policy is None
    if policy is None:
        policy = OP.PolicyParams.init()

    close = jnp.asarray(paths.close, jnp.float32)
    p, w = close.shape
    n_lvl = levels.max_levels
    lvl_iota = jnp.arange(n_lvl, dtype=jnp.int32)
    lvl_price_f = jnp.where(levels.valid, levels.price, 0.0)
    has_levels = levels.count > 0
    cooldown_ms = (jnp.asarray(params.cooldown_s, jnp.float32) * 1000.0).astype(jnp.int32)
    bar0_minute = jnp.asarray(bar0_minute, jnp.int32)

    def step(carry, inp, esc_on=True):
        (side, entry, stop, target, risk0, cooldown_until, last_dir, prev_c,
         c_counts, c_latch, guard, touch, ring_c, ring_v,
         equity, peak, dd, trades, wins, losses, escal, hstate) = carry
        if harvest:
            hv, pend_ml, pend_pol, pend_x1, pend_x6 = hstate
        if noise is not None:
            h, l, c, v, tie, t, nj, ne, ns, nt = inp
        else:
            h, l, c, v, tie, t = inp
        now_ms = t * BAR_MS
        # bars <= t-1 held by the rings (newest-first); valid slot mask
        n_bars = jnp.minimum(t, BARS_RING)
        ring_valid = (jnp.arange(BARS_RING)[None, :] < n_bars)
        # oldest→newest views for the window featurizers
        bars_c_on = ring_c[:, ::-1]
        bars_v_on = ring_v[:, ::-1]
        bars_valid_on = jnp.broadcast_to(ring_valid[:, ::-1], ring_c.shape)

        # ---- B) position management (:2966-3014) ----
        is_open = side != SIDE_FLAT
        is_long = side == SIDE_LONG
        bh = bar_hit_outcome(
            is_open=is_open, is_long=is_long, entry=entry, stop=stop,
            target=target, high=h, low=l, tie=tie)          # (:3467-3480)
        target_first = bh.target_first
        hit = bh.hit

        if escalation and esc_on:
            # the live loop evaluates at the detecting tick's price and only
            # escalates within CONTACT_PROX of the target (:1950-2012 via
            # :2988); the bar's close is that observable price here.
            # esc_on is STATICALLY False for the peeled bars t < VOL_LOOKBACK
            # (trend_defined needs 5 held bars -> can_decide false -> the
            # whole walk is provably dead there; round-5 XLA ladder diet).
            # Post-peel the walk only reads the VOL_LOOKBACK newest bars, all
            # guaranteed valid — a STATIC ring slice drops its [P, RING]
            # cumsum/mask reductions to [P, VOL_LOOKBACK] (bitwise-equal:
            # every f32 sum in the trend has <=2 nonzero terms; diet round 3)
            esc = exits.should_escalate_on_target(
                side=side, entry=entry, current_price=c, levels=levels,
                bar_prices=ring_c[:, exits.VOL_LOOKBACK - 1::-1],
                bar_volumes=ring_v[:, exits.VOL_LOOKBACK - 1::-1],
                bar_valid=None, full_window=True,
            )
            near_target = jnp.abs(c - target) <= params.contact_prox
            escalate = jnp.logical_and(
                jnp.logical_and(jnp.logical_and(hit, target_first), near_target),
                esc.escalate)
        else:
            escalate = jnp.zeros((p,), bool)

        closed = jnp.logical_and(hit, jnp.logical_not(escalate))
        # scaled surfaces close at the barrier (the MC's R convention,
        # :3481-3486); exit_at_close mirrors the live loop's exit at the
        # detecting tick's price (:2979/:2990) for tick_step equivalence
        if exit_at_close:
            exit_px = c
        else:
            exit_px = jnp.where(target_first, target, stop)
        pnl = jnp.where(closed,
                        jnp.where(is_long, exit_px - entry, entry - exit_px),
                        0.0)
        if harvest:
            # label on close by pnl sign (:1934-1945), entry-time features
            hv = HV.harvest_closed(
                hv, closed=closed, label_pos=pnl > 0, pend_ml=pend_ml,
                pend_pol=pend_pol, pend_x1=pend_x1, pend_x6=pend_x6)
        # normalize R by the risk AT OPEN (escalation trails the stop toward
        # the entry; dividing by the trailed distance explodes R)
        risk = jnp.maximum(risk0, 1e-9)
        r = jnp.where(closed, pnl / risk, 0.0)
        equity = equity + r
        peak = jnp.maximum(peak, equity)
        dd = jnp.maximum(dd, peak - equity)
        wins = wins + jnp.logical_and(closed, pnl > 0).astype(jnp.int32)
        losses = losses + jnp.logical_and(closed, pnl <= 0).astype(jnp.int32)
        if escalation and esc_on:
            stop = jnp.where(escalate, esc.trail_stop, stop)
            target = jnp.where(escalate, esc.next_target, target)
            escal = escal + escalate.astype(jnp.int32)
        side = jnp.where(closed, SIDE_FLAT, side)
        cooldown_until = jnp.where(closed, now_ms + cooldown_ms, cooldown_until)

        # ---- C) entry evaluation at the close (:1492-1771 + :3046-3112) ----
        was_flat = jnp.logical_not(is_open)

        reason = jnp.full((p,), Reason.OK, jnp.int32)

        def first_fail(reason, fail, code):
            return jnp.where(
                jnp.logical_and(reason == Reason.OK, fail), jnp.int32(code), reason)

        # 2) IN_POSITION (position before this tick's management, :1508 —
        # equivalent here: a bar that closes can never re-enter)
        reason = first_fail(reason, jnp.logical_not(was_flat), Reason.IN_POSITION)
        # 3) COOLDOWN (:1516) — ms semantics, cooldown armed by earlier closes
        reason = first_fail(reason, now_ms < cooldown_until, Reason.COOLDOWN)
        # 4) NOLEVELS (:1524)
        reason = first_fail(reason, jnp.logical_not(has_levels), Reason.NOLEVELS)
        # 5) direction (:1529-1540): eps band, flat tick reuses last direction
        eps = jnp.float32(1e-9)
        up = c > prev_c + eps
        down = c < prev_c - eps
        direction = jnp.where(
            t > 0,
            jnp.where(up, DIR_UP, jnp.where(down, DIR_DOWN, last_dir)),
            DIR_UNKNOWN,
        ).astype(jnp.int32)
        reason = first_fail(reason, direction == DIR_UNKNOWN, Reason.DIR_UNKNOWN)
        # 6) nearest level / TOO_FAR (:1543-1555) — winner's price/kind ride
        # the running-min select in place of a [P]-indexed table gather
        # (ops/features.nearest_level_full)
        idx, dist, lvlp, lvlk = F.nearest_level_full(levels, c)
        reason = first_fail(reason, dist > params.contact_prox, Reason.TOO_FAR)

        # 7) contact latch + LEVEL_OVERTOUCHED (:1557-1587); the latch mutates
        # exactly when gates 0-6 passed
        reached7 = reason == Reason.OK
        dist_all = jnp.abs(lvl_price_f[None, :] - c[:, None])
        dist_all = jnp.where(levels.valid[None, :], dist_all, jnp.inf)
        is_nearest = lvl_iota[None, :] == idx[:, None]
        inside = dist_all <= params.contact_prox
        fresh = jnp.logical_and(
            is_nearest, jnp.logical_and(inside, jnp.logical_not(c_latch)))
        counts_new = c_counts + fresh.astype(jnp.int32)
        latch_new = jnp.where(
            is_nearest, inside, jnp.logical_and(c_latch, inside))
        latch_new = jnp.logical_and(latch_new, levels.valid[None, :])
        c_counts = jnp.where(reached7[:, None], counts_new, c_counts)
        c_latch = jnp.where(reached7[:, None], latch_new, c_latch)
        # one-hot select in place of take_along_axis (i32 masked sum == the
        # gathered element); whether a gather is cheaper on a GPU is unmeasured
        tc = jnp.sum(jnp.where(is_nearest, c_counts, 0), axis=1)
        reason = first_fail(reason, tc >= params.overtouch_limit,
                            Reason.LEVEL_OVERTOUCHED)

        # 7b) accumulation gates (:1589-1621)
        accumulating = guard.regime == G.REGIME_ACCUMULATION
        fatigued_edge = R.edge_fatigued(touch, touch_params, now_ms)
        edge_for_this = jnp.where(direction == DIR_DOWN, T.EDGE_TOP, T.EDGE_BOT)
        reason = first_fail(
            reason,
            jnp.logical_and(accumulating, fatigued_edge == edge_for_this),
            Reason.EDGE_FATIGUE)
        tm_side = jnp.where(direction == DIR_DOWN, T.TM_SHORT, T.TM_LONG)
        tm_ok, tm_budget, tm_mult = R.touch_allow(
            touch, touch_params, idx, tm_side, now_ms)
        tm_fail = jnp.logical_and(accumulating, jnp.logical_not(tm_ok))
        reason = first_fail(reason, jnp.logical_and(tm_fail, tm_budget),
                            Reason.TOUCH_BUDGET)
        reason = first_fail(
            reason, jnp.logical_and(tm_fail, jnp.logical_not(tm_budget)),
            Reason.TOUCH_COOLDOWN)
        decay_mult = jnp.where(jnp.logical_and(accumulating, tm_ok), tm_mult, 1.0)

        # 8) confidence (:1626-1641)
        conf = C.compute_confidence(
            level_price=lvlp, level_kind=lvlk, price=c, direction=direction,
            touch_count=tc, contact_prox=params.contact_prox,
        ) * decay_mult
        reason = first_fail(reason, conf < params.q_min_prob, Reason.CONF_LOW)

        # 9) side + clean scaffold (:1643-1675) — gates see the UN-noised
        # barriers (the reference jitters inside walk_outcome, after gating)
        new_side = jnp.where(direction == DIR_UP, SIDE_LONG, SIDE_SHORT).astype(jnp.int32)
        go_long = new_side == SIDE_LONG
        stop_clean = jnp.where(go_long, lvlp - params.stop_padding,
                               lvlp + params.stop_padding)
        # 9b) breakout counter-trend gate (:1652-1666)
        reason = first_fail(
            reason,
            jnp.logical_not(R.guard_allow_trade(guard.regime, new_side)),
            Reason.ACC_BREAKOUT_GATE)

        # 10) soft volume veto (:1677-1705 → :1773-1794)
        vslope = F.volume_slope(bars_v_on, bars_valid_on, window=6)
        confl_veto = F.has_confluence_near(levels, lvlp, params.confluence_within)
        veto_ok, veto_reason = C.soft_veto(
            side=new_side, volume_slope=vslope,
            approach_from_below=direction == DIR_UP, confluence=confl_veto,
            proximity_abs=dist, contact_prox=params.contact_prox,
            veto_vol_strong=params.veto_vol_strong, veto_prox=params.veto_prox,
        )
        veto_fail = jnp.logical_and(params.enable_veto, jnp.logical_not(veto_ok))
        reason = jnp.where(
            jnp.logical_and(reason == Reason.OK, veto_fail), veto_reason, reason)

        # 11) ML / blended gate (:1707-1756)
        s_w = params.w_rules + params.w_ml
        w_rules = jnp.where(s_w <= 0, 1.0, params.w_rules / jnp.where(s_w <= 0, 1.0, s_w))
        w_ml = jnp.where(s_w <= 0, 0.0, params.w_ml / jnp.where(s_w <= 0, 1.0, s_w))
        ok_ml, ml_proba, ml_usable = _ml_allowed(
            ml_model, params, level_solid=lvlk == KIND_SOLID, level_price=lvlp,
            stop=stop_clean, touch_count=tc, direction=direction,
        )
        ran_ml = jnp.logical_not(params.disable_ml_gate)
        mlp = jnp.where(jnp.logical_and(ran_ml, ml_usable), ml_proba, conf)
        blended = w_rules * conf + w_ml * mlp
        reason = first_fail(
            reason,
            jnp.logical_and(params.use_blend, blended < params.q_min_prob),
            Reason.COMBINED_LOW)
        reason = first_fail(
            reason,
            jnp.logical_and(
                jnp.logical_not(params.use_blend),
                jnp.logical_and(ran_ml, jnp.logical_not(ok_ml))),
            Reason.ML_CONF_LOW)

        # 12) OnlinePolicy gate (:3046-3112)
        x = F.policy_features(
            proximity_abs=dist,
            volume_trend=jnp.zeros_like(dist),  # live loop hardcodes 0.0 (:3072, Q6)
            approach=jnp.where(go_long, 1, 0),
            confluence=F.confluence_count(levels, lvlp, 0.6) > 1,
            minutes_since_open=jnp.broadcast_to(bar0_minute + t, dist.shape),
        )
        policy_pass = jnp.logical_or(
            jnp.asarray(policy_gate_disabled), OP.entry_gate(policy, x, go_long))
        reason = first_fail(reason, jnp.logical_not(policy_pass),
                            Reason.ONLINE_POLICY)

        enter = reason == Reason.OK
        # skip accounting happens OUTSIDE the scan: the per-bar reason codes
        # ride the scan outputs and one fused [W, P]-vs-codes histogram
        # replaces 16 sequential [P] reductions in the loop body.
        # Bitwise-free: per-block counts are integers < 2^24, so any f32
        # reduction association yields the same totals as the old per-bar
        # running adds; the cross-block merge order is unchanged.

        # open the trade (noised execution scaffold, :3453-3461)
        if noise is not None:
            lvl_eff = lvlp + nj * noise.level_jitter_std
            fill = c + ne * noise.entry_slip_std
        else:
            lvl_eff, fill = lvlp, c
        stop_new = jnp.where(go_long, lvl_eff - params.stop_padding,
                             lvl_eff + params.stop_padding)
        tgt_new = jnp.where(go_long, lvl_eff + params.tp_padding,
                            lvl_eff - params.tp_padding)
        if noise is not None:
            stop_new = stop_new + ns * noise.stop_slip_std
            tgt_new = tgt_new + nt * noise.target_slip_std
        side = jnp.where(enter, new_side, side)
        entry = jnp.where(enter, fill, entry)
        stop = jnp.where(enter, stop_new, stop)
        target = jnp.where(enter, tgt_new, target)
        risk0 = jnp.where(enter, jnp.abs(fill - stop_new), risk0)
        trades = trades + enter.astype(jnp.int32)
        if harvest:
            # latch the entry-time features until this trade closes
            pend_ml = jnp.where(
                enter, HV.ml_bucket(tc, lvlk == KIND_SOLID, go_long), pend_ml)
            pend_pol = jnp.where(
                enter, HV.pol_bucket(go_long, x[..., 5] > 0.5), pend_pol)
            pend_x1 = jnp.where(enter, x[..., 1], pend_x1)
            pend_x6 = jnp.where(enter, x[..., 6], pend_x6)

        # direction state update (:2952-2955): exact != (no eps)
        moved = jnp.logical_and(t > 0, c != prev_c)
        last_dir = jnp.where(
            moved, jnp.where(c > prev_c, DIR_UP, DIR_DOWN), last_dir
        ).astype(jnp.int32)

        # ---- D) minute close of bar t (:1813-1855) ----
        ring_c = R.ring_push(ring_c, c)
        ring_v = R.ring_push(ring_v, v)
        # minute-close volume MAs (denominator max(1, min(k, len)), :1827)
        n_after = t + 1
        vol_ma_s = R.tail_mean_minclose(ring_v, n_after, 5)
        vol_ma_l = R.tail_mean_minclose(ring_v, n_after, 20)
        guard = R.lean_guard_push(guard, guard_params, bar_index=t,
                                  high=h, low=l, close=c, vol_ring=ring_v)
        acc_now = guard.regime == G.REGIME_ACCUMULATION
        touch = R.touch_register(
            touch, touch_params, levels, ts_ms=now_ms,
            high=h, low=l, close=c,
            box_low=guard.box_low, box_high=guard.box_high,
            box_valid=guard.box_valid,
            vol_ma_s=vol_ma_s, vol_ma_l=vol_ma_l, enabled=acc_now,
        )
        breakout = jnp.logical_or(guard.regime == G.REGIME_BREAKOUT_UP,
                                  guard.regime == G.REGIME_BREAKOUT_DOWN)
        touch = touch.reset_box(breakout)

        hstate = ((hv, pend_ml, pend_pol, pend_x1, pend_x6) if harvest
                  else hstate)
        carry = (side, entry, stop, target, risk0, cooldown_until, last_dir, c,
                 c_counts, c_latch, guard, touch, ring_c, ring_v,
                 equity, peak, dd, trades, wins, losses, escal, hstate)
        return carry, ((reason, equity) if return_curve else reason)

    zf = jnp.zeros((p,), jnp.float32)
    zi = jnp.zeros((p,), jnp.int32)
    init = (
        zi,                                    # side (flat)
        zf, zf, zf,                            # entry / stop / target
        zf,                                    # risk0 (|entry-stop| at open)
        jnp.full((p,), -(1 << 30), jnp.int32),  # cooldown_until_ms (expired)
        jnp.full((p,), DIR_UNKNOWN, jnp.int32),  # last_direction
        jnp.asarray(paths.open, jnp.float32)[:, 0],  # prev close (unused at t=0)
        jnp.zeros((p, n_lvl), jnp.int32),      # contact counts
        jnp.zeros((p, n_lvl), bool),           # contact latch
        R.LeanGuardState.zeros(p, windowed=w > R.GUARD_WINDOW_BARS),
        R.RegularTouchState.zeros(p, n_lvl),
        jnp.zeros((p, BARS_RING), jnp.float32),  # close ring (newest-first)
        jnp.zeros((p, BARS_RING), jnp.float32),  # volume ring
        zf, zf, zf,                            # equity / peak / max_dd
        zi, zi, zi, zi,                        # trades / wins / losses / escal
        ((HV.EngineHarvest.zero(), zi, zi, zf, zf) if harvest else ()),
    )
    xs = (
        jnp.asarray(paths.high, jnp.float32).T,
        jnp.asarray(paths.low, jnp.float32).T,
        close.T,
        jnp.asarray(paths.volume, jnp.float32).T,
        jnp.asarray(tie_uniform, jnp.float32).T,
        jnp.arange(w, dtype=jnp.int32),
    )
    if noise is not None:
        xs = xs + tuple(jnp.asarray(nn, jnp.float32).T for nn in noise_normals)

    n_peel = min(w, exits.VOL_LOOKBACK) if escalation else 0
    if n_peel:
        xs_a = jax.tree_util.tree_map(lambda x: x[:n_peel], xs)
        xs_b = jax.tree_util.tree_map(lambda x: x[n_peel:], xs)
        carry_mid, ys_a = jax.lax.scan(
            partial(step, esc_on=False), init, xs_a)
        carry_fin, ys_b = jax.lax.scan(step, carry_mid, xs_b)
        ys = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), ys_a, ys_b)
    else:
        carry_fin, ys = jax.lax.scan(step, init, xs)
    reasons, curve = ys if return_curve else (ys, None)
    (side, _, _, _, _, _, _, _, _, _, _, _, _, _,
     equity, _, dd, trades, wins, losses, escal,
     hstate) = carry_fin
    # the one fused skip histogram over every (bar, path) reason code (the
    # step docstrings explain why this lives outside the scan)
    codes = jnp.asarray(SKIP_REASONS, jnp.int32)
    skips = jnp.sum(
        (reasons[..., None] == codes).astype(jnp.float32), axis=(0, 1))
    out = EngineLifecycleOutcome(
        equity=equity, trades=trades, wins=wins, losses=losses,
        open_at_end=side != SIDE_FLAT, max_dd=dd, escalations=escal,
        skip_counts=skips,
        harvest=hstate[0] if harvest else None,
    )
    return (out, curve) if return_curve else out


def _one_block_engine(
    key, block_idx, *, levels, params, block_paths, num_bars, s0, mu, sigma,
    dt, sampler, hist_bars, antithetic, block_len=10, heston=None,
    policy=None, ml_model=None, touch_params=None, guard_params=None,
    policy_gate_disabled=None, escalation=True, bar0_minute=0, noise=None,
    volume_model=None, harvest=False,
) -> PathStats:
    bkey = prng.key_for(key, prng.STREAM_PATH, block_idx)
    paths = pathsim.sample_block(
        bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
        sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
        antithetic=antithetic, block_len=block_len, heston=heston,
        volume_model=volume_model,
    )
    tie = jax.random.uniform(
        prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths, num_bars),
        jnp.float32,
    )
    draws = (pathsim.noise_normals(bkey, (block_paths, num_bars))
             if noise is not None else None)
    out = engine_path_replay(
        paths, levels, params, tie,
        policy=policy, ml_model=ml_model, touch_params=touch_params,
        guard_params=guard_params, policy_gate_disabled=policy_gate_disabled,
        escalation=escalation, bar0_minute=bar0_minute,
        noise=noise, noise_normals=draws, harvest=harvest,
    )
    return PathStats.from_lifecycle(
        equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
        open_at_end=out.open_at_end, max_dd=out.max_dd,
    ), out.skip_counts, jnp.sum(out.escalations), out.harvest


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "sampler",
                     "antithetic", "block_len", "escalation", "volume_model",
                     "policy_gate_disabled", "harvest"),
)
def _mc_paths_engine_jit(
    key,
    levels: Levels,
    params: EngineParams,
    *,
    num_paths: int,
    num_bars: int = 40,
    s0=100.0,
    mu: float = 0.0,
    sigma: float = 0.15,
    dt: float = 1.0 / (390.0 * 252.0),
    sampler: str = "gbm",
    hist_bars=None,
    block_paths: int = 1 << 13,
    antithetic: bool = False,
    block_len: int = 10,
    heston=None,
    policy=None,
    ml_model=None,
    touch_params=None,
    guard_params=None,
    policy_gate_disabled: bool | None = None,
    escalation: bool = True,
    bar0_minute=0,
    noise=None,
    volume_model=None,
    harvest: bool = False,
):
    """Streamed generated-path MC under the FULL 12-gate engine.

    Returns (stats, skip_counts, escalations): the lifecycle PathStats plus
    the aggregated first-fail gate-skip histogram (ordered as SKIP_REASONS —
    the log-analyzer's skip table at path scale) and the total escalation
    count.  With ``harvest=True`` returns a 4-tuple ending in the merged
    ``EngineHarvest`` (closed-trade label statistics, models/harvest.py).
    Default block is 8k paths: the guard/touch state is ~8 KB/path, so blocks
    stream through HBM like the other pipelines."""
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    n_blocks = num_paths // block_paths

    def body(carry, b):
        stats, skips, escal, hv = carry
        st, sk, es, bh = _one_block_engine(
            key, b, levels=levels, params=params, block_paths=block_paths,
            num_bars=num_bars, s0=s0, mu=mu, sigma=sigma, dt=dt,
            sampler=sampler, hist_bars=hist_bars, antithetic=antithetic,
            block_len=block_len, heston=heston, policy=policy,
            ml_model=ml_model, touch_params=touch_params,
            guard_params=guard_params,
            policy_gate_disabled=policy_gate_disabled, escalation=escalation,
            bar0_minute=bar0_minute, noise=noise, volume_model=volume_model,
            harvest=harvest,
        )
        hv = hv.merge(bh) if harvest else hv
        return (stats.merge(st), skips + sk, escal + es, hv), None

    init = (
        PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI),
        jnp.zeros((len(SKIP_REASONS),), jnp.float32),
        jnp.zeros((), jnp.int32),
        HV.EngineHarvest.zero() if harvest else jnp.zeros((), jnp.float32),
    )
    (stats, skips, escal, hv), _ = jax.lax.scan(
        body, init, jnp.arange(n_blocks, dtype=jnp.uint32))
    if harvest:
        return stats, skips, escal, hv
    return stats, skips, escal


def mc_paths_engine(key, levels, params, *, touch_params=None,
                    guard_params=None, **kw):
    """Validating entry for the jitted engine pipeline: params the windowed
    XLA state forms cannot represent are rejected HERE with a host-side check
    (inside the jit they are tracers and ``_check_state_envelope`` skips) —
    see its docstring for the failure modes.  Defaults are known-good."""
    if touch_params is not None or guard_params is not None:
        _check_state_envelope(
            touch_params if touch_params is not None
            else T.TouchMemoryParams.default(),
            guard_params if guard_params is not None
            else G.GuardParams.default())
    return _mc_paths_engine_jit(key, levels, params,
                                touch_params=touch_params,
                                guard_params=guard_params, **kw)
