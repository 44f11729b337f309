"""The 12-gate entry decision stack as a pure, branchless, jit/scan-able function.

Re-expression of ``MonolithicEngine.evaluate_entry`` (qmmx_monolithic.py:1492-1771)
with the exact gate ordering and first-triggered-reason semantics of the reference
(§3.2 of SURVEY.md):

  0  MISSING_API_KEY (:1494)          1  PRICE_STALE >15 s (:1499)
  2  IN_POSITION (:1508)              3  COOLDOWN (:1516)
  4  NOLEVELS (:1524)                 5  DIR_UNKNOWN (:1529-1540)
  6  TOO_FAR (:1543-1555)             7  touch latch + LEVEL_OVERTOUCHED (:1557-1587)
  7b EDGE_FATIGUE / bounce budget / per-level cooldown / decay mult (:1589-1621)
  8  CONF_LOW (:1626-1641)            9  side + stop/target scaffold (:1643-1675)
  9b ACC_BREAKOUT_GATE (:1652-1666)   10 soft veto (:1677-1705)
  11 ML / blended gate (:1707-1756)   12 decision OK

Branch-free: every gate computes a fail flag; the recorded reason is the first
failing gate's (reason priority == gate order, required for audit parity).  State
mutations (the touch latch, :1557-1576) apply exactly when the reference would
have executed them — i.e. when gates 0-6 passed — even if a later gate fails.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import EngineParams
from ..ops import confidence as C
from ..ops import features as F
from ..ops import guard as G
from ..ops import touch as T
from ..reasons import Reason
from ..types import (
    DIR_DOWN,
    DIR_UNKNOWN,
    DIR_UP,
    KIND_SOLID,
    SIDE_LONG,
    SIDE_SHORT,
    Levels,
)
from .state import EngineCarry, MlModel


@struct.dataclass
class TickInput:
    price: jnp.ndarray          # f32
    price_valid: jnp.ndarray    # bool (reference: price is not None)
    prev_price: jnp.ndarray     # f32
    prev_price_valid: jnp.ndarray  # bool
    now_ms: jnp.ndarray         # i32
    api_key_present: jnp.ndarray  # bool

    @classmethod
    def make(cls, price, prev_price, now_ms, *, api_key_present=True,
             price_valid=True, prev_price_valid=True) -> "TickInput":
        return cls(
            price=jnp.asarray(price, jnp.float32),
            price_valid=jnp.asarray(price_valid),
            prev_price=jnp.asarray(prev_price, jnp.float32),
            prev_price_valid=jnp.asarray(prev_price_valid),
            now_ms=jnp.asarray(now_ms, jnp.int32),
            api_key_present=jnp.asarray(api_key_present),
        )


@struct.dataclass
class EntryDecision:
    """The (ok, code, extras) tuple of the reference as a fixed-shape struct."""

    ok: jnp.ndarray            # bool
    reason: jnp.ndarray        # i32 detailed Reason (OK when ok)
    side: jnp.ndarray          # i32 SIDE_* (valid when the scaffold was reached)
    level_idx: jnp.ndarray     # i32
    level_price: jnp.ndarray   # f32
    dist: jnp.ndarray          # f32
    direction: jnp.ndarray     # i32 DIR_*
    touch_count: jnp.ndarray   # i32
    new_touch: jnp.ndarray     # bool — this tick latched a fresh level contact
    conf: jnp.ndarray          # f32 (after decay mult)
    decay_mult: jnp.ndarray    # f32
    ml_prob: jnp.ndarray       # f32
    ml_prob_valid: jnp.ndarray  # bool (reference: prob is not None)
    blended: jnp.ndarray       # f32 (valid only in blend mode)
    stop: jnp.ndarray          # f32
    target: jnp.ndarray        # f32
    volume_slope: jnp.ndarray  # f32
    confluence: jnp.ndarray    # bool


def _ml_allowed(model: MlModel, params: EngineParams, *, level_solid, level_price,
                stop, touch_count, direction):
    """Reference ``_ml_allowed`` (:1454-1466): linear model over
    [lvl_type, |level_price-stop|, touch_count, direction==up], pass when
    sigmoid >= Q_MIN_PROB.  A 3-feature (skewed, quirk Q5) or absent model never
    blocks and reports no probability."""
    x = jnp.stack(
        [
            level_solid.astype(jnp.float32),
            jnp.abs(level_price - stop),
            touch_count.astype(jnp.float32),
            (direction == DIR_UP).astype(jnp.float32),
        ]
    )
    z = jnp.dot(model.coef, x) + model.intercept
    proba = jax.nn.sigmoid(z)
    usable = jnp.logical_and(model.present, model.n_features == 4)
    ok = jnp.where(usable, proba >= params.q_min_prob, True)
    return ok, jnp.where(usable, proba, 0.0), usable


def evaluate_entry(
    carry: EngineCarry,
    levels: Levels,
    params: EngineParams,
    tick: TickInput,
    ml_model: MlModel | None = None,
    touch_params: T.TouchMemoryParams | None = None,
) -> tuple[EntryDecision, EngineCarry]:
    """Pure evaluate_entry: returns the decision and the updated carry (touch
    latch/counters only — price/ts/cooldown updates belong to the loop, :2952-2955)."""
    if ml_model is None:
        ml_model = MlModel.absent()
    if touch_params is None:
        touch_params = T.TouchMemoryParams.default()

    reason = jnp.int32(Reason.OK)

    def first_fail(reason, fail, code):
        return jnp.where(
            jnp.logical_and(reason == Reason.OK, fail), jnp.int32(code), reason
        )

    # 0) API key (:1494)
    reason = first_fail(reason, jnp.logical_not(tick.api_key_present), Reason.MISSING_API_KEY)

    # 1) staleness (:1499): price None / last_ts None / gap > 15 s
    stale = jnp.logical_or(
        jnp.logical_not(tick.price_valid),
        jnp.logical_or(
            jnp.logical_not(carry.last_ts_valid),
            (tick.now_ms - carry.last_ts_ms) > params.stale_ms,
        ),
    )
    reason = first_fail(reason, stale, Reason.PRICE_STALE)

    # 2) in position (:1508)
    reason = first_fail(reason, carry.position.is_open, Reason.IN_POSITION)

    # 3) cooldown (:1516)
    reason = first_fail(reason, tick.now_ms < carry.cooldown_until_ms, Reason.COOLDOWN)

    # 4) levels (:1524)
    reason = first_fail(reason, levels.count == 0, Reason.NOLEVELS)

    # 5) direction (:1529-1540): EPS=1e-9 flat-tick reuse of last non-flat direction
    eps = jnp.float32(1e-9)
    up = tick.price > tick.prev_price + eps
    down = tick.price < tick.prev_price - eps
    direction = jnp.where(
        tick.prev_price_valid,
        jnp.where(up, DIR_UP, jnp.where(down, DIR_DOWN, carry.last_direction)),
        DIR_UNKNOWN,
    ).astype(jnp.int32)
    reason = first_fail(reason, direction == DIR_UNKNOWN, Reason.DIR_UNKNOWN)

    # 6) nearest level & distance (:1543-1555)
    nearest_idx, dist = F.nearest_level(levels, tick.price)
    level_price = levels.price[nearest_idx]
    level_solid = levels.kind[nearest_idx] == KIND_SOLID
    reason = first_fail(reason, dist > params.contact_prox, Reason.TOO_FAR)

    # 7) touch latch + over-touch (:1557-1587) — latch mutates iff gates 0-6 passed
    reached_7 = reason == Reason.OK
    new_contact, tc_after = T.update_contact(
        carry.contact, levels, tick.price, nearest_idx, params.contact_prox
    )
    contact = tree_select(reached_7, new_contact, carry.contact)
    touch_count = jnp.where(reached_7, tc_after, carry.contact.touch_counts[nearest_idx])
    new_touch = jnp.logical_and(
        reached_7, jnp.logical_not(carry.contact.latch[nearest_idx])
    )
    reason = first_fail(reason, touch_count >= params.overtouch_limit, Reason.LEVEL_OVERTOUCHED)

    # 7b) accumulation gates (:1589-1621) — only while guard regime == accumulation
    accumulating = carry.guard.regime == G.REGIME_ACCUMULATION
    edge_for_this = jnp.where(direction == DIR_DOWN, T.EDGE_TOP, T.EDGE_BOT)
    fatigued_edge = T.edge_fatigued(carry.touchmem, touch_params, tick.now_ms)
    fatigue_fail = jnp.logical_and(accumulating, fatigued_edge == edge_for_this)
    reason = first_fail(reason, fatigue_fail, Reason.EDGE_FATIGUE)

    tm_side = jnp.where(direction == DIR_DOWN, T.TM_SHORT, T.TM_LONG)
    tm_ok, tm_budget, tm_mult = T.allow_trade_at(
        carry.touchmem, touch_params, nearest_idx, tm_side, tick.now_ms
    )
    tm_fail = jnp.logical_and(accumulating, jnp.logical_not(tm_ok))
    reason = first_fail(
        reason,
        jnp.logical_and(tm_fail, tm_budget),
        Reason.TOUCH_BUDGET,
    )
    reason = first_fail(
        reason,
        jnp.logical_and(tm_fail, jnp.logical_not(tm_budget)),
        Reason.TOUCH_COOLDOWN,
    )
    decay_mult = jnp.where(jnp.logical_and(accumulating, tm_ok), tm_mult, 1.0)

    # 8) confidence (:1626-1641)
    conf = (
        C.compute_confidence(
            level_price=level_price,
            level_kind=levels.kind[nearest_idx],
            price=tick.price,
            direction=direction,
            touch_count=touch_count,
            contact_prox=params.contact_prox,
        )
        * decay_mult
    )
    qmin = params.q_min_prob
    reason = first_fail(reason, conf < qmin, Reason.CONF_LOW)

    # 9) side + scaffold (:1643-1675)
    side = jnp.where(direction == DIR_UP, SIDE_LONG, SIDE_SHORT).astype(jnp.int32)
    stop = jnp.where(
        side == SIDE_LONG, level_price - params.stop_padding, level_price + params.stop_padding
    )
    target = jnp.where(
        side == SIDE_LONG, level_price + params.tp_padding, level_price - params.tp_padding
    )

    # 9b) accumulation-breakout counter-trend gate (:1652-1666)
    reason = first_fail(
        reason, jnp.logical_not(G.allow_trade(carry.guard, side)), Reason.ACC_BREAKOUT_GATE
    )

    # 10) soft veto (:1677-1705)
    bar_close, bar_vol, bar_valid = carry.bars.ordered()
    vslope = F.volume_slope(bar_vol, bar_valid, window=6)
    confluence = F.has_confluence_near(levels, level_price, params.confluence_within)
    veto_ok, veto_reason = C.soft_veto(
        side=side,
        volume_slope=vslope,
        approach_from_below=direction == DIR_UP,
        confluence=confluence,
        proximity_abs=dist,
        contact_prox=params.contact_prox,
        veto_vol_strong=params.veto_vol_strong,
        veto_prox=params.veto_prox,
    )
    veto_fail = jnp.logical_and(params.enable_veto, jnp.logical_not(veto_ok))
    reason = jnp.where(
        jnp.logical_and(reason == Reason.OK, veto_fail), veto_reason, reason
    )

    # 11) ML / blended gate (:1707-1756)
    s = params.w_rules + params.w_ml
    w_rules = jnp.where(s <= 0, 1.0, params.w_rules / jnp.where(s <= 0, 1.0, s))
    w_ml = jnp.where(s <= 0, 0.0, params.w_ml / jnp.where(s <= 0, 1.0, s))

    ok_ml, ml_proba, ml_usable = _ml_allowed(
        ml_model, params,
        level_solid=level_solid, level_price=level_price, stop=stop,
        touch_count=touch_count, direction=direction,
    )
    # mlp: model prob when the gate ran and produced one, else conf (:1726-1728)
    ran_ml = jnp.logical_not(params.disable_ml_gate)
    mlp = jnp.where(jnp.logical_and(ran_ml, ml_usable), ml_proba, conf)

    blended = w_rules * conf + w_ml * mlp
    blend_fail = jnp.logical_and(params.use_blend, blended < qmin)
    reason = first_fail(reason, blend_fail, Reason.COMBINED_LOW)
    and_fail = jnp.logical_and(
        jnp.logical_not(params.use_blend),
        jnp.logical_and(ran_ml, jnp.logical_not(ok_ml)),
    )
    reason = first_fail(reason, and_fail, Reason.ML_CONF_LOW)

    ok = reason == Reason.OK
    decision = EntryDecision(
        ok=ok,
        reason=reason,
        side=side,
        level_idx=nearest_idx.astype(jnp.int32),
        level_price=level_price,
        dist=dist,
        direction=direction,
        touch_count=touch_count.astype(jnp.int32),
        new_touch=new_touch,
        conf=conf,
        decay_mult=decay_mult,
        ml_prob=mlp,
        ml_prob_valid=jnp.logical_and(ran_ml, ml_usable),
        blended=blended,
        stop=stop,
        target=target,
        volume_slope=vslope,
        confluence=confluence,
    )
    return decision, carry.replace(contact=contact)


def tree_select(pred, on_true, on_false):
    """Elementwise tree select over matching pytrees."""
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), on_true, on_false
    )
