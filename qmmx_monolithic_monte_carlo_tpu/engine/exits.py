"""ExitStrategy as pure batched functions.

Re-expression of the reference ``ExitStrategy`` (qmmx_monolithic.py:703-1110):
``should_exit`` decides an exit when the predicted level behavior (reversal on
decreasing volume into the level / continuation on increasing volume) goes
against the open position; ``should_escalate_on_target`` rolls the target to the
next level and trails the stop when continuation is favored at the target.

Inputs are (price, volume) histories as fixed-shape arrays with validity masks
(the reference's ``recent_bars`` tuples, oldest→newest).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..ops import features as F
from ..types import SIDE_LONG, Levels

# ExitStrategy defaults (:704-718)
PROXIMITY_WINDOW = 0.35
CONFLUENCE_WINDOW = 0.6
VOL_LOOKBACK = 5
MIN_BARS_FOR_TREND = 3

BASIS_NONE = 0
BASIS_REVERSAL = 1
BASIS_CONTINUATION = 2


@struct.dataclass
class ExitDecision:
    exit: jnp.ndarray         # bool
    basis: jnp.ndarray        # i32 BASIS_*
    level_price: jnp.ndarray  # f32
    level_valid: jnp.ndarray  # bool


def should_exit(
    *,
    side,                    # SIDE_LONG / SIDE_SHORT (the open trade)
    current_price,
    levels: Levels,
    bar_prices,              # f32[..., N] oldest→newest (close prices)
    bar_volumes,             # f32[..., N]
    bar_valid,               # bool[..., N]
    proximity_window: float = PROXIMITY_WINDOW,
    confluence_window: float = CONFLUENCE_WINDOW,
    full_window: bool = False,
) -> ExitDecision:
    """``should_exit`` (:754-895).  The reference's early ``return hold`` guards
    (no levels / not near / no volume trend) become a combined hold mask.

    ``full_window=True`` (static) asserts ``bar_prices``/``bar_volumes`` are
    exactly the VOL_LOOKBACK newest bars, all valid, oldest→newest —
    ``bar_valid`` is then ignored and the window featurizers take their
    static fast paths (bitwise-equal; ops/features.volume_trend_full_window).
    The scaled engine scan passes static ring slices on the post-peel bars."""
    price = jnp.asarray(current_price, jnp.float32)
    # winner's price rides the running-min select — a [P]-indexed gather here
    # runs every bar of the scaled scan (ops/features.nearest_level_full).
    # Invalid-winner price is 0.0 instead of the raw table row; every consumer
    # is gated on level_valid/can_decide, which require a valid nearest level.
    idx, dist, level_price, _ = F.nearest_level_full(levels, price)
    has_levels = levels.count > 0
    near = dist <= proximity_window

    # approach: infer from last two bar prices; fallback current vs level (:802-806)
    if full_window:
        inferred = F.infer_approach_full_window(bar_prices, level_price)
    else:
        inferred = F.infer_approach(bar_prices, bar_valid, level_price)
    fallback = jnp.where(price > level_price, 0, 1)  # from_above=0 / from_below=1
    approach_below = jnp.where(inferred >= 0, inferred, fallback) == 1

    if full_window:
        vol_trend = F.volume_trend_full_window(
            bar_prices, bar_volumes, level_price,
            min_bars_for_trend=MIN_BARS_FOR_TREND)
        trend_defined = jnp.ones(vol_trend.shape, bool)
    else:
        vol_trend, trend_defined = F.volume_trend_toward_level(
            bar_prices, bar_volumes, bar_valid, level_price,
            vol_lookback=VOL_LOOKBACK, min_bars_for_trend=MIN_BARS_FOR_TREND,
        )

    reversal = vol_trend < 0
    basis = jnp.where(reversal, BASIS_REVERSAL, BASIS_CONTINUATION)

    is_long = jnp.asarray(side) == SIDE_LONG
    # reversal bounce direction: from_above → up, from_below → down (:830-831)
    rev_down = approach_below
    # continuation direction: from_above → down, from_below → up (:865-866)
    cont_down = jnp.logical_not(approach_below)
    against = jnp.where(
        reversal,
        jnp.where(is_long, rev_down, jnp.logical_not(rev_down)),
        jnp.where(is_long, cont_down, jnp.logical_not(cont_down)),
    )

    can_decide = jnp.logical_and(jnp.logical_and(has_levels, near), trend_defined)
    return ExitDecision(
        exit=jnp.logical_and(can_decide, against),
        basis=jnp.where(can_decide, basis, BASIS_NONE).astype(jnp.int32),
        level_price=level_price,
        level_valid=jnp.logical_and(has_levels, near),
    )


def next_level_target(levels: Levels, ref_price, side) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``_next_level_target`` (:1038-1049): next valid level strictly beyond
    ``ref_price`` in the trade direction.  Returns (price, found).  Batch-safe
    over a leading path axis on ``ref_price``/``side``."""
    ref = jnp.asarray(ref_price, jnp.float32)
    is_long = jnp.asarray(side) == SIDE_LONG
    eps = 1e-9
    higher = jnp.logical_and(levels.valid, levels.price > ref[..., None] + eps)
    lower = jnp.logical_and(levels.valid, levels.price < ref[..., None] - eps)
    up_px = jnp.min(jnp.where(higher, levels.price, jnp.inf), axis=-1)
    dn_px = jnp.max(jnp.where(lower, levels.price, -jnp.inf), axis=-1)
    found = jnp.where(is_long, jnp.any(higher, axis=-1), jnp.any(lower, axis=-1))
    return jnp.where(is_long, up_px, dn_px), found


@struct.dataclass
class Escalation:
    escalate: jnp.ndarray     # bool
    next_target: jnp.ndarray  # f32
    trail_stop: jnp.ndarray   # f32
    basis: jnp.ndarray        # i32


def should_escalate_on_target(
    *,
    side,
    entry,
    current_price,
    levels: Levels,
    bar_prices,
    bar_volumes,
    bar_valid,
    proximity_window: float = PROXIMITY_WINDOW,
    full_window: bool = False,
) -> Escalation:
    """``should_escalate_on_target`` (:897-960): when ``should_exit`` says
    hold-with-continuation, roll the target to the next level beyond the anchor
    and trail the stop to max(entry, anchor - prox) for longs (mirror for shorts).

    ``full_window`` is ``should_exit``'s static fast-path flag (see there)."""
    res = should_exit(
        side=side, current_price=current_price, levels=levels,
        bar_prices=bar_prices, bar_volumes=bar_volumes, bar_valid=bar_valid,
        proximity_window=proximity_window, full_window=full_window,
    )
    anchor = jnp.where(res.level_valid, res.level_price,
                       jnp.asarray(current_price, jnp.float32))
    nxt, found = next_level_target(levels, anchor, side)
    is_long = jnp.asarray(side) == SIDE_LONG
    entry = jnp.asarray(entry, jnp.float32)
    trail = jnp.where(
        is_long,
        jnp.maximum(entry, anchor - proximity_window),
        jnp.minimum(entry, anchor + proximity_window),
    )
    # reference rounds the trailed stop to cents (:952)
    trail = jnp.round(trail * 100.0) / 100.0
    go = jnp.logical_and(
        jnp.logical_and(jnp.logical_not(res.exit), res.basis == BASIS_CONTINUATION),
        found,
    )
    return Escalation(
        escalate=go, next_target=nxt, trail_stop=trail, basis=res.basis
    )
