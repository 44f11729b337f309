"""SmartEntryPlanner as pure batched functions.

Re-expression of the reference ``SmartEntryPlanner`` (qmmx_monolithic.py:382-700):
a rule planner suggesting LONG/SHORT entries around levels from volume behavior —
decreasing volume into a level → reversal, increasing → continuation, with a
confluence snap-back pattern detector (pierce first level, slightly pierce the
second, snap back ≥ min_retrace).

NOTE: the planner is constructed but ``should_enter`` is never called in the
reference's live path (SURVEY.md §2.5 "dead").  It is still part of the public
component inventory, so the rebuild keeps it available (and pure/vmap-able).
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..ops import features as F
from ..types import SIDE_LONG, SIDE_SHORT, Levels

# defaults (:394-412)
PROXIMITY_WINDOW = 0.35
CONFLUENCE_WINDOW = 0.6
SLIGHT_PIERCE_FRACTION = 0.12
VOL_LOOKBACK = 5
MIN_BARS_FOR_TREND = 3
MIN_RETRACE_TICKS = 0.08
ENTRY_SLIPPAGE = 0.03
FRESHNESS_SECONDS = 180

BASIS_REVERSAL = 1
BASIS_CONTINUATION = 2


@struct.dataclass
class PlannerSignal:
    valid: jnp.ndarray        # bool — a signal exists
    side: jnp.ndarray         # i32 SIDE_*
    basis: jnp.ndarray        # i32 BASIS_*
    level_price: jnp.ndarray  # f32
    entry_price: jnp.ndarray  # f32
    stop_hint: jnp.ndarray    # f32
    target_hint: jnp.ndarray  # f32
    target_valid: jnp.ndarray  # bool
    confluence: jnp.ndarray   # bool (cluster of >= 2)
    snapback: jnp.ndarray     # bool (confluence snap-back pattern confirmed)


def _round2(x):
    return jnp.round(jnp.asarray(x, jnp.float32) * 100.0) / 100.0


def snapback_pattern(
    prices: jnp.ndarray,     # f32[..., N] oldest→newest
    valid: jnp.ndarray,
    levels: Levels,
    anchor_price,
    approach_from_below,     # bool
    *,
    proximity_window: float = PROXIMITY_WINDOW,
    confluence_window: float = CONFLUENCE_WINDOW,
    slight_pierce_fraction: float = SLIGHT_PIERCE_FRACTION,
    min_retrace: float = MIN_RETRACE_TICKS,
) -> jnp.ndarray:
    """``_has_reverse_after_slight_second_pierce`` (:614-655, :1051-1110) over the
    last 8 prices: pierce the first cluster level, slightly pierce the second,
    then snap back across the second by >= min_retrace."""
    anchor = jnp.asarray(anchor_price, jnp.float32)
    in_cluster = jnp.logical_and(
        levels.valid, jnp.abs(levels.price - anchor) <= confluence_window
    )
    cluster_n = jnp.sum(in_cluster.astype(jnp.int32), axis=-1)
    cl_max = jnp.max(jnp.where(in_cluster, levels.price, -jnp.inf), axis=-1)
    cl_min = jnp.min(jnp.where(in_cluster, levels.price, jnp.inf), axis=-1)
    from_below = jnp.asarray(approach_from_below)
    # from_above: first = max, second = next lower; from_below: first = min,
    # second = next higher (:629-633, :1068-1091)
    first = jnp.where(from_below, cl_min, cl_max)
    below_first = jnp.logical_and(in_cluster, levels.price > first)
    above_first = jnp.logical_and(in_cluster, levels.price < first)
    second = jnp.where(
        from_below,
        jnp.min(jnp.where(below_first, levels.price, jnp.inf), axis=-1),
        jnp.max(jnp.where(above_first, levels.price, -jnp.inf), axis=-1),
    )
    second_exists = jnp.where(
        from_below, jnp.any(below_first, axis=-1), jnp.any(above_first, axis=-1)
    )

    pos_from_end = jnp.cumsum(valid[..., ::-1].astype(jnp.int32), axis=-1)[..., ::-1] - 1
    in_last8 = jnp.logical_and(valid, pos_from_end < 8)
    n = jnp.sum(valid.astype(jnp.int32), axis=-1)

    slight = slight_pierce_fraction * proximity_window
    d_first = jnp.abs(prices - first[..., None])
    d_second = jnp.abs(prices - second[..., None])
    pierced_first = jnp.any(jnp.logical_and(in_last8, d_first <= proximity_window), axis=-1)
    slight_second = jnp.any(
        jnp.logical_and(
            in_last8,
            jnp.logical_and(d_second > proximity_window,
                            d_second <= proximity_window + slight),
        ),
        axis=-1,
    )
    last_price = jnp.sum(jnp.where(pos_from_end == 0, prices, 0.0), axis=-1)
    snapped = jnp.where(
        from_below,
        last_price <= second - min_retrace,
        last_price >= second + min_retrace,
    )
    return jnp.logical_and(
        jnp.logical_and(cluster_n >= 2, second_exists),
        jnp.logical_and(
            n >= 3,
            jnp.logical_and(pierced_first, jnp.logical_and(slight_second, snapped)),
        ),
    )


def should_enter(
    *,
    current_price,
    current_time_s,          # epoch-ish seconds (relative ok)
    pattern_time_s,          # freshness anchor (:444-446)
    pattern_time_valid,      # bool
    levels: Levels,
    bar_prices,              # f32[..., N] oldest→newest
    bar_volumes,
    bar_valid,
    approach_hint=None,      # optional int 0=from_above/1=from_below; None → infer
    proximity_window: float = PROXIMITY_WINDOW,
    confluence_window: float = CONFLUENCE_WINDOW,
    entry_slippage: float = ENTRY_SLIPPAGE,
    freshness_seconds: int = FRESHNESS_SECONDS,
) -> PlannerSignal:
    """``should_enter`` (:417-531): returns a masked signal (valid=False mirrors
    the reference's ``None`` returns for freshness/proximity/approach/trend guards)."""
    price = jnp.asarray(current_price, jnp.float32)
    fresh = jnp.logical_and(
        jnp.asarray(pattern_time_valid),
        (jnp.asarray(current_time_s, jnp.float32) - jnp.asarray(pattern_time_s, jnp.float32))
        <= freshness_seconds,
    )
    has_levels = levels.count > 0
    idx, dist = F.nearest_level(levels, price)
    level_price = levels.price[idx]
    near = dist <= proximity_window

    if approach_hint is None:
        approach = F.infer_approach(bar_prices, bar_valid, level_price)
    else:
        approach = jnp.asarray(approach_hint)
    approach_known = approach >= 0
    from_below = approach == 1

    vol_trend, trend_defined = F.volume_trend_toward_level(
        bar_prices, bar_volumes, bar_valid, level_price,
        vol_lookback=VOL_LOOKBACK, min_bars_for_trend=MIN_BARS_FOR_TREND,
    )

    confl = F.confluence_count(levels, level_price, confluence_window) > 1
    snap = snapback_pattern(
        bar_prices, bar_valid, levels, level_price, from_below,
        proximity_window=proximity_window, confluence_window=confluence_window,
    )

    reversal = vol_trend < 0
    slight = SLIGHT_PIERCE_FRACTION * proximity_window
    # reversal (:484-497): from_above → LONG, entry above level, stop below window;
    # continuation (:499-511): from_above → SHORT, entry below level, stop above.
    rev_side = jnp.where(from_below, SIDE_SHORT, SIDE_LONG)
    cont_side = jnp.where(from_below, SIDE_LONG, SIDE_SHORT)
    side = jnp.where(reversal, rev_side, cont_side).astype(jnp.int32)
    basis = jnp.where(reversal, BASIS_REVERSAL, BASIS_CONTINUATION).astype(jnp.int32)

    rev_entry = jnp.where(from_below, level_price - entry_slippage, level_price + entry_slippage)
    rev_stop = jnp.where(
        from_below,
        level_price + (proximity_window + slight),
        level_price - (proximity_window + slight),
    )
    cont_entry = jnp.where(from_below, level_price + entry_slippage, level_price - entry_slippage)
    cont_stop = jnp.where(from_below, level_price - proximity_window, level_price + proximity_window)
    entry = _round2(jnp.where(reversal, rev_entry, cont_entry))
    stop = _round2(jnp.where(reversal, rev_stop, cont_stop))

    # next-level target in the trade direction (:685-700, rounded to cents)
    from .exits import next_level_target

    tgt, tgt_found = next_level_target(levels, level_price, side)
    tgt = _round2(tgt)

    valid = jnp.logical_and(
        jnp.logical_and(fresh, has_levels),
        jnp.logical_and(near, jnp.logical_and(approach_known, trend_defined)),
    )
    return PlannerSignal(
        valid=valid,
        side=side,
        basis=basis,
        level_price=level_price,
        entry_price=entry,
        stop_hint=stop,
        target_hint=tgt,
        target_valid=tgt_found,
        confluence=confl,
        snapback=jnp.logical_and(confl, snap),
    )
