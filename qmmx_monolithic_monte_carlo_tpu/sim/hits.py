"""Shared intrabar stop/target hit + same-bar tie resolution.

The reference resolves a bar that touches BOTH barriers with a distance-
weighted coin flip: ``p_target_first = up_span / (up_span + down_span)``
computed from the bar's extremes around the entry price
(qmmx_monolithic.py:3467-3480).  Every scaled lifecycle surface
(sim/gatedpath.py, sim/enginepath.py) shares this exact block, so this helper
is the single source of truth; the fused first-contact kernel
(ops/triton_paths.py) re-expresses it per path and is pinned against a NumPy
mirror of the same rule.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class BarHit(NamedTuple):
    """Outcome of one bar against an open position's barriers (all [...P])."""

    stop_hit: jnp.ndarray      # bool — stop barrier touched this bar
    tgt_hit: jnp.ndarray       # bool — target barrier touched this bar
    hit: jnp.ndarray           # bool — either barrier touched
    target_first: jnp.ndarray  # bool — target resolves first (tie coin on both)


def bar_hit_outcome(*, is_open, is_long, entry, stop, target, high, low, tie):
    """First-hit logic for one OHLC bar (qmmx_monolithic.py:3467-3480).

    ``tie`` is the pre-drawn U(0,1) for this (path, bar); when both barriers
    fall inside the bar, target-first wins iff ``tie < up_span / (up_span +
    down_span + 1e-9)`` with spans measured from the entry fill to the bar
    extremes (the distance-weighted coin, same formula for both sides).
    """
    is_open = jnp.asarray(is_open)
    is_long = jnp.asarray(is_long)
    stop_hit = jnp.logical_and(
        is_open, jnp.where(is_long, low <= stop, high >= stop))
    tgt_hit = jnp.logical_and(
        is_open, jnp.where(is_long, high >= target, low <= target))
    both = jnp.logical_and(stop_hit, tgt_hit)
    up_span = jnp.maximum(0.0, high - entry)
    dn_span = jnp.maximum(0.0, entry - low)
    p_tp = up_span / (up_span + dn_span + 1e-9)
    target_first = jnp.where(
        both, tie < p_tp, jnp.logical_and(tgt_hit, jnp.logical_not(stop_hit)))
    return BarHit(
        stop_hit=stop_hit, tgt_hit=tgt_hit,
        hit=jnp.logical_or(stop_hit, tgt_hit), target_first=target_first,
    )
