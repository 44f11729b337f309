"""First-hit stop/target scan primitives.

The reference walks bars forward in Python to find which of stop/target is hit
first (deterministic replay :3619-3628; Monte Carlo walk_outcome :3449-3486).  On
an accelerator this becomes a vectorized first-True-index computation over a bar axis:

* a *long* stop at ``s`` is hit at the first bar ``j`` with ``low[j] <= s``;
* a *long* target at ``t`` at the first ``j`` with ``high[j] >= t``; shorts mirror.

Two implementations:

* ``first_hit_bruteforce`` — builds the boolean masks and takes ``argmax``;
  O(N) per (path, threshold); simple, fuses well, used for modest N.
* ``first_hit_monotone`` — exploits that the running min of lows / max of highs is
  monotone along the bar axis, so the first-hit index is a ``searchsorted`` into
  the prefix-extremum array: O(log N) per threshold after an O(N) prefix pass.
  This is the building block for many-trials-per-candidate Monte Carlo where the
  bars are shared and only the noisy thresholds vary.

Both return ``N`` (one past the end) when never hit, and are side-agnostic:
callers pass ``lows`` with ``<=`` semantics for long stops, etc.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def first_index_leq(series: jnp.ndarray, threshold, start_mask=None) -> jnp.ndarray:
    """First index j with series[j] <= threshold (N if none). ``start_mask`` masks
    out bars before the entry bar (False = excluded)."""
    series = jnp.asarray(series, jnp.float32)
    hit = series <= jnp.asarray(threshold, jnp.float32)[..., None]
    if start_mask is not None:
        hit = jnp.logical_and(hit, start_mask)
    n = series.shape[-1]
    any_hit = jnp.any(hit, axis=-1)
    idx = jnp.argmax(hit, axis=-1)
    return jnp.where(any_hit, idx, n)


def first_index_geq(series: jnp.ndarray, threshold, start_mask=None) -> jnp.ndarray:
    """First index j with series[j] >= threshold (N if none)."""
    series = jnp.asarray(series, jnp.float32)
    hit = series >= jnp.asarray(threshold, jnp.float32)[..., None]
    if start_mask is not None:
        hit = jnp.logical_and(hit, start_mask)
    n = series.shape[-1]
    any_hit = jnp.any(hit, axis=-1)
    idx = jnp.argmax(hit, axis=-1)
    return jnp.where(any_hit, idx, n)


def running_min(series: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.associative_scan(jnp.minimum, series, axis=-1)


def running_max(series: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.associative_scan(jnp.maximum, series, axis=-1)


def first_hit_monotone_leq(run_min: jnp.ndarray, threshold) -> jnp.ndarray:
    """Given run_min[j] = min(series[..j]) (non-increasing), first index with
    series <= thr equals first index with run_min <= thr.  run_min is
    non-increasing, so flip it to non-decreasing and use searchsorted.

    run_min: f32[N] (already restricted to bars after entry); threshold: f32[...].
    Returns i32[...] in [0, N].
    """
    n = run_min.shape[-1]
    asc = -run_min  # non-decreasing
    t = -jnp.asarray(threshold, jnp.float32)
    # first j with asc[j] >= t  == searchsorted(asc, t, side='left')
    return jnp.searchsorted(asc, t, side="left").astype(jnp.int32).clip(0, n)


def first_hit_monotone_geq(run_max: jnp.ndarray, threshold) -> jnp.ndarray:
    """First index with series >= thr via the running max (non-decreasing)."""
    n = run_max.shape[-1]
    t = jnp.asarray(threshold, jnp.float32)
    return jnp.searchsorted(run_max, t, side="left").astype(jnp.int32).clip(0, n)


def stop_target_outcome(
    *,
    highs: jnp.ndarray,     # f32[..., N] bars after entry (entry bar excluded)
    lows: jnp.ndarray,      # f32[..., N]
    side,                   # +1 long / -1 short, broadcastable
    entry,
    stop,
    target,
    tie_uniform,            # U(0,1) for the same-bar coin flip, broadcastable
    valid_mask=None,        # bool[..., N] optional padding mask
    side_aware_tie: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized reference ``walk_outcome`` (:3449-3486).

    stop_hit  = low <= stop (long) / high >= stop (short)
    target_hit = high >= target (long) / low <= target (short), first index each;
    same-bar tie → coin flip with p(target first) = up_span/(up_span+down_span+1e-9),
    up_span = max(0, high_j - entry), down_span = max(0, entry - low_j)  (:3472-3480).
    NOTE: the reference applies the *up* share as p(target first) for BOTH sides;
    for shorts the target lies below, so this favors the stop.  The default
    reproduces that exactly (the MC path is the parity oracle);
    ``side_aware_tie=True`` selects the corrected down-share for shorts.

    Returns (R, outcome) with R = reward/risk on tp, -1 on stop, 0 open, where
    risk = |entry - stop| (1e-9 floor, :3463) and reward = |target - entry|.
    Outcome codes: types.OUTCOME_{OPEN,TP,STOP}.
    """
    side = jnp.asarray(side)
    is_long = side > 0
    highs = jnp.asarray(highs, jnp.float32)
    lows = jnp.asarray(lows, jnp.float32)
    entry = jnp.asarray(entry, jnp.float32)
    stop = jnp.asarray(stop, jnp.float32)
    target = jnp.asarray(target, jnp.float32)

    stop_series = jnp.where(is_long[..., None], lows, -highs)
    stop_thr = jnp.where(is_long, stop, -stop)
    tgt_series = jnp.where(is_long[..., None], -highs, lows)
    tgt_thr = jnp.where(is_long, -target, target)

    j_stop = first_index_leq(stop_series, stop_thr, valid_mask)
    j_tgt = first_index_leq(tgt_series, tgt_thr, valid_mask)

    n = highs.shape[-1]
    none_hit = jnp.logical_and(j_stop >= n, j_tgt >= n)
    j_first = jnp.minimum(j_stop, j_tgt)
    tie = jnp.logical_and(j_stop == j_tgt, jnp.logical_not(none_hit))

    jj = jnp.clip(j_first, 0, n - 1)
    hh = jnp.take_along_axis(highs, jj[..., None], axis=-1)[..., 0]
    ll = jnp.take_along_axis(lows, jj[..., None], axis=-1)[..., 0]
    up_span = jnp.maximum(0.0, hh - entry)
    down_span = jnp.maximum(0.0, entry - ll)
    p_target_first = up_span / (up_span + down_span + 1e-9)
    if side_aware_tie:
        # corrected: for shorts the favorable (target-ward) move is down.
        p_target_first = jnp.where(is_long, p_target_first, 1.0 - p_target_first)
    coin_target = jnp.asarray(tie_uniform, jnp.float32) < p_target_first

    target_first = jnp.where(tie, coin_target, j_tgt < j_stop)
    risk = jnp.maximum(jnp.abs(entry - stop), 1e-9)
    reward = jnp.abs(target - entry)

    from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP

    r = jnp.where(
        none_hit, 0.0, jnp.where(target_first, reward / risk, -1.0)
    ).astype(jnp.float32)
    outcome = jnp.where(
        none_hit, OUTCOME_OPEN, jnp.where(target_first, OUTCOME_TP, OUTCOME_STOP)
    ).astype(jnp.int32)
    return r, outcome
