"""Batched level-proximity featurizer and volume features.

Pure, ``vmap``-able re-expressions of the reference's per-tick scalar loops:

* nearest level & distance — ``min(levels, key=|L.price - p|)``
  (qmmx_monolithic.py:1543-1544, :3381-3383); first-minimum tie-break preserved via
  ``argmin`` over the SQL-ordered level axis.
* confluence count — ``sum(|L - target| <= within) >= 2`` (:1885-1886, :3069-3070).
* approach one-hot over ["from_above", "from_below"] (:320).
* OnlinePolicy 7-dim feature vector (:308-331): [bias, clipped prox, vol_trend/1e6
  clipped ±1, onehot(approach, 2), confluence, minutes_since_open/390].
* volume slope — ``_calc_volume_slope`` halves-average slope (:1796-1811).
* volume trend toward level — planner/exit-strategy filtered trend (:567-601,
  :993-1024).

All functions take SoA arrays and masks so they run identically under vmap across
ticks, paths, trials, and symbols.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import APPROACH_FROM_BELOW, Levels

# plain float: a module-scope jnp scalar would initialize the default
# backend at import time, before a caller can pick the platform
_INF = float("inf")


def nearest_level(levels: Levels, price) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Index (first-min tie-break, matching Python ``min``) and |distance| of the
    nearest valid level.

    Implemented as an unrolled running-min over the (static, small) level axis
    instead of a broadcast [..., L] argmin, which would materialize a
    price-shaped×L intermediate plus a gather.  The choice was made on another
    accelerator; whether it is still the faster form on a GPU is not measured.
    Strict ``<`` keeps the first minimum, matching Python ``min`` tie-breaks.
    """
    price = jnp.asarray(price, jnp.float32)
    best_d = jnp.full(price.shape, _INF, jnp.float32)
    best_i = jnp.zeros(price.shape, jnp.int32)
    for i in range(levels.max_levels):
        d = jnp.abs(price - levels.price[..., i])
        d = jnp.where(levels.valid[..., i], d, _INF)
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, i, best_i)
    return best_i, best_d


def nearest_level_full(levels: Levels, price):
    """``nearest_level`` that also selects the winner's price and kind through
    the same running-min — no ``table[idx]`` gather afterwards (a [P]-indexed
    gather was the slow form where this was first tuned; not yet measured on
    a GPU).  Returns
    (idx, dist, level_price, level_kind) — price 0.0 where invalid (matching
    ``where(valid, price, 0)`` tables), kind i32."""
    price = jnp.asarray(price, jnp.float32)
    best_d = jnp.full(price.shape, _INF, jnp.float32)
    best_i = jnp.zeros(price.shape, jnp.int32)
    best_px = jnp.zeros(price.shape, jnp.float32)
    best_k = jnp.zeros(price.shape, jnp.int32)
    kind = jnp.asarray(levels.kind, jnp.int32)
    for i in range(levels.max_levels):
        d = jnp.abs(price - levels.price[..., i])
        d = jnp.where(levels.valid[..., i], d, _INF)
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, i, best_i)
        px_i = jnp.where(levels.valid[..., i], levels.price[..., i], 0.0)
        best_px = jnp.where(better, px_i, best_px)
        best_k = jnp.where(better, kind[..., i], best_k)
    return best_i, best_d, best_px, best_k


def confluence_count(levels: Levels, anchor_price, within) -> jnp.ndarray:
    """Number of valid levels within ``within`` of ``anchor_price`` (includes the
    anchor level itself, exactly like :1886)."""
    anchor = jnp.asarray(anchor_price, jnp.float32)
    near = jnp.abs(levels.price - anchor[..., None]) <= within
    return jnp.sum(jnp.logical_and(near, levels.valid), axis=-1)


def has_confluence_near(levels: Levels, anchor_price, within=0.15) -> jnp.ndarray:
    """Reference ``_has_confluence_near`` (:1885-1886): >= 2 levels within window."""
    return confluence_count(levels, anchor_price, within) >= 2


def policy_features(
    *,
    proximity_abs,
    volume_trend,
    approach,          # int: APPROACH_FROM_ABOVE (0) / APPROACH_FROM_BELOW (1)
    confluence,        # bool
    minutes_since_open,
) -> jnp.ndarray:
    """OnlinePolicy.build_features (:308-331) → f32[..., 7].

    x = [1, min(1, prox), clip(vol_trend/1e6, ±1), 1[from_above], 1[from_below],
         1[confluence], min(1, minutes/390)]
    """
    prox = jnp.minimum(1.0, jnp.asarray(proximity_abs, jnp.float32))
    vt = jnp.clip(jnp.asarray(volume_trend, jnp.float32) / 1e6, -1.0, 1.0)
    approach = jnp.asarray(approach)
    from_above = (approach != APPROACH_FROM_BELOW).astype(jnp.float32)
    from_below = (approach == APPROACH_FROM_BELOW).astype(jnp.float32)
    cf = jnp.asarray(confluence).astype(jnp.float32)
    tod = jnp.minimum(1.0, jnp.asarray(minutes_since_open, jnp.float32) / 390.0)
    ones = jnp.ones_like(prox)
    return jnp.stack([ones, prox, vt, from_above, from_below, cf, tod], axis=-1)


POLICY_FEATURE_DIM = 7


def volume_slope(volumes: jnp.ndarray, valid: jnp.ndarray, window: int = 6) -> jnp.ndarray:
    """Reference ``_calc_volume_slope`` (:1796-1811) on a fixed-size newest-last buffer.

    Semantics: with fewer than 3 valid bars return 0. Take the last
    ``min(window, n)`` volumes; ``half = max(2, len//2)``; v1 = mean of first
    ``half``; v2 = mean of last ``half``; 0 if both are 0; else (v2-v1)/(|v1|+1e-9).

    ``volumes``/``valid`` are [..., N] with padding anywhere ``valid`` is False;
    valid entries must be contiguous and newest-last (ring buffers are rotated
    before calling).
    """
    volumes = jnp.asarray(volumes, jnp.float32)
    n_total = volumes.shape[-1]
    n = jnp.sum(valid.astype(jnp.int32), axis=-1)  # valid count
    m = jnp.minimum(window, n)                     # bars actually used
    half = jnp.maximum(2, m // 2)

    # Position of each slot from the end: pos 0 == newest valid bar.
    pos_from_end = jnp.cumsum(valid[..., ::-1].astype(jnp.int32), axis=-1)[..., ::-1] - 1
    in_window = jnp.logical_and(valid, pos_from_end < m[..., None])
    # Within the window, index from its start: 0 .. m-1 (newest has m-1).
    idx_in_win = (m[..., None] - 1) - pos_from_end
    first_mask = jnp.logical_and(in_window, idx_in_win < half[..., None])
    last_mask = jnp.logical_and(in_window, idx_in_win >= (m - half)[..., None])

    v1 = jnp.sum(jnp.where(first_mask, volumes, 0.0), axis=-1) / half.astype(jnp.float32)
    v2 = jnp.sum(jnp.where(last_mask, volumes, 0.0), axis=-1) / half.astype(jnp.float32)
    slope = (v2 - v1) / (jnp.abs(v1) + 1e-9)
    slope = jnp.where(jnp.logical_and(v1 == 0.0, v2 == 0.0), 0.0, slope)
    return jnp.where(n < 3, 0.0, slope)


def volume_trend_toward_level(
    prices: jnp.ndarray,
    volumes: jnp.ndarray,
    valid: jnp.ndarray,
    level,
    *,
    vol_lookback: int = 5,
    min_bars_for_trend: int = 3,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Planner/ExitStrategy ``_volume_trend_toward_level`` (:567-601, :993-1024).

    Returns (trend, defined) where ``defined`` is False when there is not enough
    history (reference returns None).  Semantics on the last ``vol_lookback`` bars:
    keep volumes of bars whose distance to the level did not increase vs the
    previous bar (first bar always kept); if fewer than ``min_bars_for_trend``
    remain, use all lookback volumes; slope = avg(last k) - avg(first k) with
    k = max(2, len//2).

    ``prices``/``volumes`` are [..., N] newest-last with a contiguous valid mask.
    """
    prices = jnp.asarray(prices, jnp.float32)
    volumes = jnp.asarray(volumes, jnp.float32)
    level = jnp.asarray(level, jnp.float32)
    n = jnp.sum(valid.astype(jnp.int32), axis=-1)
    need = max(vol_lookback, min_bars_for_trend)
    defined = n >= need

    pos_from_end = jnp.cumsum(valid[..., ::-1].astype(jnp.int32), axis=-1)[..., ::-1] - 1
    seq_mask = jnp.logical_and(valid, pos_from_end < vol_lookback)  # the last-N window

    dist = jnp.abs(prices - level[..., None])
    # previous *in-window* distance: shift within the window. The window is
    # contiguous at the tail of the valid region, so the previous window element of
    # slot j is slot j-1 when both are in seq_mask.
    prev_dist = jnp.roll(dist, 1, axis=-1)
    prev_in = jnp.roll(seq_mask, 1, axis=-1)
    is_first = jnp.logical_and(seq_mask, jnp.logical_not(prev_in))
    toward = jnp.logical_and(seq_mask, jnp.logical_or(is_first, dist <= prev_dist))

    def _halves_slope(mask):
        cnt = jnp.sum(mask.astype(jnp.int32), axis=-1)
        k = jnp.maximum(2, cnt // 2)
        # index within the selected subsequence, 0-based in order
        order = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
        first_m = jnp.logical_and(mask, order < k[..., None])
        last_m = jnp.logical_and(mask, order >= (cnt - k)[..., None])
        kf = k.astype(jnp.float32)
        first_avg = jnp.sum(jnp.where(first_m, volumes, 0.0), axis=-1) / kf
        last_avg = jnp.sum(jnp.where(last_m, volumes, 0.0), axis=-1) / kf
        return last_avg - first_avg, cnt

    trend_f, cnt_f = _halves_slope(toward)
    trend_all, _ = _halves_slope(seq_mask)
    trend = jnp.where(cnt_f < min_bars_for_trend, trend_all, trend_f)
    return jnp.where(defined, trend, 0.0), defined


def volume_trend_full_window(
    prices: jnp.ndarray,
    volumes: jnp.ndarray,
    level,
    *,
    min_bars_for_trend: int = 3,
) -> jnp.ndarray:
    """``volume_trend_toward_level`` specialized to a FULL window: the inputs
    are exactly ``vol_lookback`` all-valid bars, oldest→newest (a static slice
    of the newest ring slots).  ``defined`` is statically True, so only the
    trend is returned.

    Bitwise-equal to the general form on the same window: the position
    cumsums fold to iota, ``is_first`` to slot 0, and every f32 sum here has
    at most TWO nonzero terms (``k = max(2, cnt//2) == 2`` for any window of
    ≤5 bars), so dropping the masked zero slots cannot re-associate anything.
    The general form runs [P, RING] reductions over all 32 ring slots every
    bar of the escalation walk."""
    prices = jnp.asarray(prices, jnp.float32)
    volumes = jnp.asarray(volumes, jnp.float32)
    level = jnp.asarray(level, jnp.float32)
    k_win = prices.shape[-1]

    dist = jnp.abs(prices - level[..., None])
    # previous in-window distance: slot j-1; slot 0 is always "first bar kept"
    prev_dist = jnp.roll(dist, 1, axis=-1)
    iota = jnp.arange(k_win)
    is_first = iota == 0
    toward = jnp.logical_or(is_first, dist <= prev_dist)

    def _halves_slope(mask):
        cnt = jnp.sum(mask.astype(jnp.int32), axis=-1)
        k = jnp.maximum(2, cnt // 2)
        order = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
        first_m = jnp.logical_and(mask, order < k[..., None])
        last_m = jnp.logical_and(mask, order >= (cnt - k)[..., None])
        kf = k.astype(jnp.float32)
        first_avg = jnp.sum(jnp.where(first_m, volumes, 0.0), axis=-1) / kf
        last_avg = jnp.sum(jnp.where(last_m, volumes, 0.0), axis=-1) / kf
        return last_avg - first_avg, cnt

    trend_f, cnt_f = _halves_slope(toward)
    # all-window fallback: cnt == k_win, k == 2 → static first/last-2 masks
    kf = jnp.float32(2.0)
    trend_all = (
        jnp.sum(jnp.where(iota >= k_win - 2, volumes, 0.0), axis=-1) / kf
        - jnp.sum(jnp.where(iota < 2, volumes, 0.0), axis=-1) / kf)
    return jnp.where(cnt_f < min_bars_for_trend, trend_all, trend_f)


def infer_approach_full_window(prices: jnp.ndarray, level) -> jnp.ndarray:
    """``infer_approach`` on a full all-valid oldest→newest window (≥2 bars):
    the two newest bars are static slots -1/-2, and the ``n >= 2`` guard is
    statically true."""
    prices = jnp.asarray(prices, jnp.float32)
    level = jnp.asarray(level, jnp.float32)
    p2 = prices[..., -1]
    p1 = prices[..., -2]
    moving_toward = jnp.abs(p2 - level) < jnp.abs(p1 - level)
    approach = jnp.where(p1 > level, 0, 1)  # from_above=0 / from_below=1
    return jnp.where(moving_toward, approach, -1)


def infer_approach(prices: jnp.ndarray, valid: jnp.ndarray, level) -> jnp.ndarray:
    """Planner/_infer_approach (:554-565, :979-991): using the last two prices,
    if |p2-level| < |p1-level| the move is toward the level → "from_above" if
    p1 > level else "from_below".  Returns +1 from_below / 0 from_above / -1 unknown.
    """
    prices = jnp.asarray(prices, jnp.float32)
    level = jnp.asarray(level, jnp.float32)
    n = jnp.sum(valid.astype(jnp.int32), axis=-1)
    pos_from_end = jnp.cumsum(valid[..., ::-1].astype(jnp.int32), axis=-1)[..., ::-1] - 1
    p2 = jnp.sum(jnp.where(pos_from_end == 0, prices, 0.0), axis=-1)
    p1 = jnp.sum(jnp.where(pos_from_end == 1, prices, 0.0), axis=-1)
    moving_toward = jnp.abs(p2 - level) < jnp.abs(p1 - level)
    approach = jnp.where(p1 > level, 0, 1)  # from_above=0 / from_below=1
    return jnp.where(jnp.logical_and(n >= 2, moving_toward), approach, -1)
