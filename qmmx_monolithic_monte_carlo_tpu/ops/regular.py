"""Bar-synchronous guard/touch state for regularly spaced 1-minute bars.

``ops/guard.py`` and ``ops/touch.py`` mirror the reference classes for
ARBITRARY tick/bar timing: ring buffers with write heads, recency ranks via
argsort, time windows via timestamp filters.  Generated paths
(sim/enginepath.py) emit exactly one bar per minute, which collapses all of
that:

* recency rank == ring slot when slot 0 always holds the newest bar (rings
  SHIFT each bar instead of rotating a head — a static concat in XLA);
* the guard's 60-minute window == the newest 61 slots;
* edge taps age monotonically, so an 8-deep per-edge STACK (pushed only when
  a tap fires) answers the fatigue query: the k-th newest tap being inside
  the 30-minute window ⟺ >= k in-window taps exist, and the newest k slots
  ARE the last-k in-window set (for fatigue_hits <= 8).

Every function here is exactness-tested against its ops/guard.py //
ops/touch.py counterpart on regularly-spaced sequences
(tests/test_regular.py), so the scaled engine pipeline inherits the
reference semantics (qmmx_monolithic.py:1241-1356, :1112-1239)
through this layer.  All state arrays carry a leading batch axis [P, ...];
timestamps are ``bar_index * 60_000`` ms.

The volume MAs feeding the touch ratio use the ``_on_minute_close`` formula
(denominator ``max(1, min(k, len))``, ref :1827) — distinct from the guard's
internal window MAs (defined only at >= k bars, :1279-1283).  Both live here.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..types import Levels
from . import guard as G
from . import touch as T

BAR_MS = 60_000

# guard window: (t_end - ts) <= 60 min covers ages 0..60 → 61 bars (:1247)
GUARD_RING = 64
GUARD_WINDOW_BARS = 61

# edge-tap stack: taps push newest-first ONLY when one fires, so slot k-1
# holding an in-window tap ⟺ >= k in-window taps exist (taps age
# monotonically).  Depth 8 supports fatigue_hits <= 8 (reference default 3,
# :1127); it replaced 32-slot one-push-per-bar rings and their per-bar cumsum.
TAP_STACK = 8
TAP_NEVER = -(1 << 30)   # empty-slot timestamp sentinel (never in-window)


def ring_push(ring: jnp.ndarray, new: jnp.ndarray) -> jnp.ndarray:
    """Shift a [..., R] newest-first ring: slot 0 := new, others age by one."""
    return jnp.concatenate([new[..., None], ring[..., :-1]], axis=-1)


def tail_mean_minclose(vol_ring: jnp.ndarray, n_bars, k: int) -> jnp.ndarray:
    """The ``_on_minute_close`` volume MA (ref :1827): mean of the last
    ``min(k, n)`` volumes with denominator ``max(1, min(k, n))``.
    ``vol_ring`` is newest-first [..., R]; ``n_bars`` = bars pushed so far."""
    r = vol_ring.shape[-1]
    slot = jnp.arange(r)
    filled = slot < jnp.minimum(n_bars, r)
    sel = jnp.logical_and(filled, slot < k)
    kk = jnp.maximum(1, jnp.minimum(k, n_bars))
    return jnp.sum(jnp.where(sel, vol_ring, 0.0), axis=-1) / kk.astype(jnp.float32)


# --------------------------------------------------------------------------
# guard (AccumulationBreakoutGuard, qmmx_monolithic.py:1241-1356)
# --------------------------------------------------------------------------

@struct.dataclass
class RegularGuardState:
    """Batched [P, ...] guard state; rings newest-first."""

    high: jnp.ndarray      # f32[P, GUARD_RING]
    low: jnp.ndarray       # f32[P, GUARD_RING]
    close: jnp.ndarray     # f32[P, GUARD_RING]
    volume: jnp.ndarray    # f32[P, GUARD_RING]
    box_low: jnp.ndarray   # f32[P]
    box_high: jnp.ndarray  # f32[P]
    box_valid: jnp.ndarray  # bool[P]
    regime: jnp.ndarray    # i32[P] (G.REGIME_*)
    inside_count: jnp.ndarray  # i32[P]

    @classmethod
    def zeros(cls, p: int) -> "RegularGuardState":
        zf = jnp.zeros((p, GUARD_RING), jnp.float32)
        return cls(
            high=zf, low=zf, close=zf, volume=zf,
            box_low=jnp.zeros((p,), jnp.float32),
            box_high=jnp.zeros((p,), jnp.float32),
            box_valid=jnp.zeros((p,), bool),
            regime=jnp.full((p,), G.REGIME_UNKNOWN, jnp.int32),
            inside_count=jnp.zeros((p,), jnp.int32),
        )


def _regime_update(
    params: G.GuardParams,
    *,
    price_now,             # f32[P] — this bar's close
    box_low_w, box_high_w,  # f32[P] — 60-min window extremes incl. this bar
    vol_ma_s, s_def, vol_ma_l, l_def,  # guard window MAs (:1279-1283)
    n_win,                 # i32 — bars in the window after this push
    box_low, box_high, box_valid, regime, inside_count,  # prior scalars [P]
):
    """_update_state (:1284-1339) on precomputed window stats — the shared
    regime machine body behind ``guard_push`` and ``lean_guard_push``.
    Returns the five updated guard scalars."""
    box_height = box_high_w - box_low_w
    compress_thresh = price_now * (params.compression_bp / 10000.0)
    mas_ok = jnp.logical_and(
        jnp.logical_and(s_def, vol_ma_s != 0.0), jnp.logical_and(l_def, vol_ma_l != 0.0)
    )

    in_breakout = jnp.logical_or(
        regime == G.REGIME_BREAKOUT_UP, regime == G.REGIME_BREAKOUT_DOWN
    )
    compressed = box_height <= jnp.maximum(1e-6, compress_thresh)

    regime = jnp.where(
        compressed,
        jnp.where(in_breakout, regime, G.REGIME_ACCUMULATION),
        jnp.where(in_breakout, regime, G.REGIME_UNKNOWN),
    )
    box_low = jnp.where(compressed, box_low_w, box_low)
    box_high = jnp.where(compressed, box_high_w, box_high)
    box_valid = jnp.logical_or(compressed, box_valid)

    spike = jnp.logical_and(mas_ok, vol_ma_s > params.vol_k * vol_ma_l)
    can_check = jnp.logical_and(box_valid, mas_ok)
    up = jnp.logical_and(can_check, jnp.logical_and(price_now > box_high + 1e-6, spike))
    down = jnp.logical_and(
        can_check,
        jnp.logical_and(jnp.logical_not(up), jnp.logical_and(price_now < box_low - 1e-6, spike)),
    )
    regime = jnp.where(up, G.REGIME_BREAKOUT_UP,
                       jnp.where(down, G.REGIME_BREAKOUT_DOWN, regime))
    inside_count = jnp.where(jnp.logical_or(up, down), 0, inside_count)

    in_breakout2 = jnp.logical_or(
        regime == G.REGIME_BREAKOUT_UP, regime == G.REGIME_BREAKOUT_DOWN
    )
    inside = jnp.logical_and(box_low <= price_now, price_now <= box_high)
    do_track = jnp.logical_and(in_breakout2, box_valid)
    inside_count = jnp.where(
        do_track, jnp.where(inside, inside_count + 1, 0), inside_count
    )
    cleared = jnp.logical_and(
        do_track, jnp.logical_and(inside, inside_count >= params.reenter_clear_bars)
    )
    regime = jnp.where(cleared, G.REGIME_ACCUMULATION, regime)

    too_few = n_win < params.min_bars
    regime = jnp.where(too_few, G.REGIME_UNKNOWN, regime)
    box_valid = jnp.where(too_few, False, box_valid)
    inside_count = jnp.where(too_few, 0, inside_count)
    return box_low, box_high, box_valid, regime, inside_count


def guard_push(
    st: RegularGuardState,
    params: G.GuardParams,
    *,
    bar_index,             # i32 — bars pushed BEFORE this one (0 for the first)
    high, low, close, volume,  # f32[P]
) -> RegularGuardState:
    """push_minute_bar + _update_state (:1268-1339) for 1-min-spaced bars.

    Window/rank logic specializes to slot masks: after this push, bar ages are
    the slot indices, the 60-min window is ``slot < min(61, n)``, and the
    vol-MA "last k" sets are ``slot < k``."""
    h = ring_push(st.high, jnp.asarray(high, jnp.float32))
    l = ring_push(st.low, jnp.asarray(low, jnp.float32))
    c = ring_push(st.close, jnp.asarray(close, jnp.float32))
    v = ring_push(st.volume, jnp.asarray(volume, jnp.float32))
    n = jnp.asarray(bar_index, jnp.int32) + 1          # bars now held

    slot = jnp.arange(GUARD_RING)
    in_win = slot[None, :] < jnp.minimum(n, GUARD_WINDOW_BARS)  # [1, R]
    n_win = jnp.minimum(n, GUARD_WINDOW_BARS)

    price_now = c[..., 0]
    box_low_w = jnp.min(jnp.where(in_win, l, jnp.inf), axis=-1)
    box_high_w = jnp.max(jnp.where(in_win, h, -jnp.inf), axis=-1)

    def win_tail_mean(k):
        # guard-internal MA (:1279-1283): defined only when the window holds
        # >= k bars; mean over exactly k
        sel = jnp.logical_and(in_win, slot[None, :] < k)
        s = jnp.sum(jnp.where(sel, v, 0.0), axis=-1)
        defined = n_win >= k
        return jnp.where(defined, s / jnp.maximum(k, 1).astype(jnp.float32), 0.0), defined

    vol_ma_s, s_def = win_tail_mean(params.vol_short)
    vol_ma_l, l_def = win_tail_mean(params.vol_long)

    box_low, box_high, box_valid, regime, inside_count = _regime_update(
        params, price_now=price_now, box_low_w=box_low_w, box_high_w=box_high_w,
        vol_ma_s=vol_ma_s, s_def=s_def, vol_ma_l=vol_ma_l, l_def=l_def,
        n_win=n_win, box_low=st.box_low, box_high=st.box_high,
        box_valid=st.box_valid, regime=st.regime, inside_count=st.inside_count,
    )
    return RegularGuardState(
        high=h, low=l, close=c, volume=v,
        box_low=box_low, box_high=box_high, box_valid=box_valid,
        regime=regime, inside_count=inside_count,
    )


# --------------------------------------------------------------------------
# lean guard: the windowed form, for the streaming XLA pipeline
# --------------------------------------------------------------------------

@struct.dataclass
class LeanGuardState:
    """Ring-free guard state for the scaled scan pipelines (ROADMAP r5 item 2:
    ``RegularGuardState`` carries 4×64-slot f32 rings ≈ 1 KB/path through every
    scan step; the decisions only need the 60-min window EXTREMES and volume
    MAs the caller's bar ring already holds): running extremes when the
    whole horizon fits inside the window, 61-slot extreme rings otherwise
    (min/max are exactly order-free, so both forms are bitwise the window
    min/max).  ``run_low/run_high`` are f32[P] (running) or
    f32[P, GUARD_WINDOW_BARS] (windowed) — ±inf sentinels are the reduction
    identities, so unfilled slots need no masking."""

    run_low: jnp.ndarray   # f32[P] | f32[P, 61]
    run_high: jnp.ndarray  # f32[P] | f32[P, 61]
    box_low: jnp.ndarray   # f32[P]
    box_high: jnp.ndarray  # f32[P]
    box_valid: jnp.ndarray  # bool[P]
    regime: jnp.ndarray    # i32[P] (G.REGIME_*)
    inside_count: jnp.ndarray  # i32[P]

    @classmethod
    def zeros(cls, p: int, *, windowed: bool) -> "LeanGuardState":
        shape = (p, GUARD_WINDOW_BARS) if windowed else (p,)
        return cls(
            run_low=jnp.full(shape, jnp.inf, jnp.float32),
            run_high=jnp.full(shape, -jnp.inf, jnp.float32),
            box_low=jnp.zeros((p,), jnp.float32),
            box_high=jnp.zeros((p,), jnp.float32),
            box_valid=jnp.zeros((p,), bool),
            regime=jnp.full((p,), G.REGIME_UNKNOWN, jnp.int32),
            inside_count=jnp.zeros((p,), jnp.int32),
        )


def lean_guard_push(
    st: LeanGuardState,
    params: G.GuardParams,
    *,
    bar_index,             # i32 — bars pushed BEFORE this one (0 for the first)
    high, low, close,      # f32[P]
    vol_ring,              # f32[P, R] newest-first, ALREADY holding this bar
) -> LeanGuardState:
    """``guard_push`` without the carried bar rings: extremes from the running
    min/max (or 61-slot extreme rings), volume MAs from the caller's shared
    newest-first volume ring (``ring_v`` in sim/enginepath — slot 0 must
    already hold this bar's volume).

    Bitwise-exact vs ``guard_push`` (tests/test_regular.py) provided the
    guard's vol windows fit the caller's ring (``vol_short``/``vol_long`` <=
    ``vol_ring.shape[-1]``; the reference hardcodes 5/20, :1250): the masked
    sum below zero-pads the ring to GUARD_RING slots, so the summed array —
    and hence XLA's reduction — is elementwise identical to guard_push's.
    Windows wider than the caller's ring would silently under-sum —
    ``sim.enginepath._check_state_envelope`` rejects them at launch."""
    h = jnp.asarray(high, jnp.float32)
    l = jnp.asarray(low, jnp.float32)
    c = jnp.asarray(close, jnp.float32)
    n = jnp.asarray(bar_index, jnp.int32) + 1          # bars now held
    n_win = jnp.minimum(n, GUARD_WINDOW_BARS)

    windowed = st.run_low.ndim == 2
    if windowed:
        run_low = ring_push(st.run_low, l)
        run_high = ring_push(st.run_high, h)
        box_low_w = jnp.min(run_low, axis=-1)
        box_high_w = jnp.max(run_high, axis=-1)
    else:
        run_low = jnp.minimum(st.run_low, l)
        run_high = jnp.maximum(st.run_high, h)
        box_low_w = run_low
        box_high_w = run_high

    r = vol_ring.shape[-1]
    v = (jnp.pad(vol_ring, ((0, 0), (0, GUARD_RING - r)))
         if r < GUARD_RING else vol_ring[..., :GUARD_RING])
    slot = jnp.arange(GUARD_RING)
    in_win = slot[None, :] < n_win

    def win_tail_mean(k):
        sel = jnp.logical_and(in_win, slot[None, :] < k)
        s = jnp.sum(jnp.where(sel, v, 0.0), axis=-1)
        defined = n_win >= k
        return jnp.where(defined, s / jnp.maximum(k, 1).astype(jnp.float32), 0.0), defined

    vol_ma_s, s_def = win_tail_mean(params.vol_short)
    vol_ma_l, l_def = win_tail_mean(params.vol_long)

    box_low, box_high, box_valid, regime, inside_count = _regime_update(
        params, price_now=c, box_low_w=box_low_w, box_high_w=box_high_w,
        vol_ma_s=vol_ma_s, s_def=s_def, vol_ma_l=vol_ma_l, l_def=l_def,
        n_win=n_win, box_low=st.box_low, box_high=st.box_high,
        box_valid=st.box_valid, regime=st.regime, inside_count=st.inside_count,
    )
    return LeanGuardState(
        run_low=run_low, run_high=run_high,
        box_low=box_low, box_high=box_high, box_valid=box_valid,
        regime=regime, inside_count=inside_count,
    )


def guard_allow_trade(regime, side) -> jnp.ndarray:
    """allow_trade (:1345-1356) on a batched regime array."""
    from ..types import SIDE_LONG, SIDE_SHORT

    blocked = jnp.logical_or(
        jnp.logical_and(regime == G.REGIME_BREAKOUT_UP, jnp.asarray(side) == SIDE_SHORT),
        jnp.logical_and(regime == G.REGIME_BREAKOUT_DOWN, jnp.asarray(side) == SIDE_LONG),
    )
    return jnp.logical_not(blocked)


# --------------------------------------------------------------------------
# touch memory (LevelTouchMemory, qmmx_monolithic.py:1112-1239)
# --------------------------------------------------------------------------

@struct.dataclass
class RegularTouchState:
    """Batched [P, ...] LevelTouchMemory; per-edge tap STACKS newest-first,
    shifted only when a tap fires (empty slots hold the TAP_NEVER ts)."""

    count: jnp.ndarray      # i32[P, L, 2]
    last_ts: jnp.ndarray    # i32[P, L, 2]
    last_px: jnp.ndarray    # f32[P, L, 2]
    has_last: jnp.ndarray   # bool[P, L, 2]
    tap_ts: jnp.ndarray     # i32[P, 2, TAP_STACK]
    tap_ratio: jnp.ndarray  # f32[P, 2, TAP_STACK]

    @classmethod
    def zeros(cls, p: int, max_levels: int) -> "RegularTouchState":
        return cls(
            count=jnp.zeros((p, max_levels, 2), jnp.int32),
            last_ts=jnp.zeros((p, max_levels, 2), jnp.int32),
            last_px=jnp.zeros((p, max_levels, 2), jnp.float32),
            has_last=jnp.zeros((p, max_levels, 2), bool),
            tap_ts=jnp.full((p, 2, TAP_STACK), TAP_NEVER, jnp.int32),
            tap_ratio=jnp.zeros((p, 2, TAP_STACK), jnp.float32),
        )

    def reset_box(self, do_reset) -> "RegularTouchState":
        """reset_box (:1154-1156) where ``do_reset`` [P] is True."""
        m = jnp.asarray(do_reset)
        return RegularTouchState(
            count=jnp.where(m[:, None, None], 0, self.count),
            last_ts=jnp.where(m[:, None, None], 0, self.last_ts),
            last_px=jnp.where(m[:, None, None], 0.0, self.last_px),
            has_last=jnp.where(m[:, None, None], False, self.has_last),
            tap_ts=jnp.where(m[:, None, None], TAP_NEVER, self.tap_ts),
            tap_ratio=jnp.where(m[:, None, None], 0.0, self.tap_ratio),
        )


def touch_register(
    st: RegularTouchState,
    params: T.TouchMemoryParams,
    levels: Levels,
    *,
    ts_ms,                  # i32 — this bar's timestamp
    high, low, close,       # f32[P]
    box_low, box_high, box_valid,   # [P]
    vol_ma_s, vol_ma_l,     # f32[P] (minute-close MAs, tail_mean_minclose)
    enabled,                # bool[P] — register only while accumulating
) -> RegularTouchState:
    """register_touch_if_any on one finished bar (:1158-1197), batched.

    The tap rings shift EVERY call (also when ``enabled`` is False or no tap
    lands — the new slot is just invalid), keeping slot index == bar age."""
    c = jnp.asarray(close, jnp.float32)[:, None]          # [P, 1]
    h = jnp.asarray(high, jnp.float32)[:, None]
    l = jnp.asarray(low, jnp.float32)[:, None]
    ts = jnp.asarray(ts_ms, jnp.int32)
    en = jnp.asarray(enabled)

    lr = jnp.round(levels.price * 100.0) / 100.0          # [L]
    lr = jnp.where(levels.valid, lr, jnp.float32(jnp.inf))
    pierced = jnp.logical_and(l - 1e-9 <= lr[None, :], lr[None, :] <= h + 1e-9)
    bps_c = jnp.where(lr[None, :] <= 0, 0.0,
                      jnp.abs(c - lr[None, :]) / lr[None, :] * 1e4)
    near = jnp.logical_or(pierced, bps_c <= params.tol_bps)
    near = jnp.logical_and(near, levels.valid[None, :])

    side_short = c > lr[None, :]                           # [P, L] (:1176)
    side_onehot = jnp.stack(
        [jnp.logical_not(side_short), side_short], axis=-1)  # [P, L, 2]

    # Only the ACTIVE side (short iff c > level) can register this bar, so
    # the de-dup predicates are computed ONCE from the active side's
    # gathered state and scattered back through side_onehot — bitwise the
    # same per-(level, side) transitions as the two-sided [P, L, 2] form
    # (the inactive side's hit is identically false), at half the float
    # work.
    ts_a = jnp.where(side_short, st.last_ts[:, :, 1], st.last_ts[:, :, 0])
    px_a = jnp.where(side_short, st.last_px[:, :, 1], st.last_px[:, :, 0])
    has_a = jnp.where(side_short, st.has_last[:, :, 1], st.has_last[:, :, 0])
    hit_a = jnp.logical_and(near, en[:, None])             # [P, L]
    too_soon = jnp.logical_and(has_a, (ts - ts_a) < params.min_time_gap_ms)
    bps_last = jnp.where(px_a <= 0, 0.0, jnp.abs(c - px_a) / px_a * 1e4)
    too_close = jnp.logical_and(has_a, bps_last < params.min_price_gap_bps)
    counted_a = jnp.logical_and(
        hit_a, jnp.logical_not(jnp.logical_or(too_soon, too_close)))
    counted = jnp.logical_and(counted_a[..., None], side_onehot)  # [P, L, 2]

    count = st.count + counted.astype(jnp.int32)
    last_ts = jnp.where(counted, ts, st.last_ts)
    last_px = jnp.where(counted, c[..., None], st.last_px)
    has_last = jnp.logical_or(st.has_last, counted)

    # edge taps (:1189-1197); ratio from the minute-close MAs
    at_top = jnp.logical_and(jnp.asarray(box_valid),
                             h[:, 0] >= jnp.asarray(box_high, jnp.float32) - 1e-9)
    at_bot = jnp.logical_and(jnp.asarray(box_valid),
                             l[:, 0] <= jnp.asarray(box_low, jnp.float32) + 1e-9)
    at_top = jnp.logical_and(at_top, en)
    at_bot = jnp.logical_and(at_bot, en)
    s_ma = jnp.asarray(vol_ma_s, jnp.float32)
    l_ma = jnp.asarray(vol_ma_l, jnp.float32)
    ratio_ok = jnp.logical_and(jnp.logical_and(s_ma != 0.0, l_ma != 0.0), l_ma > 0)
    ratio = jnp.where(ratio_ok, s_ma / jnp.maximum(l_ma, 1e-30), 1.0)

    # conditional stack push: the stack shifts only on edges that tapped
    # (the old one-shift-per-bar 32-slot ring form cost a per-bar cumsum)
    do_edge = jnp.stack([at_top, at_bot], axis=-1)          # [P, 2]
    new_ts = jnp.broadcast_to(jnp.asarray(ts, jnp.int32), do_edge.shape)
    new_ratio = jnp.broadcast_to(ratio[:, None], do_edge.shape)
    tap_ts = jnp.where(do_edge[..., None],
                       ring_push(st.tap_ts, new_ts), st.tap_ts)
    tap_ratio = jnp.where(do_edge[..., None],
                          ring_push(st.tap_ratio, new_ratio), st.tap_ratio)

    return RegularTouchState(
        count=count, last_ts=last_ts, last_px=last_px, has_last=has_last,
        tap_ts=tap_ts, tap_ratio=tap_ratio,
    )


def edge_fatigued(st: RegularTouchState, params: T.TouchMemoryParams, now_ms) -> jnp.ndarray:
    """edge_fatigued (:1199-1220) → [P] of T.EDGE_TOP/EDGE_BOT/EDGE_NONE.

    Stack slots are newest-first with monotonically aging timestamps, so the
    ``fatigue_hits``-th newest tap (slot k-1) being in-window ⟺ at least k
    in-window taps exist, and slots 0..k-1 ARE the last-k in-window set —
    no per-slot rank cumsum needed.  Requires ``fatigue_hits <= TAP_STACK``
    (8; the reference default is 3, :1127) — a larger k never fatigues,
    which is why ``sim.enginepath._check_state_envelope`` rejects it at
    launch (the old 32-slot ring form supported up to 31)."""
    now = jnp.asarray(now_ms, jnp.int32)
    try:
        # static-k fast path: with a concrete
        # fatigue_hits — always true outside jit; the reference pins 3 — the
        # kth-newest in-window test is ONE [P, 2] compare on slot k-1 and
        # the last-k mean a static slice sum, instead of [P, 2, TAP_STACK]
        # one-hot reductions.  Bitwise: the masked sum padded
        # zeros beyond slot k-1; dropping exact +0.0 terms changes nothing.
        ks = int(params.fatigue_hits)
        kth_in = st.tap_ts[:, :, ks - 1] >= now - params.fatigue_window_ms
        ssum = st.tap_ratio[:, :, 0]
        for j in range(1, ks):
            ssum = ssum + st.tap_ratio[:, :, j]
        avg = ssum / jnp.float32(max(ks, 1))
    except TypeError:   # traced fatigue_hits — dynamic fallback
        k = jnp.asarray(params.fatigue_hits, jnp.int32)
        slot = jnp.arange(TAP_STACK)[None, None, :]
        in_win = st.tap_ts >= now - params.fatigue_window_ms     # [P, 2, S]
        kth_in = jnp.sum(
            jnp.where(jnp.logical_and(slot == k - 1, in_win), 1, 0),
            axis=-1) > 0
        lastk = slot < k
        avg = jnp.sum(jnp.where(lastk, st.tap_ratio, 0.0),
                      axis=-1) / jnp.maximum(k, 1).astype(jnp.float32)
    fatigued = jnp.logical_and(kth_in, avg >= params.fatigue_vol_k)  # [P, 2]
    return jnp.where(fatigued[:, 0], T.EDGE_TOP,
                     jnp.where(fatigued[:, 1], T.EDGE_BOT, T.EDGE_NONE)).astype(jnp.int32)


def touch_allow(
    st: RegularTouchState,
    params: T.TouchMemoryParams,
    level_idx,   # i32[P]
    side,        # i32[P] (T.TM_LONG / T.TM_SHORT)
    now_ms,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """allow_trade_at (:1222-1239), batched select over (level, side).

    One-hot masked reductions instead of ``st.count[arange(P), idx, side]``,
    a per-path advanced-indexing gather (the slow form where this pipeline was
    first tuned; not yet measured on a GPU).  Integer/bool sums over a one-hot
    mask are bitwise the gathered element.

    Requires ``level_idx`` in [0, L) and ``side`` in {0, 1}: an out-of-range
    index selects NOTHING (cnt=0, has=False → trade allowed), where a gather
    would have clamped to the last element.  Every current caller gets idx
    from ``nearest_level`` (always in-range); do not rely on clamp semantics
    here."""
    l = st.count.shape[1]
    # side first ([P, L] selects), then the level one-hot — halves the
    # reduction work vs the [P, L, 2] form (integer/bool sums are
    # order-exact, so this is bitwise-free)
    short = jnp.asarray(side, jnp.int32)[:, None] == 1          # [P, 1]
    cnt_s = jnp.where(short, st.count[:, :, 1], st.count[:, :, 0])
    ts_s = jnp.where(short, st.last_ts[:, :, 1], st.last_ts[:, :, 0])
    has_s = jnp.where(short, st.has_last[:, :, 1], st.has_last[:, :, 0])
    sel = (jnp.arange(l, dtype=jnp.int32)[None, :]
           == jnp.asarray(level_idx, jnp.int32)[:, None])       # [P, L]
    cnt = jnp.sum(jnp.where(sel, cnt_s, 0), axis=1)
    last_ts = jnp.sum(jnp.where(sel, ts_s, 0), axis=1)
    has = jnp.any(jnp.logical_and(sel, has_s), axis=1)
    budget_blocked = cnt >= params.max_bounces
    cooldown_blocked = jnp.logical_and(
        has, (jnp.asarray(now_ms, jnp.int32) - last_ts) < params.min_time_gap_ms
    )
    allowed = jnp.logical_not(jnp.logical_or(budget_blocked, cooldown_blocked))
    mult = jnp.where(allowed, params.decay ** cnt.astype(jnp.float32), 1.0)
    return allowed, budget_blocked, mult
