"""AccumulationBreakoutGuard as a pure, scan-able state machine.

Re-expression of the reference class (qmmx_monolithic.py:1241-1356): detects a
compressed accumulation box over the last 60 minutes of bars, confirms breakouts
with a 5/20 volume-MA spike, clears the regime after 3 bars back inside the box,
and gates counter-trend entries.  The 600-bar deque becomes a fixed ring buffer in
the carry; the 60-minute window is a mask over the ring.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import struct

from ..types import SIDE_LONG, SIDE_SHORT
from ..utils import tracectx

REGIME_UNKNOWN = 0
REGIME_ACCUMULATION = 1
REGIME_BREAKOUT_UP = 2
REGIME_BREAKOUT_DOWN = 3

# 60-minute window at 1 bar/min holds <= 61 bars; 128 gives headroom for irregular
# bar spacing (reference deque maxlen=600 at :1253, but only the last hour is read).
GUARD_RING = 128


@struct.dataclass
class GuardParams:
    box_lookback_ms: jnp.ndarray   # 60 min (:1247)
    min_bars: jnp.ndarray          # 30 (:1248)
    compression_bp: jnp.ndarray    # 18 (:1249)
    vol_short: jnp.ndarray         # 5 (:1250)
    vol_long: jnp.ndarray          # 20 (:1250)
    vol_k: jnp.ndarray             # 1.40 (:1251)
    reenter_clear_bars: jnp.ndarray  # 3 (:1252)

    @classmethod
    def default(cls) -> "GuardParams":
        # cached singleton (per default backend): eager jnp scalar creation
        # dispatches one device op per scalar, and the hot MC wrappers
        # construct defaults per launch.  Whether the cache still pays on a
        # GPU is not measured yet.
        # NEVER cache under a trace (tracers would leak; utils/tracectx)
        if not tracectx.eager():
            return _build_default_guard()
        return _default_guard_params(jax.default_backend())


def _build_default_guard() -> "GuardParams":
    return GuardParams(
        box_lookback_ms=jnp.int32(60 * 60_000),
        min_bars=jnp.int32(30),
        compression_bp=jnp.float32(18.0),
        vol_short=jnp.int32(5),
        vol_long=jnp.int32(20),
        vol_k=jnp.float32(1.40),
        reenter_clear_bars=jnp.int32(3),
    )


@functools.lru_cache(maxsize=None)
def _default_guard_params(backend: str) -> "GuardParams":
    return _build_default_guard()


@struct.dataclass
class GuardState:
    # bar ring (ts, high, low, close, volume); head = number of bars ever pushed
    ts: jnp.ndarray       # i32[R]
    high: jnp.ndarray     # f32[R]
    low: jnp.ndarray      # f32[R]
    close: jnp.ndarray    # f32[R]
    volume: jnp.ndarray   # f32[R]
    valid: jnp.ndarray    # bool[R]
    head: jnp.ndarray     # i32

    box_low: jnp.ndarray     # f32
    box_high: jnp.ndarray    # f32
    box_valid: jnp.ndarray   # bool
    box_ts0: jnp.ndarray     # i32
    box_ts0_valid: jnp.ndarray  # bool
    regime: jnp.ndarray      # i32
    inside_count: jnp.ndarray  # i32

    @classmethod
    def zeros(cls) -> "GuardState":
        r = GUARD_RING
        return cls(
            ts=jnp.zeros((r,), jnp.int32),
            high=jnp.zeros((r,), jnp.float32),
            low=jnp.zeros((r,), jnp.float32),
            close=jnp.zeros((r,), jnp.float32),
            volume=jnp.zeros((r,), jnp.float32),
            valid=jnp.zeros((r,), bool),
            head=jnp.int32(0),
            box_low=jnp.float32(0.0),
            box_high=jnp.float32(0.0),
            box_valid=jnp.asarray(False),
            box_ts0=jnp.int32(0),
            box_ts0_valid=jnp.asarray(False),
            regime=jnp.int32(REGIME_UNKNOWN),
            inside_count=jnp.int32(0),
        )


def _masked_tail_mean(vals, mask, behind, n):
    """Mean of the last ``n`` masked values (behind = recency rank, 0 = newest).
    Returns (mean, defined) where defined requires at least n values (:1279-1283)."""
    count = jnp.sum(mask.astype(jnp.int32))
    sel = jnp.logical_and(mask, behind < n)
    s = jnp.sum(jnp.where(sel, vals, 0.0))
    defined = count >= n
    return jnp.where(defined, s / jnp.maximum(n, 1).astype(jnp.float32), 0.0), defined


def push_minute_bar(
    state: GuardState, params: GuardParams, *, ts_ms, high, low, close, volume
) -> GuardState:
    """push_minute_bar + _update_state (:1268-1339)."""
    pos = state.head % GUARD_RING
    st = state.replace(
        ts=state.ts.at[pos].set(jnp.asarray(ts_ms, jnp.int32)),
        high=state.high.at[pos].set(jnp.asarray(high, jnp.float32)),
        low=state.low.at[pos].set(jnp.asarray(low, jnp.float32)),
        close=state.close.at[pos].set(jnp.asarray(close, jnp.float32)),
        volume=state.volume.at[pos].set(jnp.asarray(volume, jnp.float32)),
        valid=state.valid.at[pos].set(True),
        head=state.head + 1,
    )
    return _update_state(st, params)


def _update_state(st: GuardState, params: GuardParams) -> GuardState:
    t_end = st.ts[(st.head - 1) % GUARD_RING]
    in_window = jnp.logical_and(st.valid, (t_end - st.ts) <= params.box_lookback_ms)
    n_win = jnp.sum(in_window.astype(jnp.int32))

    slots = jnp.arange(GUARD_RING)
    behind_raw = (st.head - 1 - slots) % GUARD_RING
    big = GUARD_RING + 1
    behind_in = jnp.where(in_window, behind_raw, big)
    # recency rank among in-window bars (0 = newest)
    rank = jnp.argsort(jnp.argsort(behind_in))

    price_now = st.close[(st.head - 1) % GUARD_RING]
    box_low_w = jnp.min(jnp.where(in_window, st.low, jnp.inf))
    box_high_w = jnp.max(jnp.where(in_window, st.high, -jnp.inf))
    box_height = box_high_w - box_low_w
    compress_thresh = price_now * (params.compression_bp / 10000.0)

    vol_ma_s, s_def = _masked_tail_mean(st.volume, in_window, rank, params.vol_short)
    vol_ma_l, l_def = _masked_tail_mean(st.volume, in_window, rank, params.vol_long)
    # reference truthiness: `vol_ma_s and vol_ma_l` (:1322) is False when either is
    # None OR == 0.0
    mas_ok = jnp.logical_and(
        jnp.logical_and(s_def, vol_ma_s != 0.0), jnp.logical_and(l_def, vol_ma_l != 0.0)
    )

    in_breakout = jnp.logical_or(
        st.regime == REGIME_BREAKOUT_UP, st.regime == REGIME_BREAKOUT_DOWN
    )
    compressed = box_height <= jnp.maximum(1e-6, compress_thresh)

    # establish/maintain the box (:1308-1319)
    regime = jnp.where(
        compressed,
        jnp.where(in_breakout, st.regime, REGIME_ACCUMULATION),
        jnp.where(in_breakout, st.regime, REGIME_UNKNOWN),
    )
    box_low = jnp.where(compressed, box_low_w, st.box_low)
    box_high = jnp.where(compressed, box_high_w, st.box_high)
    box_valid = jnp.logical_or(compressed, st.box_valid)
    # first-window timestamp: oldest in-window bar (:1314-1315 uses window[0][0])
    oldest_rank = n_win - 1
    ts0_w = jnp.sum(jnp.where(rank == oldest_rank, st.ts, 0))
    set_ts0 = jnp.logical_and(compressed, jnp.logical_not(st.box_ts0_valid))
    box_ts0 = jnp.where(set_ts0, ts0_w, st.box_ts0)
    box_ts0_valid = jnp.logical_or(st.box_ts0_valid, set_ts0)

    # breakout confirmation (:1322-1330)
    spike = jnp.logical_and(mas_ok, vol_ma_s > params.vol_k * vol_ma_l)
    can_check = jnp.logical_and(box_valid, mas_ok)
    up = jnp.logical_and(can_check, jnp.logical_and(price_now > box_high + 1e-6, spike))
    down = jnp.logical_and(
        can_check,
        jnp.logical_and(jnp.logical_not(up), jnp.logical_and(price_now < box_low - 1e-6, spike)),
    )
    regime = jnp.where(up, REGIME_BREAKOUT_UP, jnp.where(down, REGIME_BREAKOUT_DOWN, regime))
    inside_count = jnp.where(jnp.logical_or(up, down), 0, st.inside_count)

    # regime clear after re-entry (:1333-1339)
    in_breakout2 = jnp.logical_or(
        regime == REGIME_BREAKOUT_UP, regime == REGIME_BREAKOUT_DOWN
    )
    inside = jnp.logical_and(box_low <= price_now, price_now <= box_high)
    do_track = jnp.logical_and(in_breakout2, box_valid)
    inside_count = jnp.where(
        do_track, jnp.where(inside, inside_count + 1, 0), inside_count
    )
    cleared = jnp.logical_and(
        do_track, jnp.logical_and(inside, inside_count >= params.reenter_clear_bars)
    )
    regime = jnp.where(cleared, REGIME_ACCUMULATION, regime)

    # too-few-bars reset (:1287-1291) — overrides everything
    too_few = n_win < params.min_bars
    regime = jnp.where(too_few, REGIME_UNKNOWN, regime)
    box_valid = jnp.where(too_few, False, box_valid)
    box_ts0_valid = jnp.where(too_few, False, box_ts0_valid)
    inside_count = jnp.where(too_few, 0, inside_count)

    return st.replace(
        box_low=box_low,
        box_high=box_high,
        box_valid=box_valid,
        box_ts0=box_ts0,
        box_ts0_valid=box_ts0_valid,
        regime=regime,
        inside_count=inside_count,
    )


def allow_trade(state: GuardState, side) -> jnp.ndarray:
    """allow_trade (:1345-1356): breakout_up blocks SHORT, breakout_down blocks LONG."""
    side = jnp.asarray(side)
    blocked = jnp.logical_or(
        jnp.logical_and(state.regime == REGIME_BREAKOUT_UP, side == SIDE_SHORT),
        jnp.logical_and(state.regime == REGIME_BREAKOUT_DOWN, side == SIDE_LONG),
    )
    return jnp.logical_not(blocked)
