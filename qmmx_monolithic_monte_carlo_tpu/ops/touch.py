"""Touch tracking as fixed-shape array state.

Two distinct mechanisms exist in the reference and are kept separate here:

* **Engine contact latch + touch counts** (qmmx_monolithic.py:1557-1587):
  ``state.level_touch_counts`` keyed by (color, type, index) plus a per-level
  boolean ``_contact_latch``; a new touch is counted on the first tick a level is
  entered, the latch releases when price leaves the window, and latches of *other*
  levels release when price drifts beyond CONTACT_PROX of them.

* **LevelTouchMemory** (:1112-1239): per (rounded level, side) counts with
  time/price de-dup, bounce budget, per-level cooldown, decay multiplier and edge
  fatigue, active only while the AccumulationBreakoutGuard regime is
  "accumulation".

Both become per-level arrays inside the scan carry (SURVEY.md §7 hard-parts).
COMPAT NOTE: the reference keys LevelTouchMemory by ``round(price, 2)`` so two
levels that round to the same cent share a dict entry; the rebuild keys by level
slot index, which differs only in that aliasing corner (documented, not replicated).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import struct

from ..types import Levels
from ..utils import tracectx

# sides for LevelTouchMemory arrays
TM_LONG = 0
TM_SHORT = 1

EDGE_NONE = 0
EDGE_TOP = 1
EDGE_BOT = 2

# ring capacity for edge taps per edge; the 30-min fatigue window at 1 bar/min
# holds <= 31 taps per edge, 64 gives slack (reference deque maxlen=1000, :1144).
EDGE_RING = 64


@struct.dataclass
class ContactState:
    """Engine touch latch/counters, one slot per Levels slot."""

    touch_counts: jnp.ndarray  # i32[L]
    latch: jnp.ndarray         # bool[L]

    @classmethod
    def zeros(cls, max_levels: int) -> "ContactState":
        return cls(
            touch_counts=jnp.zeros((max_levels,), jnp.int32),
            latch=jnp.zeros((max_levels,), bool),
        )


def update_contact(
    state: ContactState, levels: Levels, price, nearest_idx, contact_prox
) -> tuple[ContactState, jnp.ndarray]:
    """Reference latch logic (:1557-1576). Returns (new_state, touch_count of the
    nearest level AFTER the latch update)."""
    price = jnp.asarray(price, jnp.float32)
    dist_all = jnp.abs(levels.price - price)
    is_nearest = jnp.arange(levels.max_levels) == nearest_idx
    # evaluate_entry only reaches here when dist <= prox, so "inside" is True for
    # the nearest level; keep the general form for reuse.
    inside_nearest = dist_all <= contact_prox

    new_touch = jnp.logical_and(
        is_nearest, jnp.logical_and(inside_nearest, jnp.logical_not(state.latch))
    )
    counts = state.touch_counts + new_touch.astype(jnp.int32)

    # nearest latch := inside; other latched levels release when beyond prox
    # (:1567-1576). Unlatched others stay unlatched.
    latch = jnp.where(
        is_nearest,
        inside_nearest,
        jnp.logical_and(state.latch, dist_all <= contact_prox),
    )
    latch = jnp.logical_and(latch, levels.valid)
    tc = counts[nearest_idx]
    return ContactState(touch_counts=counts, latch=latch), tc


@struct.dataclass
class TouchMemoryParams:
    tol_bps: jnp.ndarray            # 8.0 (:1122)
    min_time_gap_ms: jnp.ndarray    # 180_000 (:1123)
    min_price_gap_bps: jnp.ndarray  # 4.0 (:1124)
    decay: jnp.ndarray              # 0.85 (:1125)
    max_bounces: jnp.ndarray        # 2 (:1126)
    fatigue_hits: jnp.ndarray       # 3 (:1127)
    fatigue_window_ms: jnp.ndarray  # 30*60_000 (:1128)
    fatigue_vol_k: jnp.ndarray      # 1.20 (:1129)

    @classmethod
    def default(cls) -> "TouchMemoryParams":
        # cached singleton per default backend (eager scalar creation
        # dispatches one op per scalar; see ops/guard.GuardParams.default);
        # never cached under a trace (utils/tracectx)
        if not tracectx.eager():
            return _build_default_touch()
        return _default_touch_params(jax.default_backend())


@functools.lru_cache(maxsize=None)
def _default_touch_params(backend: str) -> "TouchMemoryParams":
    return _build_default_touch()


def _build_default_touch() -> "TouchMemoryParams":
    return TouchMemoryParams(
        tol_bps=jnp.float32(8.0),
        min_time_gap_ms=jnp.int32(180_000),
        min_price_gap_bps=jnp.float32(4.0),
        decay=jnp.float32(0.85),
        max_bounces=jnp.int32(2),
        fatigue_hits=jnp.int32(3),
        fatigue_window_ms=jnp.int32(30 * 60_000),
        fatigue_vol_k=jnp.float32(1.20),
    )


@struct.dataclass
class TouchMemoryState:
    """Per-(level, side) touch records + per-edge tap rings."""

    count: jnp.ndarray        # i32[L, 2]
    last_ts: jnp.ndarray      # i32[L, 2] (relative ms; valid only where has_last)
    last_px: jnp.ndarray      # f32[L, 2]
    has_last: jnp.ndarray     # bool[L, 2]
    # edge tap rings: [2 edges(top=0,bot=1), EDGE_RING] of (ts, ratio) + write head
    tap_ts: jnp.ndarray       # i32[2, EDGE_RING]
    tap_ratio: jnp.ndarray    # f32[2, EDGE_RING]
    tap_valid: jnp.ndarray    # bool[2, EDGE_RING]
    tap_head: jnp.ndarray     # i32[2]

    @classmethod
    def zeros(cls, max_levels: int) -> "TouchMemoryState":
        return cls(
            count=jnp.zeros((max_levels, 2), jnp.int32),
            last_ts=jnp.zeros((max_levels, 2), jnp.int32),
            last_px=jnp.zeros((max_levels, 2), jnp.float32),
            has_last=jnp.zeros((max_levels, 2), bool),
            tap_ts=jnp.zeros((2, EDGE_RING), jnp.int32),
            tap_ratio=jnp.zeros((2, EDGE_RING), jnp.float32),
            tap_valid=jnp.zeros((2, EDGE_RING), bool),
            tap_head=jnp.zeros((2,), jnp.int32),
        )

    def reset_box(self) -> "TouchMemoryState":
        """LevelTouchMemory.reset_box (:1154-1156)."""
        return TouchMemoryState.zeros(self.count.shape[0])


def _bps(px, ref):
    """Basis-points distance (:1146-1148)."""
    ref = jnp.asarray(ref, jnp.float32)
    return jnp.where(ref <= 0, 0.0, jnp.abs(jnp.asarray(px, jnp.float32) - ref) / ref * 1e4)


def register_touch_bar(
    state: TouchMemoryState,
    params: TouchMemoryParams,
    levels: Levels,
    *,
    ts_ms,
    high,
    low,
    close,
    box_low,
    box_high,
    box_valid,      # bool: both edges known
    vol_ma_s,
    vol_ma_l,
) -> TouchMemoryState:
    """LevelTouchMemory.register_touch_if_any on one finished minute bar
    (:1158-1197), vectorized over all level slots."""
    c = jnp.asarray(close, jnp.float32)
    h = jnp.asarray(high, jnp.float32)
    l = jnp.asarray(low, jnp.float32)
    ts = jnp.asarray(ts_ms, jnp.int32)
    # reference rounds the level to cents for keying; use the rounded price for the
    # near test exactly as :1169-1171 does with Lr.
    lr = jnp.round(levels.price * 100.0) / 100.0
    pierced = jnp.logical_and(l - 1e-9 <= lr, lr <= h + 1e-9)
    near = jnp.logical_or(pierced, _bps(c, lr) <= params.tol_bps)
    near = jnp.logical_and(near, levels.valid)

    side = jnp.where(c > lr, TM_SHORT, TM_LONG)  # :1176
    side_onehot = jnp.stack([side == TM_LONG, side == TM_SHORT], axis=-1)  # [L,2]
    hit = jnp.logical_and(near[:, None], side_onehot)

    # de-dup (:1179-1184): skip if too soon or too close in price to last touch
    too_soon = jnp.logical_and(state.has_last, (ts - state.last_ts) < params.min_time_gap_ms)
    too_close = jnp.logical_and(
        state.has_last, _bps(c, state.last_px) < params.min_price_gap_bps
    )
    counted = jnp.logical_and(hit, jnp.logical_not(jnp.logical_or(too_soon, too_close)))

    count = state.count + counted.astype(jnp.int32)
    last_ts = jnp.where(counted, ts, state.last_ts)
    last_px = jnp.where(counted, c, state.last_px)
    has_last = jnp.logical_or(state.has_last, counted)

    # edge tap logging (:1189-1197)
    at_top = jnp.logical_and(box_valid, h >= jnp.asarray(box_high, jnp.float32) - 1e-9)
    at_bot = jnp.logical_and(box_valid, l <= jnp.asarray(box_low, jnp.float32) + 1e-9)
    ratio_ok = jnp.logical_and(
        jnp.logical_and(jnp.asarray(vol_ma_s) != 0.0, jnp.asarray(vol_ma_l) != 0.0),
        jnp.asarray(vol_ma_l) > 0,
    )
    ratio = jnp.where(ratio_ok, jnp.asarray(vol_ma_s, jnp.float32) /
                      jnp.maximum(jnp.asarray(vol_ma_l, jnp.float32), 1e-30), 1.0)

    def _push(tap_ts, tap_ratio, tap_valid, head, do, edge_idx):
        pos = head[edge_idx] % EDGE_RING
        tap_ts = tap_ts.at[edge_idx, pos].set(jnp.where(do, ts, tap_ts[edge_idx, pos]))
        tap_ratio = tap_ratio.at[edge_idx, pos].set(
            jnp.where(do, ratio, tap_ratio[edge_idx, pos])
        )
        tap_valid = tap_valid.at[edge_idx, pos].set(
            jnp.logical_or(do, tap_valid[edge_idx, pos])
        )
        head = head.at[edge_idx].add(do.astype(jnp.int32))
        return tap_ts, tap_ratio, tap_valid, head

    tap_ts, tap_ratio, tap_valid, tap_head = state.tap_ts, state.tap_ratio, state.tap_valid, state.tap_head
    tap_ts, tap_ratio, tap_valid, tap_head = _push(tap_ts, tap_ratio, tap_valid, tap_head, at_top, 0)
    tap_ts, tap_ratio, tap_valid, tap_head = _push(tap_ts, tap_ratio, tap_valid, tap_head, at_bot, 1)

    return TouchMemoryState(
        count=count, last_ts=last_ts, last_px=last_px, has_last=has_last,
        tap_ts=tap_ts, tap_ratio=tap_ratio, tap_valid=tap_valid, tap_head=tap_head,
    )


def edge_fatigued(state: TouchMemoryState, params: TouchMemoryParams, now_ms) -> jnp.ndarray:
    """LevelTouchMemory.edge_fatigued (:1199-1220) → EDGE_TOP / EDGE_BOT / EDGE_NONE.

    Per edge: taps with ts >= now - window; fatigued if at least ``fatigue_hits``
    such taps exist and the mean ratio of the **last** ``fatigue_hits`` of them is
    >= fatigue_vol_k.  Top takes precedence (checked first, :1216-1219).
    """
    now = jnp.asarray(now_ms, jnp.int32)
    in_win = jnp.logical_and(state.tap_valid, state.tap_ts >= now - params.fatigue_window_ms)  # [2,R]

    # Ring order: entries were written at head positions 0..head-1 (mod R). Compute
    # each slot's age rank among in-window taps: we need the last `fatigue_hits` by
    # insertion order. Insertion order index of slot j for edge e is recoverable
    # because heads only grow: slot j holds insertion number (head - 1 - ((head - 1 - j) mod R))
    # ... simpler: rank by ts (monotone non-decreasing inserts), stable tie-break by
    # recency of write = distance behind head.
    R = EDGE_RING
    slots = jnp.arange(R)[None, :]
    head = state.tap_head[:, None]
    # distance behind head: 0 = most recently written
    behind = (head - 1 - slots) % R
    # most recent K in-window taps: among in_win, smallest `behind`
    big = R + 1
    order = jnp.where(in_win, behind, big)
    k = params.fatigue_hits
    # rank of each slot among in-window taps by recency (0 = newest)
    rank = jnp.argsort(jnp.argsort(order, axis=-1), axis=-1)
    lastk = jnp.logical_and(in_win, rank < k)
    n_in = jnp.sum(in_win.astype(jnp.int32), axis=-1)
    avg = jnp.sum(jnp.where(lastk, state.tap_ratio, 0.0), axis=-1) / jnp.maximum(
        jnp.sum(lastk.astype(jnp.int32), axis=-1), 1
    ).astype(jnp.float32)
    fatigued = jnp.logical_and(n_in >= k, avg >= params.fatigue_vol_k)  # [2]
    return jnp.where(fatigued[0], EDGE_TOP, jnp.where(fatigued[1], EDGE_BOT, EDGE_NONE))


def allow_trade_at(
    state: TouchMemoryState,
    params: TouchMemoryParams,
    level_idx,
    side,        # TM_LONG / TM_SHORT
    now_ms,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """LevelTouchMemory.allow_trade_at (:1222-1239).

    Returns (allowed, blocked_reason_is_budget, conf_multiplier). The reference
    returns free-text reasons; we expose budget-vs-cooldown as a bool for the
    reason mapping (Reason.TOUCH_BUDGET / TOUCH_COOLDOWN).
    """
    side = jnp.asarray(side)
    cnt = state.count[level_idx, side]
    last_ts = state.last_ts[level_idx, side]
    has = state.has_last[level_idx, side]
    budget_blocked = cnt >= params.max_bounces
    cooldown_blocked = jnp.logical_and(
        has, (jnp.asarray(now_ms, jnp.int32) - last_ts) < params.min_time_gap_ms
    )
    allowed = jnp.logical_not(jnp.logical_or(budget_blocked, cooldown_blocked))
    mult = jnp.where(allowed, params.decay ** cnt.astype(jnp.float32), 1.0)
    return allowed, budget_blocked, mult
