"""Engine carry state pytrees.

The reference scatters mutable state across ``EngineState`` (qmmx_monolithic.py:259-270),
``MonolithicEngine`` attributes (``_contact_latch`` :1376, ``recent_bars`` :1367,
``_cur_bar`` :1872), ``LevelTouchMemory`` and ``AccumulationBreakoutGuard`` instances.
The rebuild gathers all of it into one immutable pytree threaded through
``lax.scan`` — simulation can fork it freely (fixing quirk Q7: sims no longer
mutate live state).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops.guard import GuardState
from ..ops.touch import ContactState, TouchMemoryState
from ..types import DIR_UNKNOWN, SIDE_FLAT
from ..utils import tracectx

# recent_bars buffer length (reference trims to 240, :1822)
RECENT_BARS = 240


@struct.dataclass
class BarRing:
    """Ring of recent minute bars (close, volume, ts) — the engine's
    ``recent_bars`` (:1821-1823) as a fixed ring."""

    ts_ms: jnp.ndarray   # i32[N]
    close: jnp.ndarray   # f32[N]
    volume: jnp.ndarray  # f32[N]
    head: jnp.ndarray    # i32 — total pushes

    @classmethod
    def zeros(cls, size: int = RECENT_BARS) -> "BarRing":
        return cls(
            ts_ms=jnp.zeros((size,), jnp.int32),
            close=jnp.zeros((size,), jnp.float32),
            volume=jnp.zeros((size,), jnp.float32),
            head=jnp.int32(0),
        )

    @property
    def size(self) -> int:
        return self.close.shape[0]

    def push(self, ts_ms, close, volume) -> "BarRing":
        pos = self.head % self.size
        return self.replace(
            ts_ms=self.ts_ms.at[pos].set(jnp.asarray(ts_ms, jnp.int32)),
            close=self.close.at[pos].set(jnp.asarray(close, jnp.float32)),
            volume=self.volume.at[pos].set(jnp.asarray(volume, jnp.float32)),
            head=self.head + 1,
        )

    def ordered(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(close, volume, valid) as oldest→newest contiguous views with the newest
        bar in the last slot and leading padding masked invalid."""
        n = self.size
        i = jnp.arange(n)
        m = jnp.minimum(self.head, n)      # bars actually held
        valid = i >= (n - m)
        idx_full = (self.head + i) % n      # ring wrapped: oldest at head%n
        idx_partial = jnp.clip(i - (n - m), 0, n - 1)
        take = jnp.where(self.head >= n, idx_full, idx_partial)
        return self.close[take], self.volume[take], valid


@struct.dataclass
class CurrentBar:
    """In-progress 1-minute OHLCV bucket (reference ``_cur_bar``, :1864-1883)."""

    minute: jnp.ndarray   # i32 minute bucket id
    ts0_ms: jnp.ndarray   # i32 minute start
    open: jnp.ndarray
    high: jnp.ndarray
    low: jnp.ndarray
    close: jnp.ndarray
    volume: jnp.ndarray
    active: jnp.ndarray   # bool

    @classmethod
    def empty(cls) -> "CurrentBar":
        z = jnp.float32(0.0)
        return cls(
            minute=jnp.int32(-1), ts0_ms=jnp.int32(0),
            open=z, high=z, low=z, close=z, volume=z,
            active=jnp.asarray(False),
        )


@struct.dataclass
class Position:
    """The single open trade (reference holds one at a time, :3246-3278).

    ``risk0`` is the |entry − stop| distance AT OPEN: escalation trails the
    stop toward the entry (exits.py:139-144), so R bookkeeping normalizes by
    the initial risk — dividing by the trailed stop distance would let one
    escalated winner print R in the thousands.  0 means "unset" (legacy
    constructors); consumers fall back to the live stop distance."""

    side: jnp.ndarray       # i32: SIDE_LONG/SIDE_SHORT/SIDE_FLAT
    entry: jnp.ndarray      # f32
    stop: jnp.ndarray       # f32
    target: jnp.ndarray     # f32
    open_ts_ms: jnp.ndarray  # i32
    risk0: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(0.0))

    @classmethod
    def flat(cls) -> "Position":
        z = jnp.float32(0.0)
        return cls(side=jnp.int32(SIDE_FLAT), entry=z, stop=z, target=z,
                   open_ts_ms=jnp.int32(0), risk0=z)

    @property
    def is_open(self) -> jnp.ndarray:
        return self.side != SIDE_FLAT


@struct.dataclass
class EngineCarry:
    """Everything ``evaluate_entry`` + the lifecycle read or write."""

    last_price: jnp.ndarray        # f32
    last_price_valid: jnp.ndarray  # bool
    last_ts_ms: jnp.ndarray        # i32
    last_ts_valid: jnp.ndarray     # bool
    cooldown_until_ms: jnp.ndarray  # i32
    last_direction: jnp.ndarray    # i32 DIR_*
    position: Position
    contact: ContactState
    touchmem: TouchMemoryState
    guard: GuardState
    bars: BarRing
    cur_bar: CurrentBar
    # running portfolio stats for the lifecycle scan
    realized_pnl: jnp.ndarray      # f32
    equity_r: jnp.ndarray          # f32 cumulative R
    peak_r: jnp.ndarray            # f32
    max_dd_r: jnp.ndarray          # f32 (negative)
    wins: jnp.ndarray              # i32
    losses: jnp.ndarray            # i32

    @classmethod
    def init(cls, max_levels: int, bar_ring: int = RECENT_BARS) -> "EngineCarry":
        return cls(
            last_price=jnp.float32(0.0),
            last_price_valid=jnp.asarray(False),
            last_ts_ms=jnp.int32(0),
            last_ts_valid=jnp.asarray(False),
            cooldown_until_ms=jnp.int32(0),
            last_direction=jnp.int32(DIR_UNKNOWN),
            position=Position.flat(),
            contact=ContactState.zeros(max_levels),
            touchmem=TouchMemoryState.zeros(max_levels),
            guard=GuardState.zeros(),
            bars=BarRing.zeros(bar_ring),
            cur_bar=CurrentBar.empty(),
            realized_pnl=jnp.float32(0.0),
            equity_r=jnp.float32(0.0),
            peak_r=jnp.float32(0.0),
            max_dd_r=jnp.float32(0.0),
            wins=jnp.int32(0),
            losses=jnp.int32(0),
        )


@struct.dataclass
class MlModel:
    """Optional sklearn-style linear gate model (reference ``engine.model``,
    :1400-1407, served via ``_ml_allowed`` :1454-1466).

    ``n_features`` distinguishes the reference's skewed 3-feature artifact from the
    fixed 4-feature one: serving a 3-feature model through the 4-feature server
    raises in the reference and silently disables the gate (quirk Q5) — here the
    mismatch disables the gate explicitly.
    """

    coef: jnp.ndarray        # f32[4]
    intercept: jnp.ndarray   # f32
    n_features: jnp.ndarray  # i32 (3 = reference-skewed, 4 = fixed)
    present: jnp.ndarray     # bool

    @classmethod
    def absent(cls) -> "MlModel":
        # cached singleton per default backend (eager scalar creation
        # dispatches one op per scalar; see ops/guard.GuardParams.default);
        # never cached under a trace (utils/tracectx)
        if not tracectx.eager():
            return _build_ml_absent()
        return _ml_absent(jax.default_backend())

    @classmethod
    def from_weights(cls, coef, intercept, n_features: int = 4) -> "MlModel":
        coef = jnp.asarray(coef, jnp.float32).reshape(-1)
        pad = jnp.zeros((4,), jnp.float32).at[: coef.shape[0]].set(coef[:4])
        return cls(
            coef=pad,
            intercept=jnp.asarray(intercept, jnp.float32).reshape(()),
            n_features=jnp.int32(n_features),
            present=jnp.asarray(True),
        )


@functools.lru_cache(maxsize=None)
def _ml_absent(backend: str) -> "MlModel":
    return _build_ml_absent()


def _build_ml_absent() -> "MlModel":
    return MlModel(
        coef=jnp.zeros((4,), jnp.float32),
        intercept=jnp.float32(0.0),
        n_features=jnp.int32(4),
        present=jnp.asarray(False),
    )
