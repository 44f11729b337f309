"""Core data types (pytrees) for the QMMX framework.

Everything numerical is structure-of-arrays with **static shapes** so it can live on
device, flow through ``jit``/``vmap``/``lax.scan`` and shard over a ``jax.sharding.Mesh``:

* ``Levels`` — the user's horizontal price levels (Blue/Orange/Black/Teal ×
  solid/dashed), padded to a fixed ``max_levels`` with a validity mask.  Mirrors the
  ``price_levels`` SQLite table (reference qmmx_monolithic.py:75-81) and the in-memory
  ``levels_cache`` dict list (:1368, :140-144) whose SQL ordering (color, type, index)
  is preserved so nearest-level ties resolve identically.
* ``Bars`` — 1-minute OHLCV bars (reference ``recent_bars`` / Polygon aggregates,
  :220-240, :1813-1823).  Timestamps are ``int32`` **milliseconds relative to a host
  epoch** (``epoch_ms``), keeping device arithmetic in 32-bit; every duration the
  engine compares (15 s staleness, 8 s cooldown, 180 s touch gap, 30 min fatigue
  window) fits comfortably.
* ``Ticks`` — raw trade prints for the live-loop replay (reference ``ingest_tick``
  inputs, :1857-1883).

Color/kind/side enums are small ints; names preserved for the host/SQLite layer.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
from .utils import struct

# Level colors in the reference GUI (qmmx_monolithic.py:2712-2754: Blue/Orange/Black/Teal).
COLORS = ("blue", "orange", "black", "teal")
COLOR_IDS = {c: i for i, c in enumerate(COLORS)}

# Level kinds ("level_type" column): solid / dashed.
KIND_DASHED = 0
KIND_SOLID = 1
KINDS = ("dashed", "solid")

# Trade sides as signed ints: +1 long, -1 short, 0 flat.
SIDE_LONG = 1
SIDE_SHORT = -1
SIDE_FLAT = 0

# Tick directions: +1 up, -1 down, 0 unknown (reference "up"/"down"/None, :1529-1540).
DIR_UP = 1
DIR_DOWN = -1
DIR_UNKNOWN = 0

# Approach encoding for policy features: reference one-hots over
# ["from_above", "from_below"] (qmmx_monolithic.py:320).
APPROACH_FROM_ABOVE = 0
APPROACH_FROM_BELOW = 1

# Sim outcomes (reference "tp"/"stop"/"open", :3481-3486).
OUTCOME_OPEN = 0
OUTCOME_TP = 1
OUTCOME_STOP = 2


@struct.dataclass
class Levels:
    """Padded SoA of price levels; invalid slots masked out.

    ``price`` for invalid slots is set to +inf so ``argmin |price - p|`` never
    selects them.
    """

    price: jnp.ndarray   # f32[L]
    kind: jnp.ndarray    # i32[L]  (KIND_SOLID / KIND_DASHED)
    color: jnp.ndarray   # i32[L]  (index into COLORS)
    index: jnp.ndarray   # i32[L]  (user slot index within color/kind grid)
    valid: jnp.ndarray   # bool[L]

    @property
    def max_levels(self) -> int:
        return self.price.shape[-1]

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    @classmethod
    def from_rows(cls, rows: list[dict[str, Any]], max_levels: int = 64) -> "Levels":
        """Build from host dict rows ({"color","type","index","price"}) preserving
        the reference's (color, type, index) SQL ordering (qmmx_monolithic.py:142)."""
        rows = sorted(rows, key=lambda r: (str(r["color"]), str(r["type"]), int(r["index"])))
        if len(rows) > max_levels:
            raise ValueError(f"{len(rows)} levels > max_levels={max_levels}")
        price = np.full((max_levels,), np.inf, dtype=np.float32)
        kind = np.zeros((max_levels,), dtype=np.int32)
        color = np.zeros((max_levels,), dtype=np.int32)
        index = np.zeros((max_levels,), dtype=np.int32)
        valid = np.zeros((max_levels,), dtype=bool)
        for i, r in enumerate(rows):
            price[i] = float(r["price"])
            kind[i] = KIND_SOLID if str(r["type"]) == "solid" else KIND_DASHED
            color[i] = COLOR_IDS.get(str(r["color"]), 0)
            index[i] = int(r["index"])
            valid[i] = True
        return cls(
            price=jnp.asarray(price),
            kind=jnp.asarray(kind),
            color=jnp.asarray(color),
            index=jnp.asarray(index),
            valid=jnp.asarray(valid),
        )

    def to_rows(self) -> list[dict[str, Any]]:
        out = []
        valid = np.asarray(self.valid)
        for i in range(self.max_levels):
            if not valid[i]:
                continue
            out.append(
                {
                    "color": COLORS[int(np.asarray(self.color)[i])],
                    "type": KINDS[int(np.asarray(self.kind)[i])],
                    "index": int(np.asarray(self.index)[i]),
                    "price": float(np.asarray(self.price)[i]),
                }
            )
        return out


@struct.dataclass
class Bars:
    """SoA 1-minute OHLCV bars, oldest → newest along the last axis.

    ``ts_ms`` is int32 milliseconds relative to the (host-side) epoch of the dataset.
    ``valid`` masks padding so fixed-shape windows can hold variable history.
    """

    ts_ms: jnp.ndarray  # i32[..., N]
    open: jnp.ndarray   # f32[..., N]
    high: jnp.ndarray   # f32[..., N]
    low: jnp.ndarray    # f32[..., N]
    close: jnp.ndarray  # f32[..., N]
    volume: jnp.ndarray  # f32[..., N]
    valid: jnp.ndarray  # bool[..., N]

    @property
    def num_bars(self) -> int:
        return self.close.shape[-1]

    @classmethod
    def from_arrays(cls, ts_ms, o, h, l, c, v=None, valid=None) -> "Bars":
        c = jnp.asarray(c, jnp.float32)
        if v is None:
            v = jnp.zeros_like(c)
        if valid is None:
            valid = jnp.ones(c.shape, dtype=bool)
        return cls(
            ts_ms=jnp.asarray(ts_ms, jnp.int32),
            open=jnp.asarray(o, jnp.float32),
            high=jnp.asarray(h, jnp.float32),
            low=jnp.asarray(l, jnp.float32),
            close=c,
            volume=jnp.asarray(v, jnp.float32),
            valid=valid,
        )

    @classmethod
    def from_rows(cls, rows: list[dict[str, Any]], epoch_ms: int = 0) -> "Bars":
        """Build from host dict rows using Polygon-style keys t/o/h/l/c(/v)
        (reference qmmx_monolithic.py:234)."""
        n = len(rows)
        ts = np.zeros((n,), np.int64)
        o = np.zeros((n,), np.float32)
        h = np.zeros((n,), np.float32)
        l = np.zeros((n,), np.float32)
        c = np.zeros((n,), np.float32)
        v = np.zeros((n,), np.float32)
        for i, b in enumerate(rows):
            ts[i] = int(b.get("t", b.get("ts", 0))) - epoch_ms
            o[i] = float(b.get("o", b.get("price", 0.0)))
            h[i] = float(b.get("h", b.get("price", 0.0)))
            l[i] = float(b.get("l", b.get("price", 0.0)))
            c[i] = float(b.get("c", b.get("price", 0.0)))
            v[i] = float(b.get("v", b.get("volume", 0.0)))
        return cls.from_arrays(ts.astype(np.int32), o, h, l, c, v)


@struct.dataclass
class Ticks:
    """Raw trade prints for live-loop replay (reference ingest_tick, :1857-1883)."""

    ts_ms: jnp.ndarray   # i32[N] relative ms
    price: jnp.ndarray   # f32[N]
    volume: jnp.ndarray  # f32[N]
