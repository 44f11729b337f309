"""Shared test inputs: level scaffolds and recorded OHLCV histories."""

import jax.numpy as jnp
import numpy as np

from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import VolumeModel
from qmmx_monolithic_monte_carlo_tpu.types import Levels

DT = 1.0 / (390.0 * 252.0)
VM = VolumeModel()

LEVELS = Levels.from_rows(
    [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "teal", "type": "dashed", "index": 0, "price": 100.35},
        {"color": "orange", "type": "solid", "index": 0, "price": 99.65},
    ],
    max_levels=4,
)


def history(seed, h):
    """A recorded OHLCV history with real wick structure and volume bursts
    (what the guard/veto gates consume)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.12, h).astype(np.float32)
    c = np.float32(100.0) + np.cumsum(steps, dtype=np.float32)
    o = np.concatenate([[np.float32(100.0)], c[:-1]])
    hi = np.maximum(o, c) + rng.uniform(0, 0.15, h).astype(np.float32)
    lo = np.minimum(o, c) - rng.uniform(0, 0.15, h).astype(np.float32)
    v = rng.lognormal(13.0, 0.5, h).astype(np.float32)
    v = v * (1.0 + 2.0 * (np.abs(steps) > 0.15)).astype(np.float32)
    return PG.PathBars(open=jnp.asarray(o), high=jnp.asarray(hi),
                       low=jnp.asarray(lo), close=jnp.asarray(c),
                       volume=jnp.asarray(v))


def stacked_histories(seeds, h):
    """[S, H]-batched recorded histories (one ``history`` row per symbol)."""
    rows = [history(sd, h) for sd in seeds]
    return PG.PathBars(*[jnp.stack([getattr(r, f) for r in rows])
                         for f in PG.PathBars._fields])
