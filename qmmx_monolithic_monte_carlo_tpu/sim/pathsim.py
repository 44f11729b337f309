"""Generated-path Monte Carlo: sampler → per-path stop/target replay → reductions.

This is the rebuild's scaling surface (BASELINE configs #2/#3/#5): instead of
jittering one recorded bar window (sim/montecarlo.py), draw fresh OHLC paths
(bootstrap or GBM, ops/pathgen.py) and replay the level-scaffold trade on each.

Per path: find the first bar whose close touches a level (the same proximity
detector as the sims, qmmx_monolithic.py:3399-3405), enter at that close with the
level ∓ STOP/TP paddings scaffold, walk the remaining bars to the first hit with
the same-bar tie coin (:3467-3480).  Outputs reduce to a ``PathStats`` block of
sums/counts/histogram that is associative — so path blocks combine with ``+`` and
shard cleanly over a device mesh with ``psum`` (parallel/mesh.py).

Memory: paths are generated and consumed inside one jit region in blocks
(``lax.map`` over block indices), so HBM holds one block at a time regardless of
the total path count — 1e9 paths stream through without 1e9×W residency.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import EngineParams
from ..ops import features as F
from ..ops import hitscan as H
from ..ops import pathgen as PG
from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP, SIDE_LONG, SIDE_SHORT, Levels
from ..utils import prng

HIST_BINS = 128  # R histogram bins of every PathStats
HIST_LO = -1.5   # single-trade R range: stop = -1, tp = reward/risk (≈ 0.714)
HIST_HI = 2.5
# Multi-trade lifecycle totals routinely exceed the single-trade range (1.7
# trades/path at defaults → totals of -2R and beyond are common); lifecycle
# stats bin per-path TOTAL R over this wider range so VaR/CVaR keep resolving
# past -1.5R instead of clipping into the bottom bin.
LIFE_HIST_LO = -6.0
LIFE_HIST_HI = 8.0


@struct.dataclass
class PathStats:
    """Associative accumulator over path outcomes (combine with ``merge``/psum).

    Two producers share this contract:

    * first-contact replay (``from_outcomes``) — one trade per path, so
      n_tp + n_stop + n_open == n_entered and sum_trades == n_entered;
    * engine-gated lifecycle (``from_lifecycle``, sim/gatedpath.py) — many
      trades per path, so n_tp/n_stop count *trades* (wins/losses) while
      n/n_entered count *paths*, and min_r/max_r/hist cover per-path TOTAL R
      (= best/worst trial totals of the reference MC, qmmx_monolithic.py
      :3512-3525).

    ``hist_lo``/``hist_hi`` are *static* (non-pytree) metadata recording the
    histogram's R range: single-trade replay uses [HIST_LO, HIST_HI] and the
    multi-trade lifecycle the wider [LIFE_HIST_LO, LIFE_HIST_HI] (totals past
    -1.5R must keep resolving for VaR/CVaR).  ``merge`` refuses to combine
    mismatched ranges.
    """

    n: jnp.ndarray         # f32 — paths counted
    n_tp: jnp.ndarray
    n_stop: jnp.ndarray
    n_open: jnp.ndarray
    n_entered: jnp.ndarray  # paths that found a level contact
    sum_r: jnp.ndarray
    sum_r2: jnp.ndarray
    min_r: jnp.ndarray
    max_r: jnp.ndarray
    sum_trades: jnp.ndarray  # total trades taken across paths
    sum_dd: jnp.ndarray      # sum of per-path max drawdown (R, >= 0)
    max_dd: jnp.ndarray      # worst per-path drawdown (R, >= 0; 'max' combine)
    hist: jnp.ndarray      # f32[HIST_BINS] of R values (entered paths)
    # static histogram range metadata (not traced; part of the treedef)
    hist_lo: float = struct.field(pytree_node=False, default=HIST_LO)
    hist_hi: float = struct.field(pytree_node=False, default=HIST_HI)

    @classmethod
    def zero(cls, hist_lo: float = HIST_LO, hist_hi: float = HIST_HI) -> "PathStats":
        z = jnp.float32(0.0)
        return cls(n=z, n_tp=z, n_stop=z, n_open=z, n_entered=z, sum_r=z, sum_r2=z,
                   min_r=jnp.float32(jnp.inf), max_r=jnp.float32(-jnp.inf),
                   sum_trades=z, sum_dd=z, max_dd=z,
                   hist=jnp.zeros((HIST_BINS,), jnp.float32),
                   hist_lo=float(hist_lo), hist_hi=float(hist_hi))

    @classmethod
    def from_outcomes(cls, r, outcome, entered) -> "PathStats":
        r = jnp.asarray(r, jnp.float32)
        entered = jnp.asarray(entered)
        w = entered.astype(jnp.float32)
        bin_idx = jnp.clip(
            ((r - HIST_LO) / (HIST_HI - HIST_LO) * HIST_BINS).astype(jnp.int32),
            0, HIST_BINS - 1,
        )
        hist = jnp.zeros((HIST_BINS,), jnp.float32).at[bin_idx].add(w)
        big = jnp.float32(jnp.inf)
        # single-trade equity curve: peak = max(0, r), so drawdown = max(0, -r)
        dd = jnp.maximum(0.0, -r) * w
        return cls(
            n=jnp.sum(jnp.ones_like(r)),
            n_tp=jnp.sum(w * (outcome == OUTCOME_TP)),
            n_stop=jnp.sum(w * (outcome == OUTCOME_STOP)),
            n_open=jnp.sum(w * (outcome == OUTCOME_OPEN)),
            n_entered=jnp.sum(w),
            sum_r=jnp.sum(w * r),
            sum_r2=jnp.sum(w * r * r),
            min_r=jnp.min(jnp.where(entered, r, big)),
            max_r=jnp.max(jnp.where(entered, r, -big)),
            sum_trades=jnp.sum(w),
            sum_dd=jnp.sum(dd),
            max_dd=jnp.max(dd, initial=0.0),
            hist=hist,
        )

    @classmethod
    def from_lifecycle(cls, *, equity, trades, wins, losses, open_at_end,
                       max_dd, hist_lo: float = LIFE_HIST_LO,
                       hist_hi: float = LIFE_HIST_HI) -> "PathStats":
        """Multi-trade per-path accumulator (sim/gatedpath.py): ``equity`` is the
        per-path total R; hist/min/max/moments cover path totals; n_tp/n_stop
        count trades; n_open counts paths left holding a position."""
        equity = jnp.asarray(equity, jnp.float32)
        trades = jnp.asarray(trades, jnp.float32)
        entered = trades > 0
        w = entered.astype(jnp.float32)
        bin_idx = jnp.clip(
            ((equity - hist_lo) / (hist_hi - hist_lo) * HIST_BINS).astype(jnp.int32),
            0, HIST_BINS - 1,
        )
        hist = jnp.zeros((HIST_BINS,), jnp.float32).at[bin_idx].add(w)
        big = jnp.float32(jnp.inf)
        dd = jnp.asarray(max_dd, jnp.float32) * w
        return cls(
            n=jnp.sum(jnp.ones_like(equity)),
            n_tp=jnp.sum(jnp.asarray(wins, jnp.float32)),
            n_stop=jnp.sum(jnp.asarray(losses, jnp.float32)),
            n_open=jnp.sum(jnp.asarray(open_at_end, jnp.float32) * w),
            n_entered=jnp.sum(w),
            sum_r=jnp.sum(w * equity),
            sum_r2=jnp.sum(w * equity * equity),
            min_r=jnp.min(jnp.where(entered, equity, big)),
            max_r=jnp.max(jnp.where(entered, equity, -big)),
            sum_trades=jnp.sum(trades),
            sum_dd=jnp.sum(dd),
            max_dd=jnp.max(dd, initial=0.0),
            hist=hist,
            hist_lo=float(hist_lo),
            hist_hi=float(hist_hi),
        )

    def merge(self, other: "PathStats") -> "PathStats":
        if (self.hist_lo, self.hist_hi) != (other.hist_lo, other.hist_hi):
            raise ValueError(
                f"cannot merge PathStats with different histogram ranges: "
                f"[{self.hist_lo}, {self.hist_hi}] vs "
                f"[{other.hist_lo}, {other.hist_hi}]"
            )
        return PathStats(
            n=self.n + other.n,
            n_tp=self.n_tp + other.n_tp,
            n_stop=self.n_stop + other.n_stop,
            n_open=self.n_open + other.n_open,
            n_entered=self.n_entered + other.n_entered,
            sum_r=self.sum_r + other.sum_r,
            sum_r2=self.sum_r2 + other.sum_r2,
            min_r=jnp.minimum(self.min_r, other.min_r),
            max_r=jnp.maximum(self.max_r, other.max_r),
            sum_trades=self.sum_trades + other.sum_trades,
            sum_dd=self.sum_dd + other.sum_dd,
            max_dd=jnp.maximum(self.max_dd, other.max_dd),
            hist=self.hist + other.hist,
            hist_lo=self.hist_lo,
            hist_hi=self.hist_hi,
        )

    # ---- derived metrics ----
    @property
    def mean_r(self):
        return self.sum_r / jnp.maximum(self.n_entered, 1.0)

    @property
    def std_r(self):
        m = self.mean_r
        return jnp.sqrt(jnp.maximum(self.sum_r2 / jnp.maximum(self.n_entered, 1.0) - m * m, 0.0))

    @property
    def hit_rate(self):
        return self.n_tp / jnp.maximum(self.n_tp + self.n_stop, 1.0)

    @property
    def mean_trades(self):
        """Trades per entered path (1.0 exactly for first-contact replay)."""
        return self.sum_trades / jnp.maximum(self.n_entered, 1.0)

    @property
    def mean_dd(self):
        """Mean per-path max drawdown in R (reference 'mean worst drawdown',
        qmmx_monolithic.py:3512-3525)."""
        return self.sum_dd / jnp.maximum(self.n_entered, 1.0)

    def quantile(self, q):
        """Histogram-estimated R quantile (used for VaR at path scale, where an
        exact sort of 1e9 values is replaced by a binned-CDF inversion over
        this accumulator's own [hist_lo, hist_hi] range)."""
        nb = self.hist.shape[-1]
        cdf = jnp.cumsum(self.hist)
        total = cdf[-1]
        target = jnp.asarray(q, jnp.float32) * total
        idx = jnp.searchsorted(cdf, target, side="left")
        idx = jnp.clip(idx, 0, nb - 1)
        # linear interpolation inside the bin
        prev = jnp.where(idx > 0, cdf[idx - 1], 0.0)
        frac = jnp.where(self.hist[idx] > 0, (target - prev) / jnp.maximum(self.hist[idx], 1.0), 0.0)
        w = (self.hist_hi - self.hist_lo) / nb
        return self.hist_lo + (idx.astype(jnp.float32) + frac) * w

    def cvar(self, q=0.05):
        """Histogram-estimated mean of the lower q tail."""
        nb = self.hist.shape[-1]
        cdf = jnp.cumsum(self.hist)
        total = cdf[-1]
        cutoff = jnp.asarray(q, jnp.float32) * total
        w = (self.hist_hi - self.hist_lo) / nb
        centers = self.hist_lo + (jnp.arange(nb, dtype=jnp.float32) + 0.5) * w
        prev_cdf = jnp.concatenate([jnp.zeros((1,), jnp.float32), cdf[:-1]])
        take = jnp.clip(cutoff - prev_cdf, 0.0, self.hist)
        return jnp.sum(take * centers) / jnp.maximum(cutoff, 1.0)


def path_replay(
    paths: PG.PathBars,
    levels: Levels,
    params: EngineParams,
    tie_uniform,
    noise=None,          # montecarlo.McNoise — execution-noise stds
    noise_normals=None,  # f32[4, P] std-normals: (level_jit, entry, stop, tgt)
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Replay the level-contact trade on each generated path.

    Returns (r, outcome, entered) over the path axis.  Entry: first bar with
    close within CONTACT_PROX of the nearest level; side from the close-to-close
    move into that bar (long if up, short otherwise — matching the sims'
    ``c > prev_c`` rule); stop/target = level ∓ paddings.

    Execution noise (the reference MC's robustness knobs, qmmx_monolithic.py
    :3453-3461): when ``noise`` is given, the trade scaffold is perturbed by
    per-path gaussians — level jitter shifts stop AND target, entry slip moves
    the fill, stop/target slips move each barrier independently.  Contact
    detection still uses the true levels (the reference jitters inside
    ``walk_outcome``, after candidate discovery).  ``noise=None`` leaves the
    trace bitwise identical to the noise-free build.
    """
    close = paths.close                             # [P, W]
    p, w = close.shape
    idx, dist = F.nearest_level(levels, close)      # [P, W]
    near = dist <= params.contact_prox
    # side needs a previous close: bar 0 compares against the open
    prev = jnp.concatenate([paths.open[:, :1], close[:, :-1]], axis=1)
    entered = jnp.any(near, axis=1)
    ebar = jnp.where(entered, jnp.argmax(near, axis=1), 0)

    rows = jnp.arange(p)
    lvl = levels.price[idx[rows, ebar]]
    entry = close[rows, ebar]
    side = jnp.where(entry > prev[rows, ebar], SIDE_LONG, SIDE_SHORT)
    if noise is not None:
        nj, ne, ns, nt = noise_normals
        lvl = lvl + nj * noise.level_jitter_std      # :3453
        entry = entry + ne * noise.entry_slip_std    # :3455
    is_long = side == SIDE_LONG
    stop = jnp.where(is_long, lvl - params.stop_padding, lvl + params.stop_padding)
    target = jnp.where(is_long, lvl + params.tp_padding, lvl - params.tp_padding)
    if noise is not None:
        stop = stop + ns * noise.stop_slip_std       # :3458
        target = target + nt * noise.target_slip_std  # :3461

    after = jnp.arange(w)[None, :] > ebar[:, None]
    r, outcome = H.stop_target_outcome(
        highs=paths.high, lows=paths.low, side=side,
        entry=entry, stop=stop, target=target,
        tie_uniform=tie_uniform, valid_mask=after,
    )
    r = jnp.where(entered, r, 0.0)
    outcome = jnp.where(entered, outcome, OUTCOME_OPEN)
    return r, outcome, entered


def sample_block(
    bkey, *, block_paths, num_bars, s0, mu, sigma, dt,
    sampler, hist_bars, antithetic, block_len=10, heston=None,
    volume_model=None,
) -> PG.PathBars:
    """One path block from the named sampler ("gbm", "bootstrap",
    "block_bootstrap", "heston").  Shared by the first-contact pipeline here
    and the engine-gated lifecycle pipeline (sim/gatedpath.py).

    Volume: bootstrap samplers carry the real historical volumes of the bars
    they resample (when ``hist_bars`` has them); GBM/Heston synthesize volume
    from ``volume_model`` (PG.VolumeModel; None → defaults).  Pipelines that
    never read ``PathBars.volume`` are unaffected — XLA prunes the dead draw."""
    if sampler in ("bootstrap", "block_bootstrap"):
        if hist_bars is None:
            raise ValueError(f"sampler={sampler!r} requires hist_bars")
        if antithetic:
            raise ValueError("antithetic pairs the gbm and heston normals only")
    hist_volume = getattr(hist_bars, "volume", None)
    if sampler == "gbm":
        return PG.gbm_paths(
            bkey, num_paths=block_paths, num_bars=num_bars, s0=s0,
            mu=mu, sigma=sigma, dt=dt, antithetic=antithetic,
            volume_model=volume_model,
        )
    if sampler == "bootstrap":
        return PG.bootstrap_paths(
            bkey,
            hist_open=hist_bars.open, hist_high=hist_bars.high,
            hist_low=hist_bars.low, hist_close=hist_bars.close,
            num_paths=block_paths, num_bars=num_bars, s0=s0,
            hist_volume=hist_volume,
        )
    if sampler == "block_bootstrap":
        return PG.block_bootstrap_paths(
            bkey,
            hist_open=hist_bars.open, hist_high=hist_bars.high,
            hist_low=hist_bars.low, hist_close=hist_bars.close,
            num_paths=block_paths, num_bars=num_bars, s0=s0,
            block_len=block_len, hist_volume=hist_volume,
        )
    if sampler == "heston":
        return PG.heston_paths(
            bkey, num_paths=block_paths, num_bars=num_bars, s0=s0,
            mu=mu, dt=dt, antithetic=antithetic, volume_model=volume_model,
            **(heston or {}),
        )
    raise ValueError(f"unknown sampler {sampler!r}")


def noise_normals(bkey, shape) -> tuple:
    """The four execution-noise standard-normal draws (level jitter, entry
    slip, stop slip, target slip), each from its own stream of ``bkey``."""
    return tuple(
        jax.random.normal(prng.key_for(bkey, s), shape, jnp.float32)
        for s in (prng.STREAM_LEVEL_JITTER, prng.STREAM_ENTRY_SLIP,
                  prng.STREAM_STOP_SLIP, prng.STREAM_TARGET_SLIP)
    )


def _one_block(
    key, block_idx, *, levels, params, block_paths, num_bars, s0, mu, sigma, dt,
    sampler, hist_bars, antithetic, block_len=10, heston=None, noise=None,
    volume_model=None,
) -> PathStats:
    bkey = prng.key_for(key, prng.STREAM_PATH, block_idx)
    paths = sample_block(
        bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
        sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
        antithetic=antithetic, block_len=block_len, heston=heston,
        volume_model=volume_model,
    )
    tie = jax.random.uniform(
        prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths,), jnp.float32
    )
    draws = noise_normals(bkey, (block_paths,)) if noise is not None else None
    r, outcome, entered = path_replay(paths, levels, params, tie,
                                      noise=noise, noise_normals=draws)
    return PathStats.from_outcomes(r, outcome, entered)


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "sampler",
                     "antithetic", "block_len", "volume_model"),
)
def mc_paths(
    key,
    levels: Levels,
    params: EngineParams,
    *,
    num_paths: int,
    num_bars: int = 40,
    s0=100.0,
    mu: float = 0.0,
    sigma: float = 0.15,
    dt: float = 1.0 / (390.0 * 252.0),
    sampler: str = "gbm",
    hist_bars=None,
    block_paths: int = 1 << 16,
    antithetic: bool = False,
    block_len: int = 10,
    heston=None,
    noise=None,
    volume_model=None,
) -> PathStats:
    """Streamed generated-path MC: ``num_paths`` paths in blocks of
    ``block_paths``; returns merged PathStats.  Samplers: "gbm", "bootstrap",
    "block_bootstrap" (dependence-preserving), "heston" (stochastic vol; pass
    v0/kappa/theta/xi/rho via ``heston={...}``).  ``noise`` (montecarlo.McNoise)
    adds the reference MC's execution-noise gaussians per path (:3453-3461)."""
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    n_blocks = num_paths // block_paths

    def body(carry, b):
        stats = _one_block(
            key, b, levels=levels, params=params, block_paths=block_paths,
            num_bars=num_bars, s0=s0, mu=mu, sigma=sigma, dt=dt,
            sampler=sampler, hist_bars=hist_bars, antithetic=antithetic,
            block_len=block_len, heston=heston, noise=noise,
            volume_model=volume_model,
        )
        return carry.merge(stats), None

    out, _ = jax.lax.scan(body, PathStats.zero(), jnp.arange(n_blocks, dtype=jnp.uint32))
    return out
