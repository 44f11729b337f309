"""Engine-gated trade lifecycle over GENERATED paths: the QMMX engine at scale.

The first-contact pipeline (sim/pathsim.py) replays ONE trade per generated
path.  The reference engine trades *repeatedly* over its window — cooldown
between trades (qmmx_monolithic.py:1516), per-level touch budgets with the
LEVEL_OVERTOUCHED gate (:1557-1587), the handcrafted confidence gate
(:1626-1641 via compute_confidence :1415-1427), direction from the last move
(:1529-1540) — and its Monte Carlo summarises each trial's *equity curve* with
peak-tracked max drawdown (:3491-3510).  This module runs that lifecycle over
every generated path:

    per path, per bar (lax.scan over the bar axis, all paths vectorized):
      1. position management first: stop/target first-hit off the bar's
         high/low with the same-bar distance-weighted tie coin (:3467-3480);
         close updates equity/peak/drawdown and arms the cooldown; the engine
         never re-enters on a closing tick (:2966-3014 `continue`s).
      2. flat + out-of-cooldown paths evaluate entry at the bar close:
         direction known (c != prev_c, :1529-1540), nearest level within
         CONTACT_PROX (:1543-1555), fresh-touch latch (180 s ≈ 3-bar de-dup,
         :1557-1576) incrementing the per-(path, level) touch count,
         LEVEL_OVERTOUCHED when the count reaches the budget (:1572-1587),
         confidence >= Q_MIN_PROB (:1626-1641).  Passing paths open at the
         close with stop/target = level ∓ STOP/TP paddings (:1643-1675).

Bar-cadence notes (the engine loop ticks at 0.7 s; generated paths are 1-min
bars): cooldown is expressed in bars (``cooldown_bars``; the reference's 8 s
Q_SIGNAL_COOLDOWN rounds to 0 full bars — the no-same-bar-reentry rule already
enforces the spirit), and the touch latch de-dup gap is ``touch_gap_bars``
(180 s → 3 bars, :1567).

Outputs reduce via ``PathStats.from_lifecycle``: histogram/extremes/moments
over per-path TOTAL R (the reference MC's per-trial totals, so VaR/CVaR/best/
worst match :3512-3525), n_tp/n_stop as trade-level win/loss counts, and the
new sum_trades/sum_dd/max_dd drawdown block.  The accumulator stays
associative, so blocks stream through ``mc_paths_gated`` and shard over a
device mesh exactly like the first-contact stats.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import EngineParams
from ..ops import confidence as C
from ..ops import features as F
from ..ops import pathgen as PG
from ..types import DIR_DOWN, DIR_UP, SIDE_FLAT, SIDE_LONG, SIDE_SHORT, Levels
from ..utils import prng
from . import pathsim
from .hits import bar_hit_outcome
from .pathsim import PathStats


@struct.dataclass
class GateConfig:
    """Gate knobs for the generated-path lifecycle (pytree; all traced)."""

    touch_limit: jnp.ndarray     # i32 — skip when a level's touch count reaches
                                 # this (reference LEVEL_OVERTOUCHED at 4, :1572)
    q_min_prob: jnp.ndarray      # f32 — confidence floor (:1626-1641)
    cooldown_bars: jnp.ndarray   # i32 — full bars blocked after a close (:1516)
    touch_gap_bars: jnp.ndarray  # i32 — fresh-touch de-dup gap (180 s, :1567)
    use_confidence: jnp.ndarray  # bool — disable to gate on touch budget only

    @classmethod
    def default(
        cls, *, touch_limit: int = 4, q_min_prob: float = 0.60,
        cooldown_bars: int = 0, touch_gap_bars: int = 3,
        use_confidence: bool = True,
    ) -> "GateConfig":
        return cls(
            touch_limit=jnp.int32(touch_limit),
            q_min_prob=jnp.float32(q_min_prob),
            cooldown_bars=jnp.int32(cooldown_bars),
            touch_gap_bars=jnp.int32(touch_gap_bars),
            use_confidence=jnp.asarray(use_confidence),
        )

    @classmethod
    def from_params(
        cls, params: EngineParams, *, touch_limit: int = 4,
        cooldown_bars: int = 0, touch_gap_bars: int = 3,
        use_confidence: bool = True,
    ) -> "GateConfig":
        """Engine defaults with the confidence floor taken from the (possibly
        traced) EngineParams.q_min_prob."""
        return cls(
            touch_limit=jnp.int32(touch_limit),
            q_min_prob=jnp.asarray(params.q_min_prob, jnp.float32),
            cooldown_bars=jnp.int32(cooldown_bars),
            touch_gap_bars=jnp.int32(touch_gap_bars),
            use_confidence=jnp.asarray(use_confidence),
        )


class LifecycleOutcome(NamedTuple):
    """Per-path lifecycle results ([P] each)."""

    equity: jnp.ndarray       # f32 total R over all closed trades
    trades: jnp.ndarray       # i32 entries taken
    wins: jnp.ndarray         # i32 target closes
    losses: jnp.ndarray       # i32 stop closes
    open_at_end: jnp.ndarray  # bool position still open after the last bar
    max_dd: jnp.ndarray       # f32 peak-tracked max drawdown in R (>= 0)


def gated_path_replay(
    paths: PG.PathBars,
    levels: Levels,
    params: EngineParams,
    gate: GateConfig,
    tie_uniform,              # f32[P, W] same-bar tie coins (one per bar)
    noise=None,               # montecarlo.McNoise — per-ENTRY execution noise
    noise_normals=None,       # f32[4, P, W] std-normals (lvl_jit/entry/stop/tgt)
    return_curve: bool = False,
) -> LifecycleOutcome:
    """Run the gated trade lifecycle over every path (scan over bars, [P]-wide).

    Execution noise (reference MC :3453-3461) applies per ENTRY: the bar's
    four std-normal draws perturb the scaffold exactly when a trade opens on
    that bar (level jitter shifts stop+target, entry slip moves the fill,
    stop/target slips move each barrier).  Gate decisions still see the true
    levels.  ``noise=None`` leaves the trace bitwise identical.

    ``return_curve=True`` additionally returns the post-bar equity curve
    f32[W, P] (the scan's per-bar ys) — the portfolio layer sums weighted
    per-symbol curves to track TRUE portfolio drawdown over time
    (parallel/portfolio.py; per-symbol final equities cannot see it)."""
    close = jnp.asarray(paths.close, jnp.float32)
    p, w = close.shape
    n_lvl = levels.max_levels
    lvl_iota = jnp.arange(n_lvl, dtype=jnp.int32)
    # finite copy for gathers (+inf pads would poison arithmetic on dead lanes)
    lvl_price_f = jnp.where(levels.valid, levels.price, 0.0)

    def step(carry, inp):
        (side, entry, stop, target, cooldown, touch, last_tb,
         equity, peak, dd, trades, wins, losses, prev_c) = carry
        if noise is not None:
            h, l, c, tie, bar, nj, ne, ns, nt = inp
        else:
            h, l, c, tie, bar = inp

        # ---- 1) position management (:2966-3014, hits :3467-3480) ----
        is_open = side != SIDE_FLAT
        is_long = side == SIDE_LONG
        bh = bar_hit_outcome(
            is_open=is_open, is_long=is_long, entry=entry, stop=stop,
            target=target, high=h, low=l, tie=tie)
        target_first = bh.target_first
        closed = bh.hit
        risk = jnp.maximum(jnp.abs(entry - stop), 1e-9)
        reward = jnp.abs(target - entry)
        r = jnp.where(closed, jnp.where(target_first, reward / risk, -1.0), 0.0)
        equity = equity + r
        peak = jnp.maximum(peak, equity)
        dd = jnp.maximum(dd, peak - equity)
        wins = wins + jnp.logical_and(closed, target_first).astype(jnp.int32)
        losses = losses + jnp.logical_and(closed, jnp.logical_not(target_first)).astype(jnp.int32)
        side = jnp.where(closed, SIDE_FLAT, side)

        # ---- 2) entry evaluation at the bar close (only flat-at-bar-start
        # paths: the reference `continue`s after any close) ----
        was_flat = jnp.logical_not(is_open)
        cd_ok = cooldown <= 0
        cooldown = jnp.where(closed, gate.cooldown_bars, jnp.maximum(cooldown - 1, 0))

        dir_known = c != prev_c
        new_side = jnp.where(c > prev_c, SIDE_LONG, SIDE_SHORT).astype(jnp.int32)
        idx, dist = F.nearest_level(levels, c)                      # [P]
        near = dist <= params.contact_prox
        signal = jnp.logical_and(
            jnp.logical_and(was_flat, cd_ok), jnp.logical_and(dir_known, near)
        )

        # touch latch (gate 7, :1557-1576): register on signal, de-duped by gap;
        # one-hot scatter over the small static level axis
        onehot = lvl_iota[None, :] == idx[:, None]                  # [P, L]
        tc_old = jnp.sum(jnp.where(onehot, touch, 0), axis=1)
        last_t = jnp.sum(jnp.where(onehot, last_tb, 0), axis=1)
        seen = jnp.sum(jnp.where(onehot, last_tb >= 0, False), axis=1)
        fresh = jnp.logical_and(
            signal,
            jnp.logical_or(jnp.logical_not(seen), bar - last_t >= gate.touch_gap_bars),
        )
        tc_new = tc_old + fresh.astype(jnp.int32)
        upd = jnp.logical_and(onehot, fresh[:, None])
        touch = jnp.where(upd, tc_new[:, None], touch)
        last_tb = jnp.where(upd, bar, last_tb)

        # gates 7 (LEVEL_OVERTOUCHED, :1572-1587) + 8 (CONF_LOW, :1626-1641)
        overtouched = tc_new >= gate.touch_limit
        lvlp = jnp.sum(jnp.where(onehot, lvl_price_f[None, :], 0.0), axis=1)
        lvlk = jnp.sum(jnp.where(onehot, levels.kind[None, :], 0), axis=1)
        conf = C.compute_confidence(
            level_price=lvlp, level_kind=lvlk, price=c,
            direction=jnp.where(new_side == SIDE_LONG, DIR_UP, DIR_DOWN),
            touch_count=tc_new, contact_prox=params.contact_prox,
        )
        conf_ok = jnp.logical_or(
            jnp.logical_not(gate.use_confidence), conf >= gate.q_min_prob
        )
        enter = jnp.logical_and(
            signal, jnp.logical_and(jnp.logical_not(overtouched), conf_ok)
        )

        # stop/target scaffold = level ∓ paddings (:1643-1675); entry at close
        go_long = new_side == SIDE_LONG
        side = jnp.where(enter, new_side, side)
        if noise is not None:
            lvl_eff = lvlp + nj * noise.level_jitter_std
            fill = c + ne * noise.entry_slip_std
        else:
            lvl_eff, fill = lvlp, c
        entry = jnp.where(enter, fill, entry)
        new_stop = jnp.where(
            go_long, lvl_eff - params.stop_padding, lvl_eff + params.stop_padding
        )
        new_target = jnp.where(
            go_long, lvl_eff + params.tp_padding, lvl_eff - params.tp_padding
        )
        if noise is not None:
            new_stop = new_stop + ns * noise.stop_slip_std
            new_target = new_target + nt * noise.target_slip_std
        stop = jnp.where(enter, new_stop, stop)
        target = jnp.where(enter, new_target, target)
        trades = trades + enter.astype(jnp.int32)

        return (side, entry, stop, target, cooldown, touch, last_tb,
                equity, peak, dd, trades, wins, losses, c), (
                    equity if return_curve else None)

    zf = jnp.zeros((p,), jnp.float32)
    zi = jnp.zeros((p,), jnp.int32)
    init = (
        zi,                                  # side (flat)
        zf, zf, zf,                          # entry / stop / target
        zi,                                  # cooldown
        jnp.zeros((p, n_lvl), jnp.int32),    # touch counts
        jnp.full((p, n_lvl), -1, jnp.int32),  # last touch bar (-1 = never)
        zf, zf, zf,                          # equity / peak / max_dd
        zi, zi, zi,                          # trades / wins / losses
        jnp.asarray(paths.open, jnp.float32)[:, 0],  # prev close (bar 0: open)
    )
    xs = (
        jnp.asarray(paths.high, jnp.float32).T,
        jnp.asarray(paths.low, jnp.float32).T,
        close.T,
        jnp.asarray(tie_uniform, jnp.float32).T,
        jnp.arange(w, dtype=jnp.int32),
    )
    if noise is not None:
        xs = xs + tuple(jnp.asarray(nn, jnp.float32).T for nn in noise_normals)
    (side, _, _, _, _, _, _, equity, _, dd, trades, wins, losses, _), curve = (
        jax.lax.scan(step, init, xs)
    )
    out = LifecycleOutcome(
        equity=equity, trades=trades, wins=wins, losses=losses,
        open_at_end=side != SIDE_FLAT, max_dd=dd,
    )
    return (out, curve) if return_curve else out


def _one_block_gated(
    key, block_idx, *, levels, params, gate, block_paths, num_bars, s0, mu,
    sigma, dt, sampler, hist_bars, antithetic, block_len=10, heston=None,
    noise=None, volume_model=None,
) -> PathStats:
    bkey = prng.key_for(key, prng.STREAM_PATH, block_idx)
    paths = pathsim.sample_block(
        bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
        sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
        antithetic=antithetic, block_len=block_len, heston=heston,
        volume_model=volume_model,
    )
    tie = jax.random.uniform(
        prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths, num_bars),
        jnp.float32,
    )
    draws = (pathsim.noise_normals(bkey, (block_paths, num_bars))
             if noise is not None else None)
    out = gated_path_replay(paths, levels, params, gate, tie,
                            noise=noise, noise_normals=draws)
    return PathStats.from_lifecycle(
        equity=out.equity, trades=out.trades, wins=out.wins, losses=out.losses,
        open_at_end=out.open_at_end, max_dd=out.max_dd,
    )


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "sampler",
                     "antithetic", "block_len", "volume_model"),
)
def mc_paths_gated(
    key,
    levels: Levels,
    params: EngineParams,
    gate: GateConfig | None = None,
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
    """Streamed generated-path MC with the gated multi-trade lifecycle.

    Same block-streaming layout as ``pathsim.mc_paths`` (HBM holds one block
    at a time); the returned PathStats carries per-path-total histogram/
    extremes and the trade/drawdown block (see PathStats docstring for the
    lifecycle field semantics)."""
    if gate is None:
        gate = GateConfig.from_params(params)
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    n_blocks = num_paths // block_paths

    def body(carry, b):
        stats = _one_block_gated(
            key, b, levels=levels, params=params, gate=gate,
            block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
            sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
            antithetic=antithetic, block_len=block_len, heston=heston,
            noise=noise, volume_model=volume_model,
        )
        return carry.merge(stats), None

    out, _ = jax.lax.scan(
        body, PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI),
        jnp.arange(n_blocks, dtype=jnp.uint32),
    )
    return out
