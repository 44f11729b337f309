"""Correlated multi-symbol MC + portfolio-level risk (beyond the reference).

The reference trades ONE symbol at a time — its engine loop holds a single
ticker and its Monte Carlo replays that symbol's own bars
(qmmx_monolithic.py:3353-3538); nothing in it can express co-movement between
symbols or risk at the book level.  A production deployment runs a universe
whose symbols co-move, and the risk that matters is the JOINT law: two
perfectly correlated symbols double exposure, two independent ones diversify,
and only per-path portfolio aggregation can tell those apart (per-symbol
marginals are identical in both cases).

This module adds the scaled analog the reference never had:

* **One-factor market model** — per (path, bar) the symbol-s price shock is

      z_s = beta_s * z_mkt + sqrt(1 - beta_s^2) * eps_s

  with one shared market draw ``z_mkt`` and independent idiosyncratic draws
  ``eps_s`` (bridge extremes and tie coins stay independent per symbol: bar
  INTERIORS are microstructure, the factor model drives closes).  beta_s = 0
  recovers independent symbols; beta_s = 1 moves every symbol with the
  market.  The classic equity one-factor (beta) model — full correlation
  matrices reduce to it for one dominant factor, and it needs no
  cross-symbol state beyond the shared draw.
* **True portfolio aggregation** — per path, the weighted per-symbol equity
  CURVES sum into a portfolio curve; final portfolio R feeds a PathStats
  (histogram → portfolio VaR/CVaR), and the portfolio max drawdown is
  peak-tracked over TIME on the combined curve (a book can draw down while
  every symbol's own final equity is flat — summing final dds overstates,
  summing final equities misses it).

Two lifecycle depths share the factor model: ``portfolio_mc`` runs the gated
multi-trade state machine (sim/gatedpath.gated_path_replay — cooldown, touch
budgets, confidence gate); ``portfolio_mc_engine`` runs the FULL 12-gate
engine ladder (sim/enginepath.engine_path_replay — guard regimes, touch
memory, edge fatigue, breakout gate, volume veto, ML/blend/policy gates,
target escalation) per symbol, with synthetic volumes coupled to the
correlated shocks so market-wide moves print volume on every book member.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import EngineParams
from ..models import harvest as HV
from ..ops import pathgen as PG
from ..sim import enginepath, pathsim
from ..sim.gatedpath import GateConfig, gated_path_replay
from ..sim.pathsim import PathStats
from ..types import Levels
from ..utils import prng


def _bars_from_shocks(z, khi, klo, *, s0, mu, sigma, dt,
                      volume=None) -> PG.PathBars:
    """GBM OHLC bars from GIVEN close-to-close shocks ``z`` [P, W]
    (ops/pathgen.gbm_paths with the normal draw replaced by the correlated
    factor combination; bridge extremes drawn fresh from ``khi``/``klo``).
    ``volume``: optional [P, W] volumes (the engine's guard/veto gates read
    volume; the gated subset never does, so it defaults to zeros)."""
    z = jnp.asarray(z, jnp.float32)
    p, w = z.shape
    sig_dt = jnp.asarray(sigma, jnp.float32) * jnp.sqrt(jnp.float32(dt))
    drift = (jnp.float32(mu) - 0.5 * jnp.asarray(sigma, jnp.float32) ** 2
             ) * jnp.float32(dt)
    log_s0 = jnp.log(jnp.asarray(s0, jnp.float32))
    log_close = log_s0 + jnp.cumsum(drift + sig_dt * z, axis=-1)
    log_open = jnp.concatenate(
        [jnp.full((p, 1), log_s0, jnp.float32), log_close[:, :-1]], axis=-1)
    log_hi, log_lo = PG._bridge_extremes(
        khi, klo, log_open, log_close, sig_dt * sig_dt)
    return PG.PathBars(
        open=jnp.exp(log_open), high=jnp.exp(log_hi), low=jnp.exp(log_lo),
        close=jnp.exp(log_close),
        volume=(jnp.zeros((p, w), jnp.float32) if volume is None
                else jnp.asarray(volume, jnp.float32)))


def _book_tables(hist_bars, n_sym):
    """Per-symbol relative-geometry tables [S, H] (shared precompute with
    every bootstrap backend — ops/pathgen.bootstrap_tables)."""
    o_h = jnp.asarray(hist_bars.open, jnp.float32)
    if o_h.ndim != 2:
        raise ValueError("book bootstrap needs [S, H]-batched hist_bars")
    vol_h = getattr(hist_bars, "volume", None)
    vol_h = (jnp.zeros_like(o_h) if vol_h is None
             else jnp.asarray(vol_h, jnp.float32))
    tabs = jax.vmap(PG.bootstrap_tables)(
        o_h, jnp.asarray(hist_bars.high, jnp.float32),
        jnp.asarray(hist_bars.low, jnp.float32),
        jnp.asarray(hist_bars.close, jnp.float32), vol_h)
    return tabs, tabs[0].shape[1]


def _joint_resample_idx(km, *, num_paths, num_bars, n_hist, block_len=0):
    """Shared recorded-day resample indices [P, W]: every book member
    replays the SAME historical bar each step (JOINT recorded days — the
    book's joint law IS the joint history's)."""
    if block_len:
        nb = -(-num_bars // block_len)
        starts = jax.random.randint(
            km, (num_paths, nb), 0, n_hist - block_len)
        offs = jnp.arange(block_len)
        return (starts[:, :, None] + offs[None, None, :]).reshape(
            num_paths, -1)[:, :num_bars]
    return jax.random.randint(km, (num_paths, num_bars), 0, n_hist)


def _boot_bars_from_idx(idx, tab_row, s0s, *, num_paths):
    """Gather one symbol's channels at the shared indices and rebase onto
    its own s0 (ops/pathgen.bootstrap_paths with given indices)."""
    logc, logh, logl, logo, vol = tab_row
    r = logc[idx]
    log_prev = jnp.log(s0s) + jnp.concatenate(
        [jnp.zeros((num_paths, 1), jnp.float32),
         jnp.cumsum(r[:, :-1], axis=-1)], axis=-1)
    return PG.PathBars(
        open=jnp.exp(log_prev + logo[idx]),
        high=jnp.exp(log_prev + logh[idx]),
        low=jnp.exp(log_prev + logl[idx]),
        close=jnp.exp(log_prev + r),
        volume=vol[idx])


def _heston_bars_from_shocks(ks, z, zq, s0s, heston_vec, *, mu, dt,
                             num_paths):
    """Full-truncation Euler from MIXED shocks (ops/pathgen.heston_paths
    with the normals replaced by the factor combinations; the vol shock
    correlates with the price shock through rho within each symbol).
    Volume is zeros — engine callers overwrite it with the volume model."""
    v0, kappa, theta, xi, rho = (heston_vec[i] for i in range(5))
    rho_perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - rho * rho))
    z2 = rho * z + rho_perp * zq
    dtf = jnp.float32(dt)
    num_bars = z.shape[1]

    def step(carry, zs):
        logp, v = carry
        z_s, z_v = zs
        v_pos = jnp.maximum(v, 0.0)
        sig_bar = jnp.sqrt(v_pos * dtf)
        logp_new = (logp + (jnp.float32(mu) - 0.5 * v_pos) * dtf
                    + sig_bar * z_s)
        v_new = v + kappa * (theta - v_pos) * dtf + xi * sig_bar * z_v
        return (logp_new, v_new), (logp_new, sig_bar)

    log_s0 = jnp.log(s0s)
    init = (jnp.full((num_paths,), log_s0), jnp.full((num_paths,), v0))
    (_, _), (log_close_t, sig_bar_t) = jax.lax.scan(step, init, (z.T, z2.T))
    log_close = log_close_t.T
    sig_bar = sig_bar_t.T
    log_open = jnp.concatenate(
        [jnp.full((num_paths, 1), log_s0), log_close[:, :-1]], axis=-1)
    log_hi, log_lo = PG._bridge_extremes(
        prng.key_for(ks, prng.STREAM_BRIDGE_HI),
        prng.key_for(ks, prng.STREAM_BRIDGE_LO),
        log_open, log_close, sig_bar * sig_bar)
    return PG.PathBars(
        open=jnp.exp(log_open), high=jnp.exp(log_hi),
        low=jnp.exp(log_lo), close=jnp.exp(log_close),
        volume=jnp.zeros((num_paths, num_bars), jnp.float32))


def _heston_vec(heston):
    h = dict(v0=0.04, kappa=3.0, theta=0.04, xi=0.6, rho=-0.7)
    h.update(heston or {})
    return jnp.asarray(
        [h["v0"], h["kappa"], h["theta"], h["xi"], h["rho"]], jnp.float32)


def portfolio_mc(
    key,
    levels: Levels,           # batched [S, L]
    params: EngineParams,     # shared scalars
    s0,                       # f32[S]
    sigma,                    # f32[S]
    beta,                     # f32[S] market loadings in [-1, 1]
    weights,                  # f32[S] book weights (sum ~1 keeps the
                              # portfolio histogram inside the LIFE range)
    gate: GateConfig | None = None,
    *,
    num_paths: int,
    num_bars: int = 40,
    dt: float = 1.0 / (390.0 * 252.0),
    mu: float = 0.0,
    block_paths: int = 1 << 13,
    sampler: str = "gbm",
    hist_bars=None,           # PathBars-like [S, H] (bootstrap family)
    block_len: int = 10,
    heston: dict | None = None,
    antithetic: bool = False,
) -> tuple[PathStats, PathStats]:
    """Correlated-universe gated MC: returns ([S] per-symbol PathStats,
    portfolio PathStats).

    Path i carries the SAME market shocks across all symbols, so the
    portfolio fields are a true joint-law Monte Carlo: ``hist``/``quantile``/
    ``cvar`` describe per-path portfolio total R, ``max_dd`` is the worst
    peak-tracked drawdown of the per-path portfolio equity CURVE, ``n_tp``/
    ``n_stop``/``sum_trades`` aggregate trades over the whole book, and
    ``n_entered`` counts paths where ANY symbol traded.  Samplers follow
    ``portfolio_mc_engine`` (JOINT recorded days / correlated heston)."""
    if sampler not in ("gbm", "bootstrap", "block_bootstrap", "heston"):
        raise ValueError("portfolio_mc samplers: 'gbm' | 'bootstrap' | "
                         "'block_bootstrap' | 'heston'")
    if sampler in ("bootstrap", "block_bootstrap"):
        if hist_bars is None:
            raise ValueError("sampler='bootstrap' requires hist_bars "
                             "([S, H] recorded o/h/l/c/v histories)")
    else:
        hist_bars = None
    _check_antithetic(antithetic, sampler, block_paths)
    return _portfolio_mc_impl(
        key, levels, params, s0, sigma, beta, weights, gate, hist_bars,
        _heston_vec(heston), num_paths=num_paths, num_bars=num_bars, dt=dt,
        mu=mu, block_paths=block_paths, sampler=sampler,
        block_len=int(block_len) if sampler == "block_bootstrap" else 0,
        antithetic=bool(antithetic))


def _check_antithetic(antithetic, sampler, block_paths):
    if antithetic and sampler != "gbm":
        raise ValueError("book antithetic pairs gbm normals only")
    if antithetic and block_paths % 2 != 0:
        raise ValueError("antithetic requires an even block_paths")


def _anti_normal(key, num_paths, num_bars, antithetic):
    """[P, W] normals; with ``antithetic`` the second half of the path axis
    is the first half negated (ops/pathgen.gbm_paths pairing)."""
    if not antithetic:
        return jax.random.normal(key, (num_paths, num_bars), jnp.float32)
    z = jax.random.normal(key, (num_paths // 2, num_bars), jnp.float32)
    return jnp.concatenate([z, -z], axis=0)


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "sampler",
                     "block_len", "antithetic"),
)
def _portfolio_mc_impl(
    key, levels, params, s0, sigma, beta, weights, gate, hist_bars,
    heston_vec, *,
    num_paths, num_bars, dt, mu, block_paths, sampler, block_len,
    antithetic=False,
):
    if gate is None:
        gate = GateConfig.from_params(params)
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    n_blocks = num_paths // block_paths
    s0 = jnp.asarray(s0, jnp.float32)
    sigma = jnp.asarray(sigma, jnp.float32)
    beta = jnp.asarray(beta, jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    n_sym = s0.shape[0]
    sym_idx = jnp.arange(n_sym, dtype=jnp.uint32)

    bootstrap = sampler in ("bootstrap", "block_bootstrap")
    tabs, n_hist = _book_tables(hist_bars, n_sym) if bootstrap else (
        tuple(jnp.zeros((n_sym, 1), jnp.float32) for _ in range(5)), 0)

    def one_block(b):
        km = prng.key_for(key, prng.STREAM_MARKET, b)
        if bootstrap:
            joint_idx = _joint_resample_idx(
                km, num_paths=block_paths, num_bars=num_bars, n_hist=n_hist,
                block_len=block_len)
            z_m = zq_m = None
        else:
            z_m = _anti_normal(km, block_paths, num_bars, antithetic)
            zq_m = (jax.random.normal(
                prng.key_for(key, prng.STREAM_MARKET, b, 1),
                (block_paths, num_bars), jnp.float32)
                if sampler == "heston" else None)

        def per_symbol(carry, xs):
            port_curve, trades_tot, wins_tot, losses_tot, open_any = carry
            si, lv, s0s, sgs, bts, wts, tab_row = xs
            ks = prng.key_for(key, prng.STREAM_PATH, b, si)
            if bootstrap:
                bars = _boot_bars_from_idx(joint_idx, tab_row, s0s,
                                           num_paths=block_paths)
            else:
                eps = _anti_normal(ks, block_paths, num_bars,
                                   antithetic)
                perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - bts * bts))
                z = bts * z_m + perp * eps
                if sampler == "heston":
                    zq_e = jax.random.normal(
                        prng.key_for(ks, prng.STREAM_PATH, 3),
                        (block_paths, num_bars), jnp.float32)
                    zq = bts * zq_m + perp * zq_e
                    bars = _heston_bars_from_shocks(
                        ks, z, zq, s0s, heston_vec, mu=mu, dt=dt,
                        num_paths=block_paths)
                else:
                    bars = _bars_from_shocks(
                        z, prng.key_for(ks, prng.STREAM_BRIDGE_HI),
                        prng.key_for(ks, prng.STREAM_BRIDGE_LO),
                        s0=s0s, mu=mu, sigma=sgs, dt=dt)
            tie = jax.random.uniform(
                prng.key_for(ks, prng.STREAM_TIE_COIN),
                (block_paths, num_bars), jnp.float32)
            out, curve = gated_path_replay(
                bars, lv, params, gate, tie, return_curve=True)
            stats = PathStats.from_lifecycle(
                equity=out.equity, trades=out.trades, wins=out.wins,
                losses=out.losses, open_at_end=out.open_at_end,
                max_dd=out.max_dd)
            carry = (port_curve + wts * curve,
                     trades_tot + out.trades,
                     wins_tot + out.wins,
                     losses_tot + out.losses,
                     jnp.logical_or(open_any, out.open_at_end))
            return carry, stats

        zero_curve = jnp.zeros((num_bars, block_paths), jnp.float32)
        zi = jnp.zeros((block_paths,), jnp.int32)
        (port_curve, trades_tot, wins_tot, losses_tot, open_any), sym_stats = (
            jax.lax.scan(
                per_symbol,
                (zero_curve, zi, zi, zi, jnp.zeros((block_paths,), bool)),
                (sym_idx, levels, s0, sigma, beta, weights, tabs),
            )
        )
        # portfolio curve → final R + TRUE time-tracked drawdown (peak over
        # the combined curve, reference per-trial dd semantics :3491-3510
        # lifted to the book level)
        final = port_curve[-1]
        peak = jax.lax.cummax(jnp.maximum(port_curve, 0.0), axis=0)
        port_dd = jnp.max(peak - port_curve, axis=0)
        port_stats = PathStats.from_lifecycle(
            equity=final, trades=trades_tot, wins=wins_tot,
            losses=losses_tot, open_at_end=open_any, max_dd=port_dd)
        return sym_stats, port_stats

    def body(carry, b):
        sym_c, port_c = carry
        sym_s, port_s = one_block(b)
        return (sym_c.merge(sym_s), port_c.merge(port_s)), None

    zero_sym = jax.vmap(
        lambda _: PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    )(sym_idx)
    zero_port = PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    (sym_stats, port_stats), _ = jax.lax.scan(
        body, (zero_sym, zero_port), jnp.arange(n_blocks, dtype=jnp.uint32))
    return sym_stats, port_stats


def portfolio_mc_engine(
    key,
    levels: Levels,           # batched [S, L]
    params: EngineParams,     # shared scalars
    s0,                       # f32[S]
    sigma,                    # f32[S]
    beta,                     # f32[S] market loadings in [-1, 1]
    weights,                  # f32[S] book weights
    *,
    num_paths: int,
    num_bars: int = 40,
    dt: float = 1.0 / (390.0 * 252.0),
    mu: float = 0.0,
    block_paths: int = 1 << 12,
    policy=None,
    ml_model=None,
    touch_params=None,
    guard_params=None,
    policy_gate_disabled: bool | None = None,
    escalation: bool = True,
    bar0_minute=0,
    volume_model: PG.VolumeModel | None = None,
    harvest: bool = False,
    sampler: str = "gbm",     # "gbm" | "bootstrap" | "block_bootstrap"
                              # (JOINT recorded days) | "heston"
    hist_bars=None,           # PathBars-like [S, H] o/h/l/c/v histories
    block_len: int = 10,      # block_bootstrap: contiguous run length
    heston: dict | None = None,
    antithetic: bool = False, # market AND idio shocks flipped (gbm only)
):
    """Correlated-universe MC under the FULL 12-gate engine.

    The portfolio analog of ``sim/enginepath.mc_paths_engine``: per block, one
    shared market shock stream drives every symbol's close-to-close returns
    (``z_s = beta_s z_mkt + sqrt(1-beta_s^2) eps_s``); each symbol runs the
    complete engine ladder — guard regimes, touch memory, edge fatigue,
    breakout gate, volume veto, ML/blend gate, OnlinePolicy, escalation
    (sim/enginepath.engine_path_replay) — over its own bars, with synthetic
    volumes coupled to the correlated shocks (ops/pathgen.VolumeModel, so a
    market-wide move prints volume on EVERY symbol, exactly the regime where
    book risk concentrates).  Per-path weighted equity CURVES sum into the
    portfolio curve; its final value feeds the portfolio histogram and its
    peak-tracked drawdown is the TRUE book drawdown over time.

    Returns ``(sym_stats, port_stats, skip_counts, escalations)``:
    [S] per-symbol ``PathStats``, the portfolio ``PathStats``, the [S, K]
    per-symbol first-fail gate-skip histogram (K = len(SKIP_REASONS) — the
    log-analyzer's skip table per book member), and the [S] total escalation
    counts.  With ``harvest=True`` a 5-tuple ending in the [S]-batched
    ``EngineHarvest`` (per-symbol labeled-trade statistics — the learning
    flywheel's sufficient statistics, harvested from CORRELATED books so
    per-symbol refreshes train on the co-movement regime they will trade
    in).  Defaults match ``mc_paths_engine`` (reference semantics
    qmmx_monolithic.py:3353-3538 lifted to the book level).

    Samplers: ``"bootstrap"``/``"block_bootstrap"``
    replay JOINT recorded days — the per-bar resample indices are drawn
    ONCE per block from the market stream and shared by every symbol, each
    gathering its OWN [S, H] ``hist_bars`` row (real volumes ride along;
    ``beta`` is unused; ties stay idiosyncratic); ``"heston"`` mixes the
    market factor into BOTH the price shock and the variance shock through
    the same beta loading."""
    if sampler not in ("gbm", "bootstrap", "block_bootstrap", "heston"):
        raise ValueError("portfolio_mc_engine samplers: 'gbm' | 'bootstrap'"
                         " | 'block_bootstrap' | 'heston'")
    if sampler in ("bootstrap", "block_bootstrap"):
        if hist_bars is None:
            raise ValueError("sampler='bootstrap' requires hist_bars "
                             "([S, H] recorded o/h/l/c/v histories)")
    else:
        hist_bars = None
    _check_antithetic(antithetic, sampler, block_paths)
    return _portfolio_mc_engine_impl(
        key, levels, params, s0, sigma, beta, weights, hist_bars,
        _heston_vec(heston),
        num_paths=num_paths, num_bars=num_bars, dt=dt, mu=mu,
        block_paths=block_paths, policy=policy, ml_model=ml_model,
        touch_params=touch_params, guard_params=guard_params,
        policy_gate_disabled=policy_gate_disabled, escalation=escalation,
        bar0_minute=bar0_minute, volume_model=volume_model, harvest=harvest,
        sampler=sampler,
        block_len=int(block_len) if sampler == "block_bootstrap" else 0,
        antithetic=bool(antithetic))


@partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "escalation",
                     "volume_model", "policy_gate_disabled", "harvest",
                     "sampler", "block_len", "antithetic"),
)
def _portfolio_mc_engine_impl(
    key, levels, params, s0, sigma, beta, weights, hist_bars, heston_vec, *,
    num_paths, num_bars, dt, mu, block_paths, policy, ml_model, touch_params,
    guard_params, policy_gate_disabled, escalation, bar0_minute,
    volume_model, harvest, sampler, block_len, antithetic=False,
):
    if volume_model is None:
        volume_model = PG.VolumeModel()
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    n_blocks = num_paths // block_paths
    s0 = jnp.asarray(s0, jnp.float32)
    sigma = jnp.asarray(sigma, jnp.float32)
    beta = jnp.asarray(beta, jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    n_sym = s0.shape[0]
    sym_idx = jnp.arange(n_sym, dtype=jnp.uint32)
    n_skip = len(enginepath.SKIP_REASONS)

    bootstrap = sampler in ("bootstrap", "block_bootstrap")
    tabs, n_hist = _book_tables(hist_bars, n_sym) if bootstrap else (
        tuple(jnp.zeros((n_sym, 1), jnp.float32) for _ in range(5)), 0)

    def _joint_idx(km):
        return _joint_resample_idx(
            km, num_paths=block_paths, num_bars=num_bars, n_hist=n_hist,
            block_len=block_len if sampler == "block_bootstrap" else 0)

    def _boot_bars(idx, tab_row, s0s):
        return _boot_bars_from_idx(idx, tab_row, s0s,
                                   num_paths=block_paths)

    def _heston_bars(ks, z, zq, s0s):
        bars = _heston_bars_from_shocks(
            ks, z, zq, s0s, heston_vec, mu=mu, dt=dt,
            num_paths=block_paths)
        vol = volume_model.volumes(
            ks, z, num_paths=block_paths, num_bars=num_bars)
        return bars._replace(volume=vol)

    def one_block(b):
        km = prng.key_for(key, prng.STREAM_MARKET, b)
        if bootstrap:
            joint_idx = _joint_idx(km)
            z_m = zq_m = None
        else:
            z_m = _anti_normal(km, block_paths, num_bars, antithetic)
            zq_m = (jax.random.normal(
                prng.key_for(key, prng.STREAM_MARKET, b, 1),
                (block_paths, num_bars), jnp.float32)
                if sampler == "heston" else None)

        def per_symbol(carry, xs):
            port_curve, trades_tot, wins_tot, losses_tot, open_any = carry
            si, lv, s0s, sgs, bts, wts, tab_row = xs
            ks = prng.key_for(key, prng.STREAM_PATH, b, si)
            if bootstrap:
                bars = _boot_bars(joint_idx, tab_row, s0s)
            else:
                eps = _anti_normal(ks, block_paths, num_bars,
                                   antithetic)
                perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - bts * bts))
                z = bts * z_m + perp * eps
                if sampler == "heston":
                    zq_e = jax.random.normal(
                        prng.key_for(ks, prng.STREAM_PATH, 3),
                        (block_paths, num_bars), jnp.float32)
                    zq = bts * zq_m + perp * zq_e
                    bars = _heston_bars(ks, z, zq, s0s)
                else:
                    vol = volume_model.volumes(
                        ks, z, num_paths=block_paths, num_bars=num_bars)
                    bars = _bars_from_shocks(
                        z, prng.key_for(ks, prng.STREAM_BRIDGE_HI),
                        prng.key_for(ks, prng.STREAM_BRIDGE_LO),
                        s0=s0s, mu=mu, sigma=sgs, dt=dt, volume=vol)
            tie = jax.random.uniform(
                prng.key_for(ks, prng.STREAM_TIE_COIN),
                (block_paths, num_bars), jnp.float32)
            out, curve = enginepath.engine_path_replay(
                bars, lv, params, tie,
                policy=policy, ml_model=ml_model, touch_params=touch_params,
                guard_params=guard_params,
                policy_gate_disabled=policy_gate_disabled,
                escalation=escalation, bar0_minute=bar0_minute,
                harvest=harvest, return_curve=True)
            stats = PathStats.from_lifecycle(
                equity=out.equity, trades=out.trades, wins=out.wins,
                losses=out.losses, open_at_end=out.open_at_end,
                max_dd=out.max_dd)
            carry = (port_curve + wts * curve,
                     trades_tot + out.trades,
                     wins_tot + out.wins,
                     losses_tot + out.losses,
                     jnp.logical_or(open_any, out.open_at_end))
            ys = (stats, out.skip_counts, jnp.sum(out.escalations))
            if harvest:
                ys = ys + (out.harvest,)
            return carry, ys

        zero_curve = jnp.zeros((num_bars, block_paths), jnp.float32)
        zi = jnp.zeros((block_paths,), jnp.int32)
        ((port_curve, trades_tot, wins_tot, losses_tot, open_any),
         ys) = jax.lax.scan(
            per_symbol,
            (zero_curve, zi, zi, zi, jnp.zeros((block_paths,), bool)),
            (sym_idx, levels, s0, sigma, beta, weights, tabs),
        )
        sym_stats, sym_skips, sym_escal = ys[:3]
        final = port_curve[-1]
        peak = jax.lax.cummax(jnp.maximum(port_curve, 0.0), axis=0)
        port_dd = jnp.max(peak - port_curve, axis=0)
        port_stats = PathStats.from_lifecycle(
            equity=final, trades=trades_tot, wins=wins_tot,
            losses=losses_tot, open_at_end=open_any, max_dd=port_dd)
        out = (sym_stats, port_stats, sym_skips, sym_escal)
        return out + (ys[3],) if harvest else out

    def body(carry, b):
        out = one_block(b)
        new = (carry[0].merge(out[0]), carry[1].merge(out[1]),
               carry[2] + out[2], carry[3] + out[3])
        if harvest:
            new = new + (carry[4].merge(out[4]),)
        return new, None

    zero_sym = jax.vmap(
        lambda _: PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    )(sym_idx)
    zero_port = PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    init = (zero_sym, zero_port,
            jnp.zeros((n_sym, n_skip), jnp.float32),
            jnp.zeros((n_sym,), jnp.int32))
    if harvest:
        init = init + (HV.EngineHarvest.zero(n_sym),)
    final_carry, _ = jax.lax.scan(
        body, init, jnp.arange(n_blocks, dtype=jnp.uint32))
    return final_carry


def exact_tail_book(
    key,
    levels: Levels,           # batched [S, L]
    params: EngineParams,
    s0, sigma, beta, weights,  # f32[S]
    *,
    num_paths: int,
    q: float = 0.05,
    num_bars: int = 40,
    dt: float = 1.0 / (390.0 * 252.0),
    mu: float = 0.0,
    block_paths: int = 1 << 12,
    policy=None,
    ml_model=None,
    touch_params=None,
    guard_params=None,
    policy_gate_disabled: bool | None = None,
    escalation: bool = True,
    bar0_minute=0,
    volume_model: PG.VolumeModel | None = None,
    sampler: str = "gbm",
    hist_bars=None,
    block_len: int = 10,
    heston: dict | None = None,
    antithetic: bool = False,
):
    """EXACT book-level VaR/CVaR by distributed selection (sim/tailexact).

    The portfolio analog of ``tailexact.exact_tail_engine``: the k-th order
    statistic (reference index formula, qmmx_monolithic.py:3512-3525) of the
    per-path PORTFOLIO total R whose 128-bin histogram
    ``portfolio_mc_engine``'s book ``PathStats`` otherwise inverts
    approximately.  Streams the SAME blocks with the SAME PRNG keying and
    samplers as ``_portfolio_mc_engine_impl.one_block``, accumulating only
    the weighted per-symbol FINAL equities — bitwise the pipeline's
    ``port_curve[-1]``, since ``(port_curve + w·curve)[-1]`` and
    ``fin + w·equity`` are the same f32 ops in the same symbol-scan order.
    Entered = any symbol traded on the path (``trades_tot > 0``), matching
    ``PathStats.from_lifecycle``.  Returns a certified
    ``tailexact.ExactTail``; cost ≈ 6 pipeline generations (one per
    bisection pass)."""
    from ..sim import tailexact as TE

    if sampler not in ("gbm", "bootstrap", "block_bootstrap", "heston"):
        raise ValueError("exact_tail_book samplers: 'gbm' | 'bootstrap'"
                         " | 'block_bootstrap' | 'heston'")
    if sampler in ("bootstrap", "block_bootstrap"):
        if hist_bars is None:
            raise ValueError("sampler='bootstrap' requires hist_bars")
    else:
        hist_bars = None
    _check_antithetic(antithetic, sampler, block_paths)
    if volume_model is None:
        volume_model = PG.VolumeModel()
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")
    heston_vec = _heston_vec(heston)
    s0 = jnp.asarray(s0, jnp.float32)
    sigma = jnp.asarray(sigma, jnp.float32)
    beta = jnp.asarray(beta, jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    n_sym = s0.shape[0]
    sym_idx = jnp.arange(n_sym, dtype=jnp.uint32)
    blk = int(block_len) if sampler == "block_bootstrap" else 0

    bootstrap = sampler in ("bootstrap", "block_bootstrap")
    tabs, n_hist = _book_tables(hist_bars, n_sym) if bootstrap else (
        tuple(jnp.zeros((n_sym, 1), jnp.float32) for _ in range(5)), 0)

    def block_fn(b):
        km = prng.key_for(key, prng.STREAM_MARKET, b)
        if bootstrap:
            joint_idx = _joint_resample_idx(
                km, num_paths=block_paths, num_bars=num_bars,
                n_hist=n_hist, block_len=blk)
            z_m = zq_m = None
        else:
            z_m = _anti_normal(km, block_paths, num_bars, antithetic)
            zq_m = (jax.random.normal(
                prng.key_for(key, prng.STREAM_MARKET, b, 1),
                (block_paths, num_bars), jnp.float32)
                if sampler == "heston" else None)

        def per_symbol(carry, xs):
            fin, trades_tot = carry
            si, lv, s0s, sgs, bts, wts, tab_row = xs
            ks = prng.key_for(key, prng.STREAM_PATH, b, si)
            if bootstrap:
                bars = _boot_bars_from_idx(joint_idx, tab_row, s0s,
                                           num_paths=block_paths)
            else:
                eps = _anti_normal(ks, block_paths, num_bars, antithetic)
                perp = jnp.sqrt(jnp.maximum(0.0, 1.0 - bts * bts))
                z = bts * z_m + perp * eps
                if sampler == "heston":
                    zq_e = jax.random.normal(
                        prng.key_for(ks, prng.STREAM_PATH, 3),
                        (block_paths, num_bars), jnp.float32)
                    zq = bts * zq_m + perp * zq_e
                    bars = _heston_bars_from_shocks(
                        ks, z, zq, s0s, heston_vec, mu=mu, dt=dt,
                        num_paths=block_paths)
                    bars = bars._replace(volume=volume_model.volumes(
                        ks, z, num_paths=block_paths, num_bars=num_bars))
                else:
                    vol = volume_model.volumes(
                        ks, z, num_paths=block_paths, num_bars=num_bars)
                    bars = _bars_from_shocks(
                        z, prng.key_for(ks, prng.STREAM_BRIDGE_HI),
                        prng.key_for(ks, prng.STREAM_BRIDGE_LO),
                        s0=s0s, mu=mu, sigma=sgs, dt=dt, volume=vol)
            tie = jax.random.uniform(
                prng.key_for(ks, prng.STREAM_TIE_COIN),
                (block_paths, num_bars), jnp.float32)
            out = enginepath.engine_path_replay(
                bars, lv, params, tie,
                policy=policy, ml_model=ml_model, touch_params=touch_params,
                guard_params=guard_params,
                policy_gate_disabled=policy_gate_disabled,
                escalation=escalation, bar0_minute=bar0_minute)
            return (fin + wts * out.equity, trades_tot + out.trades), None

        zf = jnp.zeros((block_paths,), jnp.float32)
        zi = jnp.zeros((block_paths,), jnp.int32)
        (fin, trades_tot), _ = jax.lax.scan(
            per_symbol, (zf, zi),
            (sym_idx, levels, s0, sigma, beta, weights, tabs))
        return fin, trades_tot > 0

    cp, tp = TE._make_passes(block_fn, num_paths // block_paths)
    return TE._exact_tail_from_passes(cp, tp, q=q)
