"""Price-path samplers: GBM with Brownian-bridge bar extremes, bootstrap, antithetic.

The reference has no generative sampler — its Monte Carlo reuses one recorded bar
window and only jitters trade parameters (qmmx_monolithic.py:3449-3461).  The
rebuild's north star (BASELINE.json) adds true path sampling so robustness sweeps
draw fresh 1-minute OHLC paths:

* ``gbm_paths`` — geometric Brownian motion closes; per-bar highs/lows sampled from
  the exact law of the max/min of a Brownian bridge between consecutive log-closes
  (max: M = ((a+b) + sqrt((b-a)^2 - 2 sigma^2 dt ln U)) / 2, U ~ Uniform(0,1)),
  so generated bars have statistically consistent wicks rather than ad-hoc noise.
* ``bootstrap_paths`` — i.i.d. resampling of historical bar *relative* geometry
  (log close-to-close return, high/low/open offsets relative to prev close),
  rebased onto ``s0``; preserves the empirical bar-shape distribution.
* ``antithetic`` — pairs each path with its sign-flipped Gaussian driver for
  variance reduction (BASELINE config #3).

**Volume.** The reference engine's accumulation guard, soft volume veto and
planner features all consume per-bar volume (qmmx_monolithic.py:1268-1356,
:1773-1794, :567-612), so running the full gate stack over generated paths
needs a volume series.  Bootstrap samplers carry the *real* historical volumes
of the bars they resample; the generative samplers (GBM/Heston) synthesize one
from a ``VolumeModel``: lognormal noise around an intraday U-shape, optionally
|return|-coupled (volume spikes on large moves — all the guard needs is
realistic 5/20-bar MAs and breakout ratios).  Volume draws use their own PRNG
stream, so enabling/changing the volume model never perturbs the price paths
(bitwise).  Pipelines that ignore ``PathBars.volume`` pay nothing: XLA prunes
the dead computation under jit.

All samplers are shape-static and keyed per path via fold_in, so they vmap/shard
cleanly over the path axis.  These are the pure-XLA reference implementations; the
fused first-contact kernel (ops/triton_paths.py) draws its GBM paths in registers
from its own counter-based stream, without writing them to device memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import prng


class PathBars(NamedTuple):
    """Generated OHLCV paths: f32[paths, bars] each."""

    open: jnp.ndarray
    high: jnp.ndarray
    low: jnp.ndarray
    close: jnp.ndarray
    volume: jnp.ndarray


class VolumeModel(NamedTuple):
    """Synthetic per-bar volume for generative samplers.

    v_t = base · ushape(m_t) · LogNormal(σ=noise_sigma, mean 1)
               · (1 + ret_coupling · (|z_t| − E|z|)/sd|z|)   (floored at 0.05·base)

    where ``ushape(m) = 1 + u_amp·((2m/(D−1) − 1)² − 1/3)`` integrates to ~1
    over the ``day_minutes``-minute session (open/close heavier than midday)
    and z_t is the bar's price shock — large moves print large volume, giving
    the 5/20-bar MA spikes the breakout guard looks for (ref :1322-1330)."""

    base: float = 1.0e6
    u_amp: float = 0.6
    noise_sigma: float = 0.35
    ret_coupling: float = 0.5
    day_minutes: int = 390
    open_minute: int = 0     # minute-of-session of bar 0

    def volumes(self, key, z_ret, *, num_paths: int, num_bars: int) -> jnp.ndarray:
        """f32[num_paths, num_bars] volumes; ``z_ret`` is the (already drawn)
        per-bar standard-normal price shock, or None for uncoupled volume."""
        kv = prng.key_for(key, prng.STREAM_VOLUME)
        zv = jax.random.normal(kv, (num_paths, num_bars), jnp.float32)
        sig = jnp.float32(self.noise_sigma)
        noise = jnp.exp(sig * zv - 0.5 * sig * sig)
        m = (jnp.float32(self.open_minute)
             + jnp.arange(num_bars, dtype=jnp.float32)) % self.day_minutes
        x = 2.0 * m / jnp.float32(max(self.day_minutes - 1, 1)) - 1.0
        shape = 1.0 + jnp.float32(self.u_amp) * (x * x - jnp.float32(1.0 / 3.0))
        v = jnp.float32(self.base) * shape[None, :] * noise
        if z_ret is not None and self.ret_coupling != 0.0:
            mean_abs = math.sqrt(2.0 / math.pi)
            sd_abs = math.sqrt(1.0 - 2.0 / math.pi)
            boost = 1.0 + jnp.float32(self.ret_coupling) * (
                (jnp.abs(z_ret) - mean_abs) / sd_abs
            )
            v = v * boost
        return jnp.maximum(v, jnp.float32(0.05 * self.base))


def _bridge_extremes(key_hi, key_lo, log_a, log_b, sig2dt):
    """Sample (log_high, log_low) of a Brownian bridge from log_a to log_b with
    variance sig2dt, via inverse-CDF of the bridge max/min laws."""
    u = jax.random.uniform(key_hi, log_a.shape, jnp.float32, 1e-12, 1.0)
    v = jax.random.uniform(key_lo, log_a.shape, jnp.float32, 1e-12, 1.0)
    d2 = (log_b - log_a) ** 2
    log_hi = 0.5 * (log_a + log_b + jnp.sqrt(d2 - 2.0 * sig2dt * jnp.log(u)))
    log_lo = 0.5 * (log_a + log_b - jnp.sqrt(d2 - 2.0 * sig2dt * jnp.log(v)))
    return log_hi, log_lo


def gbm_paths(
    key: jax.Array,
    *,
    num_paths: int,
    num_bars: int,
    s0,
    mu: float = 0.0,
    sigma: float = 0.15,
    dt: float = 1.0 / (390.0 * 252.0),
    antithetic: bool = False,
    volume_model: VolumeModel | None = None,
) -> PathBars:
    """GBM 1-minute OHLC paths.  With ``antithetic`` the second half of the path
    axis reuses the first half's normals negated (num_paths must be even).
    Volumes come from ``volume_model`` (default ``VolumeModel()``), coupled to
    the close-to-close shock; the volume stream is independent of the price
    streams, so prices are bitwise-stable across volume-model changes."""
    if volume_model is None:
        volume_model = VolumeModel()
    if antithetic and num_paths % 2 != 0:
        raise ValueError("antithetic requires an even num_paths")
    n_draw = num_paths // 2 if antithetic else num_paths

    kz = prng.key_for(key, prng.STREAM_PATH)
    khi = prng.key_for(key, prng.STREAM_BRIDGE_HI)
    klo = prng.key_for(key, prng.STREAM_BRIDGE_LO)

    z = jax.random.normal(kz, (n_draw, num_bars), jnp.float32)
    if antithetic:
        z = jnp.concatenate([z, -z], axis=0)

    sig_dt = jnp.float32(sigma) * jnp.sqrt(jnp.float32(dt))
    drift = jnp.float32(mu - 0.5 * sigma * sigma) * jnp.float32(dt)
    log_s0 = jnp.log(jnp.asarray(s0, jnp.float32))
    log_close = log_s0 + jnp.cumsum(drift + sig_dt * z, axis=-1)
    log_open = jnp.concatenate(
        [jnp.full((num_paths, 1), log_s0, jnp.float32), log_close[:, :-1]], axis=-1
    )

    # Bridge extremes are drawn fresh for every path (antithetic pairing applies to
    # the close-to-close driver only).
    sig2dt = sig_dt * sig_dt
    log_hi, log_lo = _bridge_extremes(khi, klo, log_open, log_close, sig2dt)
    volume = volume_model.volumes(key, z, num_paths=num_paths, num_bars=num_bars)
    return PathBars(
        open=jnp.exp(log_open),
        high=jnp.exp(log_hi),
        low=jnp.exp(log_lo),
        close=jnp.exp(log_close),
        volume=volume,
    )


def bootstrap_tables(hist_open, hist_high, hist_low, hist_close,
                     hist_volume=None):
    """Per-bar relative geometry of a recorded history, the shared precompute
    of every bootstrap sampler (XLA and fused-kernel): log return vs prev
    close plus log offsets of high/low/open vs prev close, and the REAL
    per-bar volume.  Returns (logc, logh, logl, logo, vol), f32[H] each."""
    hist_close = jnp.asarray(hist_close, jnp.float32)
    prev_close = jnp.concatenate([hist_close[:1], hist_close[:-1]])
    logc = jnp.log(hist_close / prev_close)
    logh = jnp.log(jnp.asarray(hist_high, jnp.float32) / prev_close)
    logl = jnp.log(jnp.asarray(hist_low, jnp.float32) / prev_close)
    logo = jnp.log(jnp.asarray(hist_open, jnp.float32) / prev_close)
    vol = (jnp.zeros_like(hist_close) if hist_volume is None
           else jnp.asarray(hist_volume, jnp.float32))
    return logc, logh, logl, logo, vol


def bootstrap_paths(
    key: jax.Array,
    *,
    hist_open: jnp.ndarray,
    hist_high: jnp.ndarray,
    hist_low: jnp.ndarray,
    hist_close: jnp.ndarray,
    num_paths: int,
    num_bars: int,
    s0,
    hist_volume: jnp.ndarray | None = None,
) -> PathBars:
    """Resample historical bar geometry with replacement and rebase onto ``s0``.

    Each historical bar contributes (r, ho, lo, oo): log return vs prev close and
    log offsets of high/low/open vs prev close.  Sampled bars chain multiplicatively.
    Each sampled bar carries its REAL historical volume (``hist_volume[idx]``;
    zeros when no volume history is provided).
    """
    hist_close = jnp.asarray(hist_close, jnp.float32)
    prev_close = jnp.concatenate([hist_close[:1], hist_close[:-1]])
    logc = jnp.log(hist_close / prev_close)
    logh = jnp.log(jnp.asarray(hist_high, jnp.float32) / prev_close)
    logl = jnp.log(jnp.asarray(hist_low, jnp.float32) / prev_close)
    logo = jnp.log(jnp.asarray(hist_open, jnp.float32) / prev_close)
    vol = (jnp.zeros_like(hist_close) if hist_volume is None
           else jnp.asarray(hist_volume, jnp.float32))

    kb = prng.key_for(key, prng.STREAM_BOOTSTRAP)
    idx = jax.random.randint(kb, (num_paths, num_bars), 0, hist_close.shape[0])
    r = logc[idx]
    log_prev = jnp.log(jnp.asarray(s0, jnp.float32)) + jnp.concatenate(
        [jnp.zeros((num_paths, 1), jnp.float32), jnp.cumsum(r[:, :-1], axis=-1)], axis=-1
    )
    return PathBars(
        open=jnp.exp(log_prev + logo[idx]),
        high=jnp.exp(log_prev + logh[idx]),
        low=jnp.exp(log_prev + logl[idx]),
        close=jnp.exp(log_prev + r),
        volume=vol[idx],
    )


def block_bootstrap_paths(
    key: jax.Array,
    *,
    hist_open: jnp.ndarray,
    hist_high: jnp.ndarray,
    hist_low: jnp.ndarray,
    hist_close: jnp.ndarray,
    num_paths: int,
    num_bars: int,
    s0,
    block_len: int = 10,
    hist_volume: jnp.ndarray | None = None,
) -> PathBars:
    """Block bootstrap: resample contiguous ``block_len``-bar runs of historical
    bar geometry, preserving short-range dependence (vol clustering, intraday
    momentum) that i.i.d. resampling destroys.  Blocks chain multiplicatively
    like ``bootstrap_paths``; real historical volumes ride along per bar."""
    hist_close = jnp.asarray(hist_close, jnp.float32)
    n_hist = hist_close.shape[0]
    if n_hist <= block_len:
        raise ValueError("history shorter than block_len")
    prev_close = jnp.concatenate([hist_close[:1], hist_close[:-1]])
    logc = jnp.log(hist_close / prev_close)
    logh = jnp.log(jnp.asarray(hist_high, jnp.float32) / prev_close)
    logl = jnp.log(jnp.asarray(hist_low, jnp.float32) / prev_close)
    logo = jnp.log(jnp.asarray(hist_open, jnp.float32) / prev_close)
    vol = (jnp.zeros_like(hist_close) if hist_volume is None
           else jnp.asarray(hist_volume, jnp.float32))

    n_blocks = -(-num_bars // block_len)
    kb = prng.key_for(key, prng.STREAM_BOOTSTRAP)
    starts = jax.random.randint(kb, (num_paths, n_blocks), 0, n_hist - block_len)
    offs = jnp.arange(block_len)
    idx = (starts[:, :, None] + offs[None, None, :]).reshape(num_paths, -1)
    idx = idx[:, :num_bars]

    r = logc[idx]
    log_prev = jnp.log(jnp.asarray(s0, jnp.float32)) + jnp.concatenate(
        [jnp.zeros((num_paths, 1), jnp.float32), jnp.cumsum(r[:, :-1], axis=-1)],
        axis=-1,
    )
    return PathBars(
        open=jnp.exp(log_prev + logo[idx]),
        high=jnp.exp(log_prev + logh[idx]),
        low=jnp.exp(log_prev + logl[idx]),
        close=jnp.exp(log_prev + r),
        volume=vol[idx],
    )


def heston_paths(
    key: jax.Array,
    *,
    num_paths: int,
    num_bars: int,
    s0,
    v0: float = 0.04,
    kappa: float = 3.0,
    theta: float = 0.04,
    xi: float = 0.6,
    rho: float = -0.7,
    mu: float = 0.0,
    dt: float = 1.0 / (390.0 * 252.0),
    antithetic: bool = False,
    volume_model: VolumeModel | None = None,
) -> PathBars:
    """Heston stochastic-volatility paths (full-truncation Euler) with bridge
    bar extremes using each bar's local vol.  Produces the vol clustering and
    leverage effect GBM cannot; drops into the same replay/reduction pipeline.
    Volumes are synthesized from ``volume_model`` coupled to the price shock."""
    if volume_model is None:
        volume_model = VolumeModel()
    if antithetic and num_paths % 2 != 0:
        raise ValueError("antithetic requires an even num_paths")
    n_draw = num_paths // 2 if antithetic else num_paths

    kz = prng.key_for(key, prng.STREAM_PATH, 1)
    kv = prng.key_for(key, prng.STREAM_PATH, 2)
    z1 = jax.random.normal(kz, (n_draw, num_bars), jnp.float32)
    zv = jax.random.normal(kv, (n_draw, num_bars), jnp.float32)
    if antithetic:
        z1 = jnp.concatenate([z1, -z1], axis=0)
        zv = jnp.concatenate([zv, -zv], axis=0)
    rho = jnp.float32(rho)
    z2 = rho * z1 + jnp.sqrt(1.0 - rho * rho) * zv  # vol shock corr w/ price

    dtf = jnp.float32(dt)

    def step(carry, zs):
        logp, v = carry
        z_s, z_v = zs
        v_pos = jnp.maximum(v, 0.0)
        sig_dt = jnp.sqrt(v_pos * dtf)
        logp_new = logp + (jnp.float32(mu) - 0.5 * v_pos) * dtf + sig_dt * z_s
        v_new = v + jnp.float32(kappa) * (jnp.float32(theta) - v_pos) * dtf \
            + jnp.float32(xi) * sig_dt * z_v
        return (logp_new, v_new), (logp_new, sig_dt)

    log_s0 = jnp.log(jnp.asarray(s0, jnp.float32))
    init = (jnp.full((num_paths,), log_s0), jnp.full((num_paths,), jnp.float32(v0)))
    (_, _), (log_close_t, sig_dt_t) = jax.lax.scan(
        step, init, (z1.T, z2.T)
    )
    log_close = log_close_t.T                     # [P, W]
    sig_dt = sig_dt_t.T
    log_open = jnp.concatenate(
        [jnp.full((num_paths, 1), log_s0), log_close[:, :-1]], axis=-1
    )

    khi = prng.key_for(key, prng.STREAM_BRIDGE_HI, 1)
    klo = prng.key_for(key, prng.STREAM_BRIDGE_LO, 1)
    log_hi, log_lo = _bridge_extremes(khi, klo, log_open, log_close, sig_dt * sig_dt)
    volume = volume_model.volumes(key, z1, num_paths=num_paths, num_bars=num_bars)
    return PathBars(
        open=jnp.exp(log_open), high=jnp.exp(log_hi),
        low=jnp.exp(log_lo), close=jnp.exp(log_close),
        volume=volume,
    )
