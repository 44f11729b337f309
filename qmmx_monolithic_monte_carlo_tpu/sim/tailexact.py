"""EXACT tail quantiles (VaR/CVaR) at path scale — distributed selection.

The reference computes the exact 5th-percentile VaR and tail-mean CVaR by
sorting per-trial totals (qmmx_monolithic.py:3512-3525):

    p05_idx = max(0, int(0.05 * T) - 1)
    var_05  = sorted_totals[p05_idx]
    cvar_05 = mean(sorted_totals[: p05_idx + 1])

At trial scale the repo keeps that formula verbatim (sim/summary.py).  At
path scale a sort of 1e9 per-path totals is not an option, and rounds 1-4
substituted a 128-bin histogram CDF inversion (PathStats.quantile/cvar) —
an *approximation*.  This module replaces it with an EXACT, psum-mergeable
scheme (SURVEY §7's "distributed selection"):

* Order-preserving lattice.  f32 under IEEE total order maps monotonically
  onto int32 (sign-magnitude flip), so the k-th smallest f32 equals the
  k-th smallest lattice key.  Selection happens on the integer lattice.
* 128-ary count bisection.  Each device pass streams the SAME path blocks
  as the corresponding pipeline (identical PRNG keying) and bin-counts
  entered-path equities over 128 lattice sub-ranges in i32 (exact for
  n < 2^31 paths; counts are associative, so shard merges are too).  The
  host narrows the bracket to the bin containing global rank k and
  re-passes; a 2^32-wide lattice resolves to a SINGLE lattice value — the
  exact order statistic — in ceil(log_128(2^32)) + 1 <= 6 passes.
* Certificate.  A final pass returns count(x < v) and count(x <= v); the
  result is accepted only if count_lt < k <= count_le — a machine-checkable
  proof of exactness that needs no sort (used as-is at 2^30 on hardware,
  where a sorted oracle cannot exist).
* Exact-split tail sum for CVaR.  The same final pass accumulates
  sum(x < v) with each value split EXACTLY as v = hi + lo, hi = rint(v·2^12)
  / 2^12 (the difference is representable whenever |v| <= 2048 — checked on
  device): the hi parts travel as two i32 channels (12-bit carry split, so
  per-block sums stay exact in i32), the lo residuals (|lo| <= 2^-13) as a
  per-block f32 sum.  The host merges per-block partials in f64; the only
  inexactness is the per-block f32 reduction of residuals, bounded by
  blocks · 2^-19 — orders of magnitude below one ulp of the final f32 CVaR
  at every supported scale.  CVaR then follows from the order statistic:
  mean of the k smallest = (sum_lt + (k - count_lt) · v_k) / k (ties sit AT
  v_k by definition of the k-th order statistic).

The per-surface entry points (`exact_tail_paths`, `exact_tail_gated`,
`exact_tail_engine`) re-simulate the exact block/key layout of
``pathsim.mc_paths`` / ``gatedpath.mc_paths_gated`` / ``enginepath.
mc_paths_engine``, so the reported tail is the tail of the very same path
population those pipelines aggregate.  Each pass is one jitted scan; the
pass count is ~6, so exact tails cost ~6x one pipeline run's generation
(still seconds at 2^30 on the chip).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NB = 128                 # bins per bisection pass (one accumulator row)
_I32_MIN = -(2 ** 31)
_EQ_LIMIT = 2048.0       # |equity| bound for the exact hi/lo split (2^11)


# --------------------------------------------------------------------------
# f32 <-> ordered int32 lattice
# --------------------------------------------------------------------------

def lattice_keys(x) -> jnp.ndarray:
    """Monotone f32 -> int32: a < b (as floats) iff key(a) < key(b).

    Non-negative floats keep their bit pattern (already increasing);
    negative floats (int32 bit pattern b < 0) map to INT32_MIN - b, which
    decreases as the bit pattern grows — i.e. increases with the float.
    -0.0 and +0.0 both map to 0."""
    b = jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.int32)
    return jnp.where(b >= 0, b, jnp.int32(_I32_MIN) - b)


def key_of(x: float) -> int:
    """Host-side lattice key of one f32 value (Python int)."""
    b = int(np.float32(x).view(np.int32))
    return b if b >= 0 else _I32_MIN - b


def value_of(k: int) -> float:
    """Host-side inverse of ``key_of``."""
    b = k if k >= 0 else _I32_MIN - k
    return float(np.int32(b).view(np.float32))


def exact_tail_rank(n_entered: int, q: float = 0.05) -> int:
    """Rank k (1-based k-th smallest) of the reference's exact index formula
    sorted[max(0, int(q*T) - 1)] (qmmx_monolithic.py:3512-3525)."""
    return max(0, int(q * n_entered) - 1) + 1


# --------------------------------------------------------------------------
# device passes over a block-equity function
# --------------------------------------------------------------------------

def _make_passes(block_fn, n_blocks: int):
    """Build the two jitted device passes over ``block_fn(b) -> (equity f32[P],
    entered bool[P])``.  Each compiles ONCE; bracket parameters are traced
    i32 scalars so every bisection step reuses the executable.

    ``optimization_barrier`` fences the generate+replay subgraph from the
    pass-specific reductions: both executables then lower the IDENTICAL
    population subgraph, so every bisection step and the certificate pass
    select over the same equities.  (Without the fence, XLA's consumer-driven
    fusion can flip O(ulp) transcendental boundary decisions between
    programs on accelerator backends: a few paths in 10^4 can move between
    the stats program and an unfenced tail pass.  The same
    effect can still shift a handful of paths between THESE passes and a
    separately-compiled aggregate pipeline run; the certificate proves the
    rank within the selection population itself.)"""

    def fenced(b):
        return jax.lax.optimization_barrier(block_fn(b))

    @jax.jit
    def counts_pass(lo_k, step, hi_clamp):
        """(below, counts[NB]): below = #entered with key < lo_k (GLOBAL —
        ranks need no carried bracket state); counts[j] = #entered with
        key in [lo_k + j*step, lo_k + (j+1)*step) ∩ [lo_k, hi_clamp]."""
        def body(carry, b):
            below, counts = carry
            eq, ent = fenced(b)
            key = lattice_keys(eq)
            below = below + jnp.sum(
                jnp.where(jnp.logical_and(ent, key < lo_k), 1, 0))
            in_b = jnp.logical_and(
                ent, jnp.logical_and(key >= lo_k, key <= hi_clamp))
            # clip BEFORE subtracting: key - lo_k alone can overflow i32
            kk = jnp.clip(key, lo_k, hi_clamp)
            idx = jnp.clip((kk - lo_k) // step, 0, NB - 1)
            counts = counts.at[idx].add(jnp.where(in_b, 1, 0))
            return (below, counts), None

        init = (jnp.zeros((), jnp.int32), jnp.zeros((NB,), jnp.int32))
        (below, counts), _ = jax.lax.scan(
            body, init, jnp.arange(n_blocks, dtype=jnp.uint32))
        return below, counts

    @jax.jit
    def tail_pass(vk):
        """Per-block certificate + exact-split tail-sum partials at key vk."""
        def body(_, b):
            eq, ent = fenced(b)
            key = lattice_keys(eq)
            lt = jnp.logical_and(ent, key < vk)
            le = jnp.logical_and(ent, key <= vk)
            vals = jnp.where(lt, eq, 0.0)
            oob = jnp.sum(jnp.where(
                jnp.logical_and(lt, jnp.abs(vals) > _EQ_LIMIT), 1, 0))
            ihi = jnp.round(vals * 4096.0).astype(jnp.int32)   # exact int
            vlo = vals - ihi.astype(jnp.float32) * (1.0 / 4096.0)  # exact
            ys = (
                jnp.sum(jnp.where(lt, 1, 0)),
                jnp.sum(jnp.where(le, 1, 0)),
                # 12-bit carry split keeps per-block i32 sums exact:
                # |ihi| <= 2048*4096 = 2^23, so hi parts are <= 2^11 and
                # 2^16-path blocks sum to < 2^27; low parts < 2^16 * 4096.
                jnp.sum(ihi >> 12),
                jnp.sum(ihi & 4095),
                jnp.sum(vlo),
                oob,
            )
            return 0, ys

        _, ys = jax.lax.scan(body, 0, jnp.arange(n_blocks, dtype=jnp.uint32))
        return ys

    return counts_pass, tail_pass


# --------------------------------------------------------------------------
# host-side driver
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ExactTail:
    """Exact path-scale tail: the k-th order statistic of entered-path total
    R under the reference index formula, with its proof-of-rank certificate."""

    var: float          # exact k-th smallest entered equity (f32 value)
    cvar: float         # mean of the k smallest (f64 arithmetic, f32 cast)
    k: int              # 1-based rank (exact_tail_rank)
    n_entered: int
    count_lt: int       # entered equities strictly below var
    count_le: int       # entered equities at or below var
    passes: int         # device passes spent (bisection + certificate)

    @property
    def certified(self) -> bool:
        """count_lt < k <= count_le: machine-checkable exactness proof."""
        return self.count_lt < self.k <= self.count_le


def _exact_tail_from_passes(counts_pass, tail_pass, *, q: float) -> ExactTail:
    # total-entered pass anchored at 0 so (key - lo) never overflows i32:
    # below = all negatives, bins cover every non-negative finite key
    below0, counts0 = counts_pass(
        jnp.int32(0), jnp.int32(2 ** 24), jnp.int32(2 ** 31 - 2))
    n_entered = int(below0) + int(np.asarray(counts0, np.int64).sum())
    if n_entered == 0:
        return ExactTail(var=float("nan"), cvar=float("nan"), k=0,
                         n_entered=0, count_lt=0, count_le=0, passes=1)
    k = exact_tail_rank(n_entered, q)

    lo, hi = _I32_MIN + 1, 2 ** 31 - 1   # full finite-f32 lattice
    passes = 1
    while lo < hi:
        span = hi - lo + 1
        blo = 0 if (span > 2 ** 31 - NB and lo < 0 <= hi) else lo
        step = -(-(hi - blo + 1) // NB)
        hi_clamp = min(blo + step * NB - 1, hi)
        below, counts = counts_pass(
            jnp.int32(blo), jnp.int32(step), jnp.int32(hi_clamp))
        below = int(below)
        counts = np.asarray(counts, np.int64)
        passes += 1
        if k <= below:                     # only reachable in the 0-split
            hi = blo - 1
            continue
        c = below
        for j in range(NB):
            c += int(counts[j])
            if k <= c:
                lo = blo + j * step
                hi = min(blo + (j + 1) * step - 1, hi)
                break
        else:
            raise AssertionError(
                f"rank {k} beyond counted population ({c}) — "
                "block_fn disagrees with itself across passes")

    vk = value_of(lo)
    ys = tail_pass(jnp.int32(lo))
    cnt_lt, cnt_le, ihi_hi, ihi_lo = (np.asarray(y, np.int64) for y in ys[:4])
    vlo = np.asarray(ys[4], np.float64)
    oob = np.asarray(ys[5], np.int64)
    passes += 1
    if int(oob.sum()):
        raise ValueError(
            f"{int(oob.sum())} tail equities exceed |R| = {_EQ_LIMIT}: the "
            "exact-split CVaR sum precondition fails (raise _EQ_LIMIT)")
    count_lt, count_le = int(cnt_lt.sum()), int(cnt_le.sum())
    if not (count_lt < k <= count_le):
        raise AssertionError(
            f"selection certificate failed: count_lt={count_lt} k={k} "
            f"count_le={count_le}")
    sum_lt = (float(ihi_hi.sum() * 4096 + ihi_lo.sum()) / 4096.0
              + float(vlo.sum()))
    cvar = np.float32((sum_lt + (k - count_lt) * float(np.float32(vk))) / k)
    return ExactTail(var=vk, cvar=float(cvar), k=k, n_entered=n_entered,
                     count_lt=count_lt, count_le=count_le, passes=passes)


# --------------------------------------------------------------------------
# per-surface block-equity functions (keying mirrors the pipelines exactly)
# --------------------------------------------------------------------------

def exact_tail_paths(key, levels, params, *, num_paths: int, q: float = 0.05,
                     num_bars: int = 40, s0=100.0, mu: float = 0.0,
                     sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                     sampler: str = "gbm", hist_bars=None,
                     block_paths: int = 1 << 16, antithetic: bool = False,
                     block_len: int = 10, heston=None, noise=None,
                     volume_model=None) -> ExactTail:
    """Exact VaR/CVaR of the first-contact population ``pathsim.mc_paths``
    aggregates (same key/block layout; per-path single-trade R)."""
    from . import pathsim
    from ..utils import prng

    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")

    def block_fn(b):
        bkey = prng.key_for(key, prng.STREAM_PATH, b)
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
            sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
            antithetic=antithetic, block_len=block_len, heston=heston,
            volume_model=volume_model)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths,),
            jnp.float32)
        draws = (pathsim.noise_normals(bkey, (block_paths,))
                 if noise is not None else None)
        r, _, entered = pathsim.path_replay(
            paths, levels, params, tie, noise=noise, noise_normals=draws)
        return r, entered

    cp, tp = _make_passes(block_fn, num_paths // block_paths)
    return _exact_tail_from_passes(cp, tp, q=q)


def exact_tail_gated(key, levels, params, gate=None, *, num_paths: int,
                     q: float = 0.05, num_bars: int = 40, s0=100.0,
                     mu: float = 0.0, sigma: float = 0.15,
                     dt: float = 1.0 / (390.0 * 252.0), sampler: str = "gbm",
                     hist_bars=None, block_paths: int = 1 << 16,
                     antithetic: bool = False, block_len: int = 10,
                     heston=None, noise=None, volume_model=None) -> ExactTail:
    """Exact VaR/CVaR of the gated-lifecycle population
    ``gatedpath.mc_paths_gated`` aggregates (per-path TOTAL R)."""
    from . import gatedpath, pathsim
    from ..utils import prng

    if gate is None:
        gate = gatedpath.GateConfig.from_params(params)
    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")

    def block_fn(b):
        bkey = prng.key_for(key, prng.STREAM_PATH, b)
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
            sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
            antithetic=antithetic, block_len=block_len, heston=heston,
            volume_model=volume_model)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN),
            (block_paths, num_bars), jnp.float32)
        draws = (pathsim.noise_normals(bkey, (block_paths, num_bars))
                 if noise is not None else None)
        out = gatedpath.gated_path_replay(paths, levels, params, gate, tie,
                                          noise=noise, noise_normals=draws)
        return out.equity, out.trades > 0

    cp, tp = _make_passes(block_fn, num_paths // block_paths)
    return _exact_tail_from_passes(cp, tp, q=q)


def exact_tail_engine(key, levels, params, *, num_paths: int, q: float = 0.05,
                      num_bars: int = 40, s0=100.0, mu: float = 0.0,
                      sigma: float = 0.15, dt: float = 1.0 / (390.0 * 252.0),
                      sampler: str = "gbm", hist_bars=None,
                      block_paths: int = 1 << 13, antithetic: bool = False,
                      block_len: int = 10, heston=None, policy=None,
                      ml_model=None, touch_params=None, guard_params=None,
                      policy_gate_disabled=None, escalation: bool = True,
                      bar0_minute=0, noise=None,
                      volume_model=None) -> ExactTail:
    """Exact VaR/CVaR of the FULL-ENGINE population
    ``enginepath.mc_paths_engine`` aggregates (per-path TOTAL R under the
    12-gate ladder)."""
    from . import enginepath, pathsim
    from ..utils import prng

    if num_paths % block_paths != 0:
        raise ValueError("num_paths must be a multiple of block_paths")

    def block_fn(b):
        bkey = prng.key_for(key, prng.STREAM_PATH, b)
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, num_bars=num_bars, s0=s0, mu=mu,
            sigma=sigma, dt=dt, sampler=sampler, hist_bars=hist_bars,
            antithetic=antithetic, block_len=block_len, heston=heston,
            volume_model=volume_model)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN),
            (block_paths, num_bars), jnp.float32)
        draws = (pathsim.noise_normals(bkey, (block_paths, num_bars))
                 if noise is not None else None)
        out = enginepath.engine_path_replay(
            paths, levels, params, tie, policy=policy, ml_model=ml_model,
            touch_params=touch_params, guard_params=guard_params,
            policy_gate_disabled=policy_gate_disabled, escalation=escalation,
            bar0_minute=bar0_minute, noise=noise, noise_normals=draws)
        return out.equity, out.trades > 0

    cp, tp = _make_passes(block_fn, num_paths // block_paths)
    return _exact_tail_from_passes(cp, tp, q=q)
