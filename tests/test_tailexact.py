"""Exact path-scale VaR/CVaR (sim/tailexact.py) vs sorted oracles.

The contract (qmmx_monolithic.py:3512-3525, SURVEY §7 "distributed
selection"): VaR is BITWISE the k-th smallest entered-path total R under the
reference index formula k = max(0, int(0.05*T) - 1) + 1, and CVaR is the
mean of those k values (f64 arithmetic, f32 result).  The oracle here sorts
the very same per-path populations the streaming pipelines aggregate
(identical PRNG keying, block by block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.sim import (
    enginepath,
    gatedpath,
    pathsim,
    tailexact,
)
from qmmx_monolithic_monte_carlo_tpu.types import Levels
from qmmx_monolithic_monte_carlo_tpu.utils import prng

LEVELS = Levels.from_rows(
    [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.5},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.5},
    ],
    max_levels=8,
)


def _oracle(equities: np.ndarray, q: float):
    """Reference formula over the entered-path population (f64 tail mean)."""
    s = np.sort(equities)
    k = tailexact.exact_tail_rank(len(s), q)
    var = s[k - 1]
    cvar = np.float32(np.sum(s[:k], dtype=np.float64) / k)
    return float(var), float(cvar), k


def _first_contact_equities(key, num_paths, block_paths, **kw):
    out = []
    for b in range(num_paths // block_paths):
        bkey = prng.key_for(key, prng.STREAM_PATH, jnp.uint32(b))
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, s0=100.0, mu=0.0,
            dt=1.0 / (390.0 * 252.0), sampler="gbm", hist_bars=None,
            antithetic=False, **kw)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths,),
            jnp.float32)
        r, _, entered = pathsim.path_replay(
            paths, LEVELS, EngineParams.default(), tie)
        out.append(np.asarray(r)[np.asarray(entered)])
    return np.concatenate(out)


def test_lattice_keys_are_order_preserving():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(0, 3, 512).astype(np.float32),
        np.float32([0.0, -0.0, 1e-38, -1e-38, 6.5, -6.0, 1e-30, -1e-30]),
    ])
    keys = np.asarray(tailexact.lattice_keys(jnp.asarray(vals)))
    order_v = np.argsort(vals, kind="stable")
    # sorting by key must sort the values (ties: 0.0 vs -0.0 compare equal)
    assert np.array_equal(np.sort(vals), vals[np.argsort(keys, kind="stable")])
    del order_v
    for v in vals:
        k = tailexact.key_of(float(v))
        assert tailexact.value_of(k) == float(np.float32(v))
        assert int(keys[np.where(vals == v)[0][0]]) == k or v != v


@pytest.mark.parametrize("q", [0.05, 0.01, 0.5])
def test_first_contact_exact_tail_matches_sorted_oracle(q):
    key = jax.random.key(7)
    num_paths, block_paths = 1 << 16, 1 << 14
    kw = dict(num_bars=40, sigma=0.3)
    tail = tailexact.exact_tail_paths(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, q=q, **kw)
    eq = _first_contact_equities(key, num_paths, block_paths,
                                 num_bars=40, sigma=0.3)
    var, cvar, k = _oracle(eq, q)
    assert tail.n_entered == len(eq)
    assert tail.k == k
    assert tail.var == var, "VaR must be BITWISE the k-th order statistic"
    assert tail.cvar == cvar, "CVaR must match the f64 tail mean bitwise"
    assert tail.certified
    assert tail.passes <= 8
    # the streaming pipeline aggregates the same population
    stats = pathsim.mc_paths(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, **kw)
    assert int(stats.n_entered) == tail.n_entered
    bin_w = (stats.hist_hi - stats.hist_lo) / stats.hist.shape[-1]
    assert abs(float(stats.quantile(q)) - tail.var) <= 2 * bin_w


@pytest.mark.slow
def test_first_contact_exact_tail_large_population():
    """2^20 paths, bitwise vs np.sort."""
    key = jax.random.key(3)
    num_paths, block_paths = 1 << 20, 1 << 16
    tail = tailexact.exact_tail_paths(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, num_bars=40, sigma=0.3)
    eq = _first_contact_equities(key, num_paths, block_paths,
                                 num_bars=40, sigma=0.3)
    var, cvar, k = _oracle(eq, 0.05)
    assert tail.n_entered == len(eq) and tail.k == k
    assert tail.var == var
    assert tail.cvar == cvar
    assert tail.certified


def test_gated_exact_tail_handles_ties():
    """Gated lifecycle totals repeat heavily (sums of identical trade Rs) —
    the certificate must hold with count_lt < k <= count_le straddling the
    tied value."""
    key = jax.random.key(11)
    num_paths, block_paths = 1 << 14, 1 << 12
    tail = tailexact.exact_tail_gated(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, num_bars=40, sigma=0.3)
    # oracle straight from the gated replay blocks
    out = []
    for b in range(num_paths // block_paths):
        bkey = prng.key_for(key, prng.STREAM_PATH, jnp.uint32(b))
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, num_bars=40, sigma=0.3,
            s0=100.0, mu=0.0, dt=1.0 / (390.0 * 252.0), sampler="gbm",
            hist_bars=None, antithetic=False)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths, 40),
            jnp.float32)
        o = gatedpath.gated_path_replay(
            paths, LEVELS, EngineParams.default(),
            gatedpath.GateConfig.from_params(EngineParams.default()), tie)
        out.append(np.asarray(o.equity)[np.asarray(o.trades) > 0])
    eq = np.concatenate(out)
    var, cvar, k = _oracle(eq, 0.05)
    assert tail.n_entered == len(eq) and tail.k == k
    assert tail.var == var
    assert tail.cvar == cvar
    assert tail.certified
    # tie diagnostics are real counts from the population
    assert tail.count_le >= tail.count_lt + 1
    assert tail.count_le == int(np.sum(eq <= var))
    assert tail.count_lt == int(np.sum(eq < var))


def test_engine_exact_tail_matches_sorted_oracle():
    key = jax.random.key(5)
    num_paths, block_paths = 1 << 12, 1 << 11
    tail = tailexact.exact_tail_engine(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, num_bars=40, sigma=0.3)
    out = []
    for b in range(num_paths // block_paths):
        bkey = prng.key_for(key, prng.STREAM_PATH, jnp.uint32(b))
        paths = pathsim.sample_block(
            bkey, block_paths=block_paths, num_bars=40, sigma=0.3,
            s0=100.0, mu=0.0, dt=1.0 / (390.0 * 252.0), sampler="gbm",
            hist_bars=None, antithetic=False)
        tie = jax.random.uniform(
            prng.key_for(bkey, prng.STREAM_TIE_COIN), (block_paths, 40),
            jnp.float32)
        o = enginepath.engine_path_replay(
            paths, LEVELS, EngineParams.default(), tie)
        out.append(np.asarray(o.equity)[np.asarray(o.trades) > 0])
    eq = np.concatenate(out)
    var, cvar, k = _oracle(eq, 0.05)
    assert tail.n_entered == len(eq) and tail.k == k
    assert tail.var == var
    assert tail.cvar == cvar
    assert tail.certified
    # cross-check vs the streaming pipeline's own aggregation
    stats, _, _ = enginepath.mc_paths_engine(
        key, LEVELS, EngineParams.default(), num_paths=num_paths,
        block_paths=block_paths, num_bars=40, sigma=0.3)
    assert int(stats.n_entered) == tail.n_entered


def test_exact_tail_rank_formula():
    # reference: p05_idx = max(0, int(0.05*T) - 1); k = idx + 1
    assert tailexact.exact_tail_rank(0) == 1  # degenerate, guarded upstream
    assert tailexact.exact_tail_rank(1) == 1
    assert tailexact.exact_tail_rank(19) == 1
    assert tailexact.exact_tail_rank(20) == 1
    assert tailexact.exact_tail_rank(40) == 2
    assert tailexact.exact_tail_rank(1 << 20, 0.05) == int(0.05 * (1 << 20))


@pytest.mark.slow
def test_book_exact_tail_matches_sorted_oracle():
    """exact_tail_book (round 5): the certified selection over per-path
    PORTFOLIO totals is bitwise the sorted oracle of the weighted
    per-symbol finals rebuilt with the pipeline's own block keying, and
    the aggregate book PathStats counts the identical population."""
    from qmmx_monolithic_monte_carlo_tpu.parallel import portfolio as PF
    from qmmx_monolithic_monte_carlo_tpu.parallel.universe import stack_levels

    lv = stack_levels([
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
         {"color": "teal", "type": "solid", "index": 0, "price": 99.4}],
        [{"color": "orange", "type": "dashed", "index": 0, "price": 50.3}],
    ], max_levels=4)
    s0 = np.float32([100.0, 50.0])
    sigma = np.float32([0.3, 0.4])
    beta = np.float32([0.8, 0.6])
    wts = np.float32([0.5, 0.5])
    params = EngineParams.default()
    key = jax.random.key(23)
    num_paths, block_paths, w = 1 << 12, 1 << 10, 24

    tail = PF.exact_tail_book(
        key, lv, params, s0, sigma, beta, wts, num_paths=num_paths,
        block_paths=block_paths, num_bars=w)

    # oracle: rebuild the weighted book finals block by block with the
    # impl's documented keying (STREAM_MARKET/b market shocks,
    # STREAM_PATH/(b, si) idiosyncratic + tie streams)
    fins, ents = [], []
    for b in range(num_paths // block_paths):
        km = prng.key_for(key, prng.STREAM_MARKET, jnp.uint32(b))
        z_m = jax.random.normal(km, (block_paths, w), jnp.float32)
        fin = np.zeros((block_paths,), np.float32)
        trades = np.zeros((block_paths,), np.int32)
        for si in range(2):
            ks = prng.key_for(key, prng.STREAM_PATH, jnp.uint32(b),
                              jnp.uint32(si))
            eps = jax.random.normal(ks, (block_paths, w), jnp.float32)
            bts = jnp.float32(beta[si])
            z = bts * z_m + jnp.sqrt(1.0 - bts * bts) * eps
            vol = PF.PG.VolumeModel().volumes(
                ks, z, num_paths=block_paths, num_bars=w)
            bars = PF._bars_from_shocks(
                z, prng.key_for(ks, prng.STREAM_BRIDGE_HI),
                prng.key_for(ks, prng.STREAM_BRIDGE_LO),
                s0=jnp.float32(s0[si]), mu=0.0,
                sigma=jnp.float32(sigma[si]),
                dt=1.0 / (390.0 * 252.0), volume=vol)
            tie = jax.random.uniform(
                prng.key_for(ks, prng.STREAM_TIE_COIN), (block_paths, w),
                jnp.float32)
            lvs = jax.tree_util.tree_map(lambda x: x[si], lv)
            out = enginepath.engine_path_replay(bars, lvs, params, tie)
            fin = np.float32(fin + np.float32(wts[si])
                             * np.asarray(out.equity, np.float32))
            trades = trades + np.asarray(out.trades)
        fins.append(fin)
        ents.append(trades > 0)
    fins = np.concatenate(fins)
    ents = np.concatenate(ents)
    var, cvar, k = _oracle(fins[ents], 0.05)
    assert tail.n_entered == int(ents.sum())
    assert tail.k == k
    assert tail.var == var, "book VaR must be BITWISE the order statistic"
    assert tail.cvar == cvar
    assert tail.certified

    # the aggregate book pipeline counts the identical population and its
    # free histogram estimate brackets the exact value
    _, port, _, _ = PF.portfolio_mc_engine(
        key, lv, params, s0, sigma, beta, wts, num_paths=num_paths,
        block_paths=block_paths, num_bars=w)
    assert int(port.n_entered) == tail.n_entered
    bin_w = (port.hist_hi - port.hist_lo) / port.hist.shape[-1]
    assert abs(float(port.quantile(0.05)) - tail.var) <= 2 * bin_w
