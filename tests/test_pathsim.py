"""Generated-path MC + mesh sharding: correctness, mesh-invariance, sweep CRN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu.parallel import mesh as PM
from qmmx_monolithic_monte_carlo_tpu.parallel import sweep as PS
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
from qmmx_monolithic_monte_carlo_tpu.types import OUTCOME_TP, Levels

LEVELS = Levels.from_rows(
    [{"color": "blue", "type": "solid", "index": 0, "price": 100.0}], max_levels=4
)
PARAMS = EngineParams.default()


def test_path_replay_matches_scalar_walk():
    key = jax.random.key(0)
    paths = PG.gbm_paths(key, num_paths=256, num_bars=40, s0=100.0, sigma=0.3,
                         dt=1.0 / (390 * 252))
    tie = jax.random.uniform(jax.random.key(1), (256,))
    r, outcome, entered = pathsim.path_replay(paths, LEVELS, PARAMS, tie)
    o = np.asarray(paths.open); h = np.asarray(paths.high)
    l = np.asarray(paths.low); c = np.asarray(paths.close)
    tie_np = np.asarray(tie)
    for p in range(256):
        near = np.abs(c[p] - 100.0) <= 0.05
        if not near.any():
            assert not bool(entered[p])
            continue
        eb = int(np.argmax(near))
        prev = o[p, 0] if eb == 0 else c[p, eb - 1]
        side = "long" if c[p, eb] > prev else "short"
        entry = c[p, eb]
        stop = 100.0 - 0.35 if side == "long" else 100.0 + 0.35
        target = 100.0 + 0.25 if side == "long" else 100.0 - 0.25
        # scalar walk
        res_r, res_out = 0.0, "open"
        for j in range(eb + 1, 40):
            hh, ll = h[p, j], l[p, j]
            s_hit = (ll <= stop) if side == "long" else (hh >= stop)
            t_hit = (hh >= target) if side == "long" else (ll <= target)
            risk = abs(entry - stop)
            reward = abs(target - entry)
            if s_hit and t_hit:
                up, dn = max(0.0, hh - entry), max(0.0, entry - ll)
                p_tp = up / (up + dn + 1e-9)
                res_r, res_out = ((reward / risk, "tp") if tie_np[p] < p_tp
                                  else (-1.0, "stop"))
                break
            if t_hit:
                res_r, res_out = reward / risk, "tp"
                break
            if s_hit:
                res_r, res_out = -1.0, "stop"
                break
        assert bool(entered[p])
        got_out = {1: "tp", 2: "stop", 0: "open"}[int(outcome[p])]
        assert got_out == res_out, p
        assert float(r[p]) == pytest.approx(res_r, rel=1e-4, abs=1e-5)


def test_mc_paths_stats_consistency():
    stats = pathsim.mc_paths(
        jax.random.key(2), LEVELS, PARAMS,
        num_paths=1 << 14, num_bars=40, s0=100.0, sigma=0.3,
        block_paths=1 << 12,
    )
    assert float(stats.n) == 1 << 14
    assert float(stats.n_tp + stats.n_stop + stats.n_open) == pytest.approx(
        float(stats.n_entered)
    )
    assert float(stats.hist.sum()) == pytest.approx(float(stats.n_entered))
    assert float(stats.min_r) <= float(stats.mean_r) <= float(stats.max_r)
    # histogram quantile sanity: q=1 → upper edge ≥ max; q~0 → lower region
    assert float(stats.quantile(0.999)) >= float(stats.mean_r)
    assert float(stats.cvar(0.05)) <= float(stats.quantile(0.05)) + 0.1


def test_mc_paths_blocking_invariance():
    a = pathsim.mc_paths(jax.random.key(3), LEVELS, PARAMS,
                         num_paths=1 << 13, block_paths=1 << 13, sigma=0.3)
    # different blocking → different RNG assignment, but same statistics scale
    b = pathsim.mc_paths(jax.random.key(3), LEVELS, PARAMS,
                         num_paths=1 << 13, block_paths=1 << 11, sigma=0.3)
    assert float(a.n) == float(b.n)
    assert abs(float(a.hit_rate) - float(b.hit_rate)) < 0.05


def test_sharded_mc_matches_single_device():
    mesh = PM.make_mesh(8)
    sharded = PM.sharded_mc_paths(
        mesh, jax.random.key(4), LEVELS, PARAMS,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
    )
    single = pathsim.mc_paths(
        jax.random.key(4), LEVELS, PARAMS,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
    )
    # identical global block keying → identical merged stats
    np.testing.assert_allclose(float(sharded.n), float(single.n))
    np.testing.assert_allclose(float(sharded.sum_r), float(single.sum_r), rtol=1e-5)
    np.testing.assert_allclose(float(sharded.n_tp), float(single.n_tp))
    np.testing.assert_allclose(
        np.asarray(sharded.hist), np.asarray(single.hist), rtol=1e-5
    )
    np.testing.assert_allclose(float(sharded.min_r), float(single.min_r), rtol=1e-6)


def test_sharded_gated_mc_matches_single_device():
    """The gated multi-trade lifecycle shards with the same psum/pmin/pmax
    merge — identical global block keying → identical merged stats."""
    from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath
    from qmmx_monolithic_monte_carlo_tpu.sim.gatedpath import GateConfig

    gate = GateConfig.default(touch_limit=100, touch_gap_bars=1)
    mesh = PM.make_mesh(8)
    sharded = PM.sharded_mc_paths(
        mesh, jax.random.key(4), LEVELS, PARAMS,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
        gate=gate,
    )
    single = gatedpath.mc_paths_gated(
        jax.random.key(4), LEVELS, PARAMS, gate,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
    )
    np.testing.assert_allclose(float(sharded.n), float(single.n))
    np.testing.assert_allclose(float(sharded.sum_trades), float(single.sum_trades))
    np.testing.assert_allclose(float(sharded.n_tp), float(single.n_tp))
    np.testing.assert_allclose(float(sharded.sum_r), float(single.sum_r), rtol=1e-5)
    np.testing.assert_allclose(float(sharded.sum_dd), float(single.sum_dd), rtol=1e-5)
    np.testing.assert_allclose(float(sharded.max_dd), float(single.max_dd), rtol=1e-6)
    np.testing.assert_allclose(float(sharded.min_r), float(single.min_r), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sharded.hist), np.asarray(single.hist), rtol=1e-5
    )


def test_bootstrap_sampler_path():
    rng = np.random.default_rng(0)
    n = 200
    c = 100 + np.cumsum(rng.normal(0, 0.1, n))
    hist = PG.PathBars(
        open=jnp.asarray(np.concatenate([[c[0]], c[:-1]]), jnp.float32),
        high=jnp.asarray(c + 0.05, jnp.float32),
        low=jnp.asarray(c - 0.05, jnp.float32),
        close=jnp.asarray(c, jnp.float32),
        volume=jnp.asarray(1e6 + 10.0 * np.arange(n), jnp.float32),
    )
    stats = pathsim.mc_paths(
        jax.random.key(5), LEVELS, PARAMS,
        num_paths=1 << 12, num_bars=40, s0=100.0,
        sampler="bootstrap", hist_bars=hist, block_paths=1 << 12,
    )
    assert float(stats.n) == 1 << 12


def test_sweep_grid_and_crn():
    grid = PS.grid_params(PARAMS, stop_paddings=[0.25, 0.35], tp_paddings=[0.15, 0.25])
    stats = PS.sweep_paths(
        jax.random.key(6), LEVELS, grid,
        num_paths=1 << 12, num_bars=40, sigma=0.3, block_paths=1 << 12,
    )
    assert stats.n.shape == (4,)
    # common random numbers: all configs saw the same paths → same entered count
    entered = np.asarray(stats.n_entered)
    assert np.all(entered == entered[0])
    # wider target → lower hit rate (monotone in tp_padding, same stop)
    hr = np.asarray(stats.hit_rate).reshape(2, 2)
    assert np.all(hr[:, 0] >= hr[:, 1] - 1e-6)


def test_sharded_sweep_matches_unsharded_statistically():
    mesh = PM.make_mesh(8)
    grid = PS.grid_params(PARAMS, stop_paddings=[0.35], tp_paddings=[0.25])
    sharded = PS.sharded_sweep(
        mesh, jax.random.key(7), LEVELS, grid,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
    )
    assert float(sharded.n[0]) == 1 << 13
    single = PS.sweep_paths(
        jax.random.key(8), LEVELS, grid,
        num_paths=1 << 13, num_bars=40, sigma=0.3, block_paths=1 << 10,
    )
    assert abs(float(sharded.hit_rate[0]) - float(single.hit_rate[0])) < 0.05


def test_block_bootstrap_and_heston_samplers_in_pipeline():
    rng = np.random.default_rng(1)
    n = 300
    c = 100 + np.cumsum(rng.normal(0, 0.1, n))
    hist = PG.PathBars(
        open=jnp.asarray(np.concatenate([[c[0]], c[:-1]]), jnp.float32),
        high=jnp.asarray(c + 0.05, jnp.float32),
        low=jnp.asarray(c - 0.05, jnp.float32),
        close=jnp.asarray(c, jnp.float32),
        volume=jnp.asarray(1e6 + 10.0 * np.arange(n), jnp.float32),
    )
    st = pathsim.mc_paths(
        jax.random.key(9), LEVELS, PARAMS,
        num_paths=1 << 12, num_bars=40, s0=100.0,
        sampler="block_bootstrap", hist_bars=hist, block_paths=1 << 12,
        block_len=8,
    )
    assert float(st.n) == 1 << 12
    st2 = pathsim.mc_paths(
        jax.random.key(10), LEVELS, PARAMS,
        num_paths=1 << 12, num_bars=40, s0=100.0,
        sampler="heston", block_paths=1 << 12,
        heston=dict(v0=0.09, theta=0.09, kappa=2.0, xi=0.5, rho=-0.6),
    )
    assert float(st2.n) == 1 << 12
    assert float(st2.n_entered) > 0


# ---- execution noise at path scale (reference MC :3453-3461) ----

def test_noise_zero_matches_noise_none_bitwise():
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise
    key = jax.random.key(11)
    base = pathsim.mc_paths(key, LEVELS, PARAMS, num_paths=1 << 12,
                            block_paths=1 << 12, sigma=0.3)
    zero = pathsim.mc_paths(key, LEVELS, PARAMS, num_paths=1 << 12,
                            block_paths=1 << 12, sigma=0.3,
                            noise=McNoise.make(0.0, 0.0, 0.0, 0.0))
    for f in ("n", "n_tp", "n_stop", "n_open", "n_entered", "sum_r", "sum_r2",
              "min_r", "max_r", "sum_trades", "sum_dd", "max_dd", "hist"):
        np.testing.assert_array_equal(np.asarray(getattr(base, f)),
                                      np.asarray(getattr(zero, f)), err_msg=f)


def test_noise_injected_normals_oracle():
    """path_replay with injected noise normals: scaffold matches the reference
    formulas lvl+N(jit), entry+N(slip), (lvl_j ∓ pad)+N(slip) (:3453-3461)."""
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise
    from qmmx_monolithic_monte_carlo_tpu.types import OUTCOME_STOP

    # one path: enters at bar 0 (close 100.01 vs open 100.05 -> short),
    # bar 1 dips to 99.0 (would hit the default short target 99.75)
    o = np.array([[100.05, 100.01, 100.01, 100.01]], np.float32)
    c = np.array([[100.01, 99.50, 100.01, 100.01]], np.float32)
    h = np.array([[100.05, 100.01, 100.02, 100.02]], np.float32)
    l = np.array([[100.00, 99.00, 100.00, 100.00]], np.float32)
    bars = PG.PathBars(open=jnp.asarray(o), high=jnp.asarray(h),
                       low=jnp.asarray(l), close=jnp.asarray(c),
                       volume=jnp.zeros_like(jnp.asarray(c)))
    tie = jnp.zeros((1,), jnp.float32)

    # no noise: short from 100.01, target 99.75 hit at bar 1 -> R = reward/risk
    r0, out0, ent0 = pathsim.path_replay(bars, LEVELS, PARAMS, tie)
    assert bool(ent0[0]) and int(out0[0]) == int(OUTCOME_TP)
    np.testing.assert_allclose(float(r0[0]), (100.01 - 99.75) / (100.35 - 100.01),
                               rtol=2e-4)

    # level jitter -1.0 moves the short target to 98.75 (not reached) and the
    # stop to 99.35 — bar 2's recovery to 100.02 no longer reaches it, but the
    # ORIGINAL stop 100.35 would not have been hit either; check barriers move
    noise = McNoise.make(entry_slip_std=1.0, level_jitter_std=1.0,
                         stop_slip_std=1.0, target_slip_std=1.0)
    nj = jnp.asarray([[-1.0]], jnp.float32)[0]   # level 100 -> 99
    ne = jnp.asarray([[0.02]], jnp.float32)[0]   # entry 100.01 -> 100.03
    ns = jnp.asarray([[0.10]], jnp.float32)[0]   # stop 99.35 -> 99.45... short stop = lvl_j + pad = 99.35? lvl_j=99, +0.35 = 99.35, +0.10 = 99.45
    nt = jnp.asarray([[0.05]], jnp.float32)[0]   # target 98.75 -> 98.80
    r1, out1, ent1 = pathsim.path_replay(
        bars, LEVELS, PARAMS, tie, noise=noise, noise_normals=(nj, ne, ns, nt))
    # short entry 100.03, stop 99.45, target 98.80: bar 1 low 99.0 hits the
    # STOP barrier? stop for a short is ABOVE entry: 99.45 < entry... risk
    # degenerates -> the hit scan sees stop at 99.45 hit by low<=? No: short
    # stop triggers on HIGH >= stop. high bar1 = 100.01 >= 99.45 -> stop hit.
    assert bool(ent1[0]) and int(out1[0]) == int(OUTCOME_STOP)
    assert float(r1[0]) == -1.0


def test_noise_broadens_outcomes_statistically():
    from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise
    key = jax.random.key(12)
    base = pathsim.mc_paths(key, LEVELS, PARAMS, num_paths=1 << 14,
                            block_paths=1 << 14, sigma=0.3)
    noisy = pathsim.mc_paths(key, LEVELS, PARAMS, num_paths=1 << 14,
                             block_paths=1 << 14, sigma=0.3,
                             noise=McNoise.default())
    # same paths entered (contact detection is noise-free)...
    assert float(base.n_entered) == float(noisy.n_entered)
    # ...but outcomes move and R dispersion grows (jitter breaks the
    # two-point R distribution into a spread; stop R stays exactly -1 by
    # definition, so the spread shows in std/max and the histogram)
    assert float(noisy.std_r) > float(base.std_r)
    assert float(noisy.max_r) != float(base.max_r)
    assert not np.array_equal(np.asarray(noisy.hist), np.asarray(base.hist))


@pytest.mark.parametrize("sampler", ["gbm", "bootstrap"])
def test_sharded_engine_mc_matches_single_device(sampler):
    """The FULL engine shards like the other lifecycles: a 4-device mesh run
    equals the single-device pipeline on counts and the histogram (global
    block keying), sums to psum reduction order."""
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP

    from .samples import history

    hist = history(3, 220) if sampler == "bootstrap" else None
    kw = dict(num_paths=1 << 11, num_bars=16, sigma=0.3, block_paths=1 << 8,
              sampler=sampler, hist_bars=hist)
    sharded = PM.sharded_mc_paths(PM.make_mesh(4), jax.random.key(6), LEVELS,
                                  PARAMS, engine=True, **kw)
    single, _, _ = EP.mc_paths_engine(jax.random.key(6), LEVELS, PARAMS, **kw)
    for f in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades"):
        assert float(getattr(sharded, f)) == float(getattr(single, f)), f
    np.testing.assert_array_equal(np.asarray(sharded.hist),
                                  np.asarray(single.hist))
    assert float(sharded.max_dd) == float(single.max_dd)
    np.testing.assert_allclose(float(sharded.sum_r), float(single.sum_r),
                               rtol=1e-5)
    assert float(single.sum_trades) > 0
