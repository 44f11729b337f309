"""The fused first-contact kernel (ops/triton_paths.py) on the CPU.

The kernel runs here in Pallas interpret mode.  With injected uniforms it must
reproduce, path for path, a NumPy mirror of its semantics (counts and the
histogram exactly, sums to float32 reassociation), and the XLA pipeline's
replay (``pathsim.path_replay``) over the bars those uniforms define; with
its own threefry stream it must equal that mirror fed with ``jax.random``'s
threefry block function at the documented counters.  The kernel's CUDA
lowering is checked
here too, by exporting it for the ``cuda`` platform.  What needs the card is
marked ``gpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.ops import triton_paths as TP
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
from qmmx_monolithic_monte_carlo_tpu.sim.montecarlo import McNoise
from qmmx_monolithic_monte_carlo_tpu.sim.pathsim import HIST_BINS, HIST_HI, HIST_LO
from qmmx_monolithic_monte_carlo_tpu.types import Levels

W = 24
N = 1024
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
PARAMS = EngineParams.default()
NOISE_STDS = (0.01, 0.02, 0.015, 0.015)   # entry, level jitter, stop, target


def _levels(prices):
    return Levels.from_rows(
        [{"color": "blue", "type": "solid", "index": i, "price": p}
         for i, p in enumerate(prices)], max_levels=8)


LEVELS = _levels([100.0, 100.4])


def _f(x):
    return np.asarray(x, np.float32)


def _bm(u1, u2):
    """Box-Muller with XLA's own transcendentals (the kernel's, in interpret
    mode), so the mirror differs from the kernel in no rounding."""
    r = np.sqrt(np.float32(-2.0) * _f(jnp.log(u1)))
    a = np.float32(TP._TWO_PI) * u2
    return r * _f(jnp.cos(a)), r * _f(jnp.sin(a))


def bars(u, *, w=W, antithetic=False, s0=100.0) -> PathBars:
    """The GBM bars the kernel walks, from uniform rows ``u`` [rows, paths]:
    f32[paths, w] each; bar 0 opens at ``s0``, every later bar at the last
    close."""
    f = np.float32
    u = _f(u)
    n = u.shape[1]
    drift, sig_dt, log_s0 = (f(x) for x in TP.gbm_consts(s0, 0.0, SIGMA, DT))
    sig2dt = sig_dt * sig_dt
    sign = np.where(np.arange(n) % 2 == 1, f(-1.0), f(1.0)) if antithetic \
        else np.ones(n, f)
    rel = np.zeros(n, f)
    log_prev = np.full(n, log_s0, f)
    ohlc = []
    for j in range(w // 2):
        za, zb = _bm(u[6 * j], u[6 * j + 1])
        for z, uh, ul in ((sign * za, u[6 * j + 2], u[6 * j + 3]),
                          (sign * zb, u[6 * j + 4], u[6 * j + 5])):
            incr = drift + sig_dt * z
            rel = rel + incr
            log_c = log_s0 + rel
            d2 = (log_c - log_prev) ** 2
            mid = log_prev + log_c
            ohlc.append((
                _f(jnp.exp(log_prev)),
                _f(jnp.exp(f(0.5) * (mid + np.sqrt(d2 - f(2.0) * sig2dt * _f(jnp.log(uh)))))),
                _f(jnp.exp(f(0.5) * (mid - np.sqrt(d2 - f(2.0) * sig2dt * _f(jnp.log(ul)))))),
                _f(jnp.exp(log_c))))
            log_prev = log_c
    o, h, lo, c = (np.stack(col, axis=1) for col in zip(*ohlc))
    return PathBars(open=o, high=h, low=lo, close=c, volume=np.zeros_like(c))


def noise_normals(u, w=W):
    """The execution-noise normals of rows ``3w+1 .. 3w+4``: (level jitter,
    entry slip, stop slip, target slip)."""
    jit_n, entry_n = _bm(_f(u[3 * w + 1]), _f(u[3 * w + 2]))
    sslip, tslip = _bm(_f(u[3 * w + 3]), _f(u[3 * w + 4]))
    return jit_n, entry_n, sslip, tslip


def oracle(u, prices, *, w=W, noise=None, antithetic=False, s0=100.0):
    """Per-path mirror of the kernel from uniform rows ``u`` [rows, paths]."""
    f = np.float32
    u = _f(u)
    n = u.shape[1]
    prox, sp, tp = (f(PARAMS.contact_prox), f(PARAMS.stop_padding),
                    f(PARAMS.tp_padding))
    big = f(TP._BIG)
    tie = u[3 * w]
    if noise is not None:
        jit_n, entry_n, sslip, tslip = noise_normals(u, w)
        entry_n, jit_n = entry_n * f(noise[0]), jit_n * f(noise[1])
        sslip, tslip = sslip * f(noise[2]), tslip * f(noise[3])
    path_bars = bars(u, w=w, antithetic=antithetic, s0=s0)
    prev_close = path_bars.open[:, 0]
    entered = np.zeros(n, bool)
    done = np.zeros(n, bool)
    is_tp = np.zeros(n, bool)
    is_long = np.zeros(n, bool)
    entry = np.zeros(n, f)
    stop = np.zeros(n, f)
    target = np.zeros(n, f)
    for k in range(w):
        high, low, close = (path_bars.high[:, k], path_bars.low[:, k],
                            path_bars.close[:, k])
        live = entered & ~done
        stop_hit = np.where(is_long, low <= stop, high >= stop)
        tgt_hit = np.where(is_long, high >= target, low <= target)
        up = np.maximum(f(0.0), high - entry)
        dn = np.maximum(f(0.0), entry - low)
        coin = tie < up / (up + dn + f(1e-9))
        first_tp = np.where(stop_hit & tgt_hit, coin, tgt_hit)
        hit = live & (stop_hit | tgt_hit)
        is_tp = np.where(hit, first_tp, is_tp)
        done = done | hit
        best_d = np.full(n, big, f)
        best_p = np.zeros(n, f)
        for lp in prices:
            d = np.abs(close - f(lp))
            take = d < best_d
            best_p = np.where(take, f(lp), best_p)
            best_d = np.where(take, d, best_d)
        opens = ~entered & (best_d <= prox)
        lvl, fill = best_p, close
        if noise is not None:
            lvl, fill = lvl + jit_n, fill + entry_n
        up_move = close > prev_close
        new_stop = np.where(up_move, lvl - sp, lvl + sp)
        new_tgt = np.where(up_move, lvl + tp, lvl - tp)
        if noise is not None:
            new_stop, new_tgt = new_stop + sslip, new_tgt + tslip
        entered = entered | opens
        is_long = np.where(opens, up_move, is_long)
        entry = np.where(opens, fill, entry)
        stop = np.where(opens, new_stop, stop)
        target = np.where(opens, new_tgt, target)
        prev_close = close
    risk = np.maximum(np.abs(entry - stop), f(1e-9))
    reward = np.abs(target - entry)
    closed = entered & done
    r = np.where(closed, np.where(is_tp, reward / risk, f(-1.0)), f(0.0))
    bins = np.clip(((r - f(HIST_LO)) * f(HIST_BINS / (HIST_HI - HIST_LO)))
                   .astype(np.int32), 0, HIST_BINS - 1)
    return dict(
        n_entered=int(entered.sum()), n_tp=int((closed & is_tp).sum()),
        n_stop=int((closed & ~is_tp).sum()), n_open=int((entered & ~done).sum()),
        sum_r=float(r.sum(dtype=np.float64)), min_r=float(r[entered].min()),
        max_r=float(r[entered].max()),
        hist=np.bincount(bins[entered], minlength=HIST_BINS))


def _check(got, want, n=N):
    assert float(got.n) == n
    for k in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert float(getattr(got, k)) == want[k], k
    np.testing.assert_array_equal(np.asarray(got.hist), want["hist"])
    assert float(got.min_r) == pytest.approx(want["min_r"], abs=1e-6)
    assert float(got.max_r) == pytest.approx(want["max_r"], abs=1e-6)
    # float32 sums in the kernel's order vs a float64 sum: 1e-5 per path
    assert float(got.sum_r) == pytest.approx(want["sum_r"], abs=1e-5 * n)


def _uniforms(seed, rows, n=N):
    return np.random.default_rng(seed).uniform(1e-7, 1.0, (rows, n)).astype(np.float32)


def _noise():
    return McNoise.make(*NOISE_STDS)


@pytest.mark.parametrize("case", ["plain", "noise", "one_level", "eight_levels",
                                  "antithetic"])
def test_kernel_matches_oracle_on_injected_uniforms(case):
    prices = {"one_level": [100.05],
              "eight_levels": [99.4, 99.6, 99.8, 100.0, 100.2, 100.4, 100.6,
                               100.8]}.get(case, [100.0, 100.4])
    noise = _noise() if case == "noise" else None
    seed = ["plain", "noise", "one_level", "eight_levels", "antithetic"].index(case)
    u = _uniforms(seed, TP.num_rows(W, noise is not None))
    got = TP.mc_paths_triton(0, _levels(prices), PARAMS, num_paths=N, num_bars=W,
                             sigma=SIGMA, dt=DT, noise=noise,
                             antithetic=case == "antithetic", interpret=True,
                             external_uniforms=u)
    want = oracle(u, prices, noise=NOISE_STDS if noise is not None else None,
                  antithetic=case == "antithetic")
    _check(got, want)
    assert want["n_entered"] > 0 and want["n_tp"] > 0 and want["n_stop"] > 0


@pytest.mark.parametrize("case", ["plain", "noise", "eight_levels", "antithetic"])
def test_kernel_matches_path_replay_on_the_same_bars(case):
    """The XLA pipeline's replay (``pathsim.path_replay`` and
    ``PathStats.from_outcomes``, what ``auto`` replaces on a GPU) over the
    bars the kernel's uniform rows define, with the same tie coin and noise
    normals: entry side on bar 0, tie coin, noise placement and histogram
    binning agree path for path."""
    prices = ([99.4, 99.6, 99.8, 100.0, 100.2, 100.4, 100.6, 100.8]
              if case == "eight_levels" else [100.0, 100.4])
    noise = _noise() if case == "noise" else None
    antithetic = case == "antithetic"
    u = _uniforms(10 + ["plain", "noise", "eight_levels", "antithetic"].index(case),
                  TP.num_rows(W, noise is not None))
    if antithetic:                  # pairs share their Box-Muller uniforms
        for j in range(W // 2):
            u[6 * j:6 * j + 2, 1::2] = u[6 * j:6 * j + 2, 0::2]
    got = TP.mc_paths_triton(0, _levels(prices), PARAMS, num_paths=N, num_bars=W,
                             sigma=SIGMA, dt=DT, noise=noise, antithetic=antithetic,
                             interpret=True, external_uniforms=u)
    r, outcome, entered = pathsim.path_replay(
        bars(u, antithetic=antithetic), _levels(prices), PARAMS, u[3 * W],
        noise=noise, noise_normals=noise_normals(u) if noise is not None else None)
    want = pathsim.PathStats.from_outcomes(r, outcome, entered)
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades",
                "sum_dd", "min_r", "max_r"):
        assert float(getattr(got, fld)) == float(getattr(want, fld)), fld
    np.testing.assert_array_equal(np.asarray(got.hist), np.asarray(want.hist))
    assert float(got.sum_r) == pytest.approx(float(want.sum_r), abs=1e-5 * N)
    assert float(want.n_tp) > 0 and float(want.n_stop) > 0


def test_zero_noise_matches_noise_free_bitwise():
    """Noise of zero width draws its rows but changes nothing."""
    u = _uniforms(6, TP.num_rows(W, True))
    zero = McNoise.make(0.0, 0.0, 0.0, 0.0)
    kw = dict(num_paths=N, num_bars=W, sigma=SIGMA, dt=DT, interpret=True)
    a = TP.mc_paths_triton(0, LEVELS, PARAMS, noise=zero, external_uniforms=u, **kw)
    b = TP.mc_paths_triton(0, LEVELS, PARAMS,
                           external_uniforms=u[:TP.num_rows(W, False)], **kw)
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_r", "min_r",
                "max_r"):
        assert float(getattr(a, fld)) == float(getattr(b, fld)), fld
    np.testing.assert_array_equal(np.asarray(a.hist), np.asarray(b.hist))


def _threefry_uniforms(seed, rows, n, antithetic=False):
    """The kernel's stream, rebuilt with jax.random's threefry block function:
    row r of path p is word r % 2 of threefry(key, (p, r // 2)); with
    antithetic, Box-Muller rows (6j, 6j+1) come from path p & ~1."""
    from jax.extend.random import threefry2x32_p

    key = TP.seed_key(seed)
    out = np.zeros((rows, n), np.float32)
    paths = np.arange(n, dtype=np.uint32)
    for blk in range((rows + 1) // 2):
        who = paths
        if antithetic and blk % 3 == 0 and 2 * blk < 3 * W:
            who = paths & np.uint32(0xFFFFFFFE)
        b0, b1 = threefry2x32_p.bind(key[0], key[1], jnp.asarray(who),
                                     jnp.full((n,), blk, jnp.uint32))
        for word, bits in enumerate((b0, b1)):
            if 2 * blk + word < rows:
                out[2 * blk + word] = _f(TP.bits_to_uniform(bits))
    return out


@pytest.mark.parametrize("antithetic", [False, True])
def test_in_kernel_stream_is_threefry_at_documented_counters(antithetic):
    seed = 12345
    got = TP.mc_paths_triton(seed, LEVELS, PARAMS, num_paths=N, num_bars=W,
                             sigma=SIGMA, dt=DT, antithetic=antithetic,
                             interpret=True)
    u = _threefry_uniforms(seed, TP.num_rows(W, False), N, antithetic)
    _check(got, oracle(u, [100.0, 100.4], antithetic=antithetic))


@pytest.mark.parametrize("noise,antithetic", [(False, False), (True, False),
                                               (False, True)])
def test_plain_reference_walks_the_kernel_stream(noise, antithetic):
    """``mc_paths_reference`` (the same walk in plain JAX) equals the kernel
    exactly on counts and the histogram; it is what the kernel is compared
    with on the card."""
    kw = dict(num_paths=N, num_bars=W, sigma=SIGMA, dt=DT,
              noise=_noise() if noise else None, antithetic=antithetic)
    ker = TP.mc_paths_triton(9, LEVELS, PARAMS, interpret=True, **kw)
    ref = TP.mc_paths_reference(9, LEVELS, PARAMS, block_paths=256, **kw)
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades",
                "sum_dd", "min_r", "max_r"):
        assert float(getattr(ker, fld)) == float(getattr(ref, fld)), fld
    np.testing.assert_array_equal(np.asarray(ker.hist), np.asarray(ref.hist))
    assert float(ker.sum_r) == pytest.approx(float(ref.sum_r), abs=1e-5 * N)


def test_threefry_matches_jax_block_function():
    from jax.extend.random import threefry2x32_p

    rng = np.random.default_rng(2)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    want = threefry2x32_p.bind(*(jnp.asarray(v) for v in (k[0], k[1], x[0], x[1])))
    got = TP.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
                          jnp.asarray(x[1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_uniforms_stay_inside_the_open_interval():
    u = np.asarray(TP.bits_to_uniform(jnp.asarray([0, 2**32 - 1], jnp.uint32)))
    assert 0.0 < u[0] < 1e-6 and 1.0 - 1e-6 < u[1] < 1.0


@pytest.mark.parametrize("tile", [128, 512])
def test_paths_do_not_depend_on_the_tile(tile):
    """Counters are global path indices, so the tile and grid shape change
    nothing but the order of the float sums."""
    kw = dict(num_paths=N, num_bars=W, sigma=SIGMA, dt=DT, interpret=True)
    a = TP.mc_paths_triton(3, LEVELS, PARAMS, tile=tile, **kw)
    b = TP.mc_paths_triton(3, LEVELS, PARAMS, **kw)
    for fld in ("n_entered", "n_tp", "n_stop", "n_open", "min_r", "max_r"):
        assert float(getattr(a, fld)) == float(getattr(b, fld)), fld
    np.testing.assert_array_equal(np.asarray(a.hist), np.asarray(b.hist))
    assert float(a.sum_r) == pytest.approx(float(b.sum_r), abs=1e-5 * N)


def test_stats_contract():
    s = TP.mc_paths_triton(7, LEVELS, PARAMS, num_paths=N, num_bars=W,
                           sigma=SIGMA, dt=DT, noise=_noise(), interpret=True)
    assert float(s.n_tp + s.n_stop + s.n_open) == float(s.n_entered)
    assert float(s.hist.sum()) == float(s.n_entered)
    assert float(s.sum_trades) == float(s.n_entered)
    assert float(s.sum_dd) == float(s.n_stop)
    assert float(s.min_r) <= float(s.max_r)
    assert float(s.max_dd) == max(0.0, -float(s.min_r))
    assert 0.0 <= float(s.hit_rate) <= 1.0


@pytest.mark.parametrize("bad", ["paths", "odd_bars", "nine_levels", "sampler",
                                 "too_many_paths", "uniform_shape"])
def test_kernel_refuses_what_it_cannot_run(bad):
    kw = dict(num_paths=N, num_bars=W, interpret=True)
    levels = LEVELS
    if bad == "paths":
        kw["num_paths"] = N + 1
    elif bad == "odd_bars":
        kw["num_bars"] = W + 1
    elif bad == "nine_levels":
        levels = Levels.from_rows(
            [{"color": "blue", "type": "solid", "index": i, "price": 100.0 + i}
             for i in range(9)], max_levels=16)
    elif bad == "sampler":
        kw["sampler"] = "bootstrap"
    elif bad == "too_many_paths":
        kw["num_paths"] = 1 << 31
    else:
        kw["external_uniforms"] = np.zeros((3 * W, N), np.float32)
    with pytest.raises(ValueError):
        TP.mc_paths_triton(0, levels, PARAMS, **kw)


@pytest.mark.parametrize("noise,antithetic", [(False, False), (True, True)])
def test_kernel_lowers_for_cuda(noise, antithetic):
    """The Triton lowering itself runs here: exporting for the ``cuda``
    platform lowers the kernel to Triton IR without a card."""
    from jax import export

    lp, lv = TP._compact_levels(LEVELS)
    fn = jax.jit(lambda k, kn, a, b: TP._run(
        k, kn, a, b, None, num_paths=1 << 14, num_bars=40, tile=TP.TILE,
        antithetic=antithetic, use_noise=noise, interpret=False))
    exp = export.export(fn, platforms=["cuda"], disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
        jnp.zeros(2, jnp.uint32), jnp.zeros(TP.N_KNOBS, jnp.float32),
        jnp.asarray(lp), jnp.asarray(lv))
    assert "xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_kernel_on_the_card_matches_the_plain_reference(gpu):
    """Compiled on the GPU, the kernel walks the same threefry stream as the
    plain-JAX reference; decisions agree but for float32 rounding of the
    transcendentals (at most 8 counts apart)."""
    n = 1 << 20
    kw = dict(num_paths=n, num_bars=40, sigma=SIGMA, dt=DT, noise=_noise())
    card = TP.mc_paths_triton(5, LEVELS, PARAMS, **kw)
    ref = TP.mc_paths_reference(5, LEVELS, PARAMS, **kw)
    for fld in ("n_entered", "n_tp", "n_stop", "n_open"):
        assert abs(float(getattr(card, fld)) - float(getattr(ref, fld))) \
            <= 8, fld
