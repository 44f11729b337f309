"""ops/regular.py: bar-synchronous guard/touch must match ops/guard.py and
ops/touch.py exactly on regularly spaced 1-minute bar sequences (the lean
forms drive the scaled engine pipeline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.ops import guard as G
from qmmx_monolithic_monte_carlo_tpu.ops import regular as R
from qmmx_monolithic_monte_carlo_tpu.ops import touch as T
from qmmx_monolithic_monte_carlo_tpu.types import Levels

LEVELS = Levels.from_rows(
    [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6},
    ],
    max_levels=8,
)


def _bar_tape(seed, w, boxy=True):
    """A tape engineered to traverse regimes: long compression stretches
    (accumulation), volume spikes + range expansions (breakouts), re-entries."""
    rng = np.random.default_rng(seed)
    c = np.empty(w, np.float32)
    px = 100.0
    vol = np.empty(w, np.float32)
    regime_len = 0
    explode = False
    for t in range(w):
        if regime_len <= 0:
            explode = not explode if rng.uniform() < 0.5 else explode
            regime_len = rng.integers(15, 30) if explode else rng.integers(90, 140)
        regime_len -= 1
        step = 0.20 if explode else 0.003
        px = px + rng.normal(0, step)
        # soft pull-back toward 100 keeps the tape near the levels
        px += (100.0 - px) * 0.02
        c[t] = px
        vol[t] = rng.lognormal(13.0, 0.3) * (3.0 if explode else 1.0)
    h = (c + np.abs(rng.normal(0, 0.008, w))).astype(np.float32)
    l = (c - np.abs(rng.normal(0, 0.008, w))).astype(np.float32)
    return h, l, c.astype(np.float32), vol.astype(np.float32)


def test_regular_guard_matches_reference_guard():
    w = 220
    for seed in (0, 1, 2):
        h, l, c, v = _bar_tape(seed, w)
        params = G.GuardParams.default()
        ref = G.GuardState.zeros()
        lean = R.RegularGuardState.zeros(1)

        @jax.jit
        def ref_push(st, ts, hh, ll, cc, vv):
            return G.push_minute_bar(st, params, ts_ms=ts, high=hh, low=ll,
                                     close=cc, volume=vv)

        @jax.jit
        def lean_push(st, t, hh, ll, cc, vv):
            return R.guard_push(st, params, bar_index=t,
                                high=hh[None], low=ll[None], close=cc[None],
                                volume=vv[None])

        for t in range(w):
            ref = ref_push(ref, t * 60_000, h[t], l[t], c[t], v[t])
            lean = lean_push(lean, t, h[t], l[t], c[t], v[t])
            assert int(ref.regime) == int(lean.regime[0]), (seed, t)
            assert bool(ref.box_valid) == bool(lean.box_valid[0]), (seed, t)
            if bool(ref.box_valid):
                np.testing.assert_allclose(float(ref.box_low),
                                           float(lean.box_low[0]), rtol=1e-6)
                np.testing.assert_allclose(float(ref.box_high),
                                           float(lean.box_high[0]), rtol=1e-6)
            assert int(ref.inside_count) == int(lean.inside_count[0]), (seed, t)
        # make sure the tape actually exercised the state machine
        # (at least saw a box)
        assert bool(lean.box_valid[0]) or seed > 0


@pytest.mark.slow
def test_regular_touch_matches_reference_touch():
    w = 260
    for seed in (3, 4):
        h, l, c, v = _bar_tape(seed, w)
        tparams = T.TouchMemoryParams.default()
        gparams = G.GuardParams.default()
        ref_t = T.TouchMemoryState.zeros(LEVELS.max_levels)
        lean_t = R.RegularTouchState.zeros(1, LEVELS.max_levels)
        ref_g = G.GuardState.zeros()
        lean_g = R.RegularGuardState.zeros(1)
        vol_ring = np.zeros(32, np.float32)  # newest-first, for the MAs

        @jax.jit
        def step_ref(rg, rt, ts, hh, ll, cc, vv, ma_s, ma_l):
            rg = G.push_minute_bar(rg, gparams, ts_ms=ts, high=hh, low=ll,
                                   close=cc, volume=vv)
            rt2 = T.register_touch_bar(
                rt, tparams, LEVELS, ts_ms=ts, high=hh, low=ll, close=cc,
                box_low=rg.box_low, box_high=rg.box_high,
                box_valid=jnp.logical_and(rg.box_valid, rg.regime == G.REGIME_ACCUMULATION),
                vol_ma_s=ma_s, vol_ma_l=ma_l,
            )
            acc = rg.regime == G.REGIME_ACCUMULATION
            rt = jax.tree_util.tree_map(
                lambda a_, b_: jnp.where(acc, a_, b_), rt2, rt)
            return rg, rt

        @jax.jit
        def step_lean(lg, lt, t, hh, ll, cc, vv, ma_s, ma_l):
            lg = R.guard_push(lg, gparams, bar_index=t, high=hh[None],
                              low=ll[None], close=cc[None], volume=vv[None])
            acc = lg.regime == G.REGIME_ACCUMULATION
            lt = R.touch_register(
                lt, tparams, LEVELS, ts_ms=t * 60_000,
                high=hh[None], low=ll[None], close=cc[None],
                box_low=lg.box_low, box_high=lg.box_high,
                box_valid=jnp.logical_and(lg.box_valid, acc),
                vol_ma_s=ma_s[None], vol_ma_l=ma_l[None], enabled=acc,
            )
            return lg, lt

        for t in range(w):
            n = min(t, 32)
            ma_s = vol_ring[:min(5, max(1, t))].sum() / max(1, min(5, t)) if t else 0.0
            ma_l = vol_ring[:min(20, max(1, t))].sum() / max(1, min(20, t)) if t else 0.0
            # feed the same externally computed MAs to both (the engine
            # computes them from its own bar ring; equality is what matters)
            ma_s = np.float32(ma_s)
            ma_l = np.float32(ma_l)
            ref_g, ref_t = step_ref(ref_g, ref_t, t * 60_000, h[t], l[t], c[t],
                                    v[t], ma_s, ma_l)
            lean_g, lean_t = step_lean(lean_g, lean_t, t, h[t], l[t], c[t],
                                       v[t], ma_s, ma_l)
            vol_ring = np.concatenate([[v[t]], vol_ring[:-1]]).astype(np.float32)

            np.testing.assert_array_equal(np.asarray(ref_t.count),
                                          np.asarray(lean_t.count[0]), err_msg=str(t))
            np.testing.assert_array_equal(np.asarray(ref_t.has_last),
                                          np.asarray(lean_t.has_last[0]))
            np.testing.assert_array_equal(np.asarray(ref_t.last_ts),
                                          np.asarray(lean_t.last_ts[0]))

            # fatigue + allow_trade agree at every step
            now = t * 60_000
            f_ref = int(T.edge_fatigued(ref_t, tparams, now))
            f_lean = int(R.edge_fatigued(lean_t, tparams, now)[0])
            assert f_ref == f_lean, (seed, t)
            for lvl_i in range(3):
                for side in (T.TM_LONG, T.TM_SHORT):
                    a_r, b_r, m_r = T.allow_trade_at(ref_t, tparams, lvl_i, side, now)
                    a_l, b_l, m_l = R.touch_allow(
                        lean_t, tparams, jnp.asarray([lvl_i]),
                        jnp.asarray([side]), now)
                    assert bool(a_r) == bool(a_l[0])
                    assert bool(b_r) == bool(b_l[0])
                    np.testing.assert_allclose(float(m_r), float(m_l[0]), rtol=1e-6)
        assert int(np.asarray(lean_t.count[0]).sum()) > 0  # tape touched levels


def test_lean_guard_matches_guard_push_bitwise():
    """The ring-free LeanGuardState (the scaled pipeline's guard after the
    round-4 state diet) must be BITWISE guard_push on every bar: min/max are
    order-free, and the vol-MA masked sums see elementwise-identical arrays
    (zero-padded shared ring == guard's own ring under the slot<k mask).
    Covers both forms: running extremes (horizon <= 61) and the 61-slot
    windowed extreme rings (horizon > 61)."""
    params = G.GuardParams.default()
    p = 4
    for w, windowed in ((50, False), (220, True)):
        tapes = [_bar_tape(seed, w) for seed in (0, 1, 5, 6)]
        h = np.stack([tp[0] for tp in tapes])
        l = np.stack([tp[1] for tp in tapes])
        c = np.stack([tp[2] for tp in tapes])
        v = np.stack([tp[3] for tp in tapes])

        @jax.jit
        def run(h, l, c, v, _windowed=windowed):
            def step(carry, inp):
                ref, lean, ring_v = carry
                hh, ll, cc, vv, t = inp
                ring_v = R.ring_push(ring_v, vv)
                ref = R.guard_push(ref, params, bar_index=t, high=hh, low=ll,
                                   close=cc, volume=vv)
                lean = R.lean_guard_push(lean, params, bar_index=t, high=hh,
                                         low=ll, close=cc, vol_ring=ring_v)
                out = (ref.box_low, ref.box_high, ref.box_valid, ref.regime,
                       ref.inside_count, lean.box_low, lean.box_high,
                       lean.box_valid, lean.regime, lean.inside_count)
                return (ref, lean, ring_v), out

            init = (R.RegularGuardState.zeros(p),
                    R.LeanGuardState.zeros(p, windowed=_windowed),
                    jnp.zeros((p, 32), jnp.float32))
            xs = (h.T, l.T, c.T, v.T,
                  jnp.arange(h.shape[1], dtype=jnp.int32))
            _, outs = jax.lax.scan(step, init, xs)
            return outs

        outs = run(jnp.asarray(h), jnp.asarray(l), jnp.asarray(c),
                   jnp.asarray(v))
        names = ("box_low", "box_high", "box_valid", "regime", "inside_count")
        for i, name in enumerate(names):
            np.testing.assert_array_equal(
                np.asarray(outs[i]), np.asarray(outs[i + 5]),
                err_msg=f"{name} w={w}")
        # the tape exercised the machine (saw accumulation at least once)
        assert (np.asarray(outs[3]) == G.REGIME_ACCUMULATION).any()


def test_tail_mean_minclose_matches_lifecycle_formula():
    rng = np.random.default_rng(7)
    vols = rng.lognormal(10, 0.5, 40).astype(np.float32)
    ring = np.zeros(32, np.float32)
    for t in range(40):
        ring = np.concatenate([[vols[t]], ring[:-1]]).astype(np.float32)
        n = t + 1
        for k in (5, 20):
            want = ring[:min(k, min(n, 32))].sum() / max(1, min(k, n))
            got = R.tail_mean_minclose(jnp.asarray(ring[None]), jnp.int32(n), k)
            np.testing.assert_allclose(float(got[0]), want, rtol=1e-6)
