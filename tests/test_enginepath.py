"""Full-engine generated-path lifecycle vs the live tick engine.

The flat-wick construction maps sim/enginepath.py 1:1 onto
engine/lifecycle.run_ticks: bars with high == low == close are exactly what
one tick per minute produces through ``ingest_tick`` (:1857-1883), stop/
target hits on the bar extremes collapse to tick-price hits, and with
``exit_at_close=True`` the scaled pipeline prices exits the way the live
loop does (:2979/:2990).  Every gate then runs through BOTH stacks on
identical inputs — guard, touch memory, contact latch, confidence, veto,
ML gate, OnlinePolicy gate, escalation — and per-bar opened/closed/
escalated plus final equity/wins/losses must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.engine import lifecycle as LC
from qmmx_monolithic_monte_carlo_tpu.engine.state import EngineCarry, MlModel
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as OP
from qmmx_monolithic_monte_carlo_tpu.ops.pathgen import PathBars
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu.types import Levels

LEVELS = Levels.from_rows(
    [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.6},
    ],
    max_levels=8,
)


def _flat_tape(seed, p, w):
    """Flat-wick f32 tapes: small steps keep target crossings within
    CONTACT_PROX of the barrier (live escalation's near-target check)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.035, (p, w)).astype(np.float32)
    c = np.float32(100.0) + np.cumsum(steps, axis=1, dtype=np.float32)
    c = c.astype(np.float32)
    o = np.concatenate([np.full((p, 1), 100.0, np.float32), c[:, :-1]], axis=1)
    # volume with enough structure to flip guard/veto gates
    base = rng.lognormal(13.0, 0.4, (p, w)).astype(np.float32)
    v = base * (1.0 + 2.0 * (np.abs(steps) > 0.05)).astype(np.float32)
    return PathBars(open=jnp.asarray(o), high=jnp.asarray(c),
                    low=jnp.asarray(c), close=jnp.asarray(c),
                    volume=jnp.asarray(v))


def _trained_policy(seed):
    """A nonzero policy whose gate passes sometimes (not always/never)."""
    rng = np.random.default_rng(seed)
    pol = OP.PolicyParams.init()
    w_entry = rng.normal(0, 0.8, (3, 7)).astype(np.float32)
    w_entry[0, 0] += 0.8   # bias go_long up so some entries clear 0.60
    w_entry[1, 0] += 0.8
    w_entry[2, 0] -= 0.5   # skip below 0.55 often
    return pol.replace(w_entry=jnp.asarray(w_entry))


@pytest.mark.parametrize("seed,policy_on,ml_on", [
    (0, False, False),
    (1, True, False),
    (2, False, True),
    (3, True, True),
])
@pytest.mark.slow
def test_full_engine_matches_tick_engine_on_flat_wick_tape(seed, policy_on, ml_on):
    p, w = 12, 220
    bars = _flat_tape(seed, p, w)
    params = EngineParams.default(stale_ms=1 << 30, cooldown_s=100.0)
    policy = _trained_policy(seed) if policy_on else None
    ml = (MlModel.from_weights(np.array([0.4, -0.8, -0.3, 0.2], np.float32), 0.55)
          if ml_on else None)
    tie = jnp.zeros((p, w), jnp.float32)  # flat wicks: ties impossible

    out = EP.engine_path_replay(
        bars, LEVELS, params, tie,
        policy=policy, ml_model=ml,
        policy_gate_disabled=not policy_on,
        escalation=True, bar0_minute=0, exit_at_close=True,
    )

    # the tick engine over the same tape, one tick per minute
    ts = (np.arange(w, dtype=np.int64) * 60_000).astype(np.int32)
    mins = np.arange(w, dtype=np.int32)

    def run_one(prices, vols):
        carry = EngineCarry.init(LEVELS.max_levels)
        return LC.run_ticks(
            carry, LEVELS, params, ts, prices, vols,
            policy=policy if policy is not None else OP.PolicyParams.init(),
            ml_model=ml if ml is not None else MlModel.absent(),
            minutes_since_open=mins,
            policy_gate_disabled=not policy_on,
        )

    carry_f, events = jax.jit(jax.vmap(run_one))(
        jnp.asarray(bars.close), jnp.asarray(bars.volume))

    opened_ticks = np.asarray(events.opened).sum(axis=1)
    np.testing.assert_array_equal(np.asarray(out.trades), opened_ticks)
    np.testing.assert_array_equal(np.asarray(out.wins), np.asarray(carry_f.wins))
    np.testing.assert_array_equal(np.asarray(out.losses), np.asarray(carry_f.losses))
    np.testing.assert_array_equal(
        np.asarray(out.escalations), np.asarray(events.escalated).sum(axis=1))
    np.testing.assert_allclose(np.asarray(out.equity),
                               np.asarray(carry_f.equity_r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.max_dd),
                               -np.asarray(carry_f.max_dd_r), atol=1e-5)
    open_end = np.asarray(carry_f.position.side) != 0
    np.testing.assert_array_equal(np.asarray(out.open_at_end), open_end)
    # the batch actually traded (tape/params produce activity)
    assert int(np.asarray(out.trades).sum()) > 0


def test_full_engine_gates_fire_and_escalations_exist():
    """Across a larger flat-wick batch the deep gates actually trigger:
    volume veto skips, accumulation-family skips, and target escalations."""
    p, w = 64, 400
    bars = _flat_tape(9, p, w)
    params = EngineParams.default(stale_ms=1 << 30)
    tie = jnp.zeros((p, w), jnp.float32)
    out = EP.engine_path_replay(
        bars, LEVELS, params, tie, escalation=True, exit_at_close=True,
    )
    skips = {r.name: float(s)
             for r, s in zip(EP.SKIP_REASONS, np.asarray(out.skip_counts))}
    assert skips["TOO_FAR"] > 0
    assert skips["CONF_LOW"] > 0
    assert skips["CONTRA_VOL_LONG"] + skips["CONTRA_VOL_SHORT"] > 0
    assert int(np.asarray(out.escalations).sum()) > 0
    # escalated paths can bank more than the plain scaffold's reward
    assert int(np.asarray(out.trades).sum()) > 0


def test_mc_paths_engine_streams_blocks():
    params = EngineParams.default()
    stats, skips, escal = EP.mc_paths_engine(
        jax.random.key(0), LEVELS, params, num_paths=1 << 12, num_bars=32,
        sigma=0.3, block_paths=1 << 11)
    assert float(stats.n) == 1 << 12
    assert float(stats.n_entered) > 0
    assert float(stats.sum_trades) >= float(stats.n_entered)
    # determinism: same key + block layout → identical stats (block RNG is
    # keyed by global block index)
    again, skips1, escal1 = EP.mc_paths_engine(
        jax.random.key(0), LEVELS, params, num_paths=1 << 12, num_bars=32,
        sigma=0.3, block_paths=1 << 11)
    for f in ("n", "n_entered", "n_tp", "n_stop", "sum_trades", "sum_r"):
        assert float(getattr(stats, f)) == float(getattr(again, f)), f
    np.testing.assert_array_equal(np.asarray(skips), np.asarray(skips1))
    assert int(escal) == int(escal1)


def test_state_envelope_rejects_unrepresentable_params():
    """fatigue_hits > TAP_STACK and guard vol windows wider than
    the shared BARS_RING would silently diverge in the windowed XLA forms —
    the launch-time envelope check must reject them, and must keep accepting
    the full representable range."""
    from qmmx_monolithic_monte_carlo_tpu.ops import guard as G
    from qmmx_monolithic_monte_carlo_tpu.ops import touch as T
    from qmmx_monolithic_monte_carlo_tpu.ops.regular import TAP_STACK

    params = EngineParams.default()
    kw = dict(num_paths=1 << 8, num_bars=8, sigma=0.3, block_paths=1 << 8)

    bad_touch = T.TouchMemoryParams.default().replace(
        fatigue_hits=jnp.int32(TAP_STACK + 1))
    with pytest.raises(ValueError, match="fatigue_hits"):
        EP.mc_paths_engine(jax.random.key(0), LEVELS, params,
                           touch_params=bad_touch, **kw)

    bad_guard = G.GuardParams.default().replace(
        vol_long=jnp.int32(EP.BARS_RING + 1))
    with pytest.raises(ValueError, match="vol windows"):
        EP.mc_paths_engine(jax.random.key(0), LEVELS, params,
                           guard_params=bad_guard, **kw)

    # the boundary of the envelope still runs
    ok_touch = T.TouchMemoryParams.default().replace(
        fatigue_hits=jnp.int32(TAP_STACK))
    stats, _, _ = EP.mc_paths_engine(jax.random.key(0), LEVELS, params,
                                     touch_params=ok_touch, **kw)
    assert float(stats.n) == 1 << 8
