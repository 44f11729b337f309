"""The learning flywheel at path scale: harvest → refresh → re-simulate.

Covers simulation output feeding the learners.
- the weighted-IRLS refresh matches sklearn with sample_weight to 1e-6;
- a policy refreshed from harvested labels measurably shifts the engine's
  skip table on re-simulation (the closed loop, small scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.models import harvest as HV
from qmmx_monolithic_monte_carlo_tpu.models.online_policy import PolicyParams
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu.reasons import Reason
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


def test_ml_refresh_matches_sklearn_weighted():
    """ml_model_from_harvest == sklearn LogisticRegression(sample_weight)
    on the expanded bucket rows (the reference's batch retrain :3833-3853)."""
    sklearn = pytest.importorskip("sklearn")
    from sklearn.linear_model import LogisticRegression

    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(3)
        hv = HV.EngineHarvest.zero()
        counts = rng.integers(0, 40, (HV.ML_BUCKETS, 2)).astype(np.float64)
        hv = hv._replace(ml_counts=jnp.asarray(counts))
        pad = 0.35
        m = HV.ml_model_from_harvest(hv, stop_padding=pad, min_samples=50)
        assert bool(m.present)

        feats = np.asarray(HV._ml_bucket_features(pad), np.float64)
        x = np.concatenate([feats, feats], axis=0)
        y = np.concatenate([np.zeros(HV.ML_BUCKETS), np.ones(HV.ML_BUCKETS)])
        w = np.concatenate([counts[:, 0], counts[:, 1]])
        sk = LogisticRegression(max_iter=2000, tol=1e-12).fit(
            x, y, sample_weight=w)
        np.testing.assert_allclose(np.asarray(m.coef, np.float64),
                                   sk.coef_[0], atol=1e-6)
        np.testing.assert_allclose(float(m.intercept), sk.intercept_[0],
                                   atol=1e-6)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_ml_refresh_respects_min_samples_gate():
    hv = HV.EngineHarvest.zero()
    hv = hv._replace(ml_counts=hv.ml_counts.at[0, 1].set(10.0))
    m = HV.ml_model_from_harvest(hv, stop_padding=0.35, min_samples=50)
    assert not bool(m.present)


@pytest.mark.slow
def test_flywheel_policy_refresh_shifts_skip_table():
    """The closed loop at small scale: simulate → harvest → refresh the
    OnlinePolicy → re-simulate with the gate ARMED → the ONLINE_POLICY skip
    row moves and the decision surface changes."""
    lv = LEVELS
    params = EngineParams.default(stop_padding=0.15, tp_padding=0.10)
    bars = PG.gbm_paths(jax.random.key(2), num_paths=256, num_bars=64,
                        s0=100.0, sigma=0.5)
    tie = jax.random.uniform(jax.random.key(3), (256, 64))

    out0 = EP.engine_path_replay(bars, lv, params, tie, harvest=True)
    hv = out0.harvest
    assert float(hv.n_labeled) > 20

    pol = HV.policy_from_harvest(PolicyParams.init(), hv)
    # refreshed heads are nonzero (trained from simulation output)
    assert float(jnp.abs(pol.w_entry[0]).sum()) > 0
    assert float(jnp.abs(pol.w_entry[1]).sum()) > 0

    out1 = EP.engine_path_replay(
        bars, lv, params, tie, policy=pol, policy_gate_disabled=False,
        harvest=True)
    k = EP.SKIP_REASONS.index(Reason.ONLINE_POLICY)
    gate_skips = float(out1.skip_counts[k])
    # the armed refreshed gate actually vetoes some entries (or passes all —
    # either way the surface must differ from the ungated baseline)
    changed = (
        gate_skips > 0
        or float(jnp.sum(out1.trades)) != float(jnp.sum(out0.trades)))
    assert changed
    # and the loop can iterate: harvest from the gated run merges cleanly
    merged = hv.merge(out1.harvest)
    assert float(merged.n_labeled) >= float(hv.n_labeled)


@pytest.mark.slow
def test_holdout_eval_measures_armed_vs_disarmed_on_disjoint_seed():
    """holdout_eval: the eval rows replay ONE
    disjoint-seed population per arm (CRN — the disarmed arm must match a
    direct disarmed run bitwise) and the armed arms actually prune."""
    from qmmx_monolithic_monte_carlo_tpu.sim import flywheel as FW

    train_rounds, rows = FW.holdout_eval(
        0, 4242, LEVELS, EngineParams.default(), rounds=1,
        num_paths=1 << 10, eval_paths=1 << 10, num_bars=32, sigma=0.3,
        block_paths=1 << 10)
    assert [r["arm"] for r in rows] == ["disarmed", "round0"]
    base, armed = rows
    assert not base["ml_armed"] and base["skips_ml"] == 0
    # the disarmed eval row IS a plain engine run on the eval seed
    stats, _, _ = EP.mc_paths_engine(
        jax.random.key(4242), LEVELS, EngineParams.default(),
        num_paths=1 << 10, block_paths=1 << 10, num_bars=32, sigma=0.3)
    assert base["trades"] == float(stats.sum_trades)
    assert base["mean_r"] == float(stats.mean_r)
    # the trained arm armed a real model and changed the decision surface
    assert armed["ml_armed"]
    assert armed["skips_ml"] > 0 or armed["trades"] != base["trades"]


def test_explore_mix_restores_pruned_buckets():
    """``explore_paths`` (the survivorship fix): pure on-policy round 1 harvests ONLY trades that survived
    round 0's gate; the exploration mix merges a gates-off harvest on a
    disjoint seed fold, so every bucket's base rate stays observable.
    Structural contract: round 0 is untouched (gates-off already), and the
    mixed round-1 harvest equals pure + exploration count-for-count."""
    from qmmx_monolithic_monte_carlo_tpu.sim import flywheel as FW

    kw = dict(rounds=2, num_paths=1 << 10, num_bars=32, sigma=0.3,
              block_paths=1 << 10)
    pure = FW.policy_iteration(0, LEVELS, EngineParams.default(), **kw)
    mixed = FW.policy_iteration(0, LEVELS, EngineParams.default(),
                                explore_paths=1 << 10,
                                explore_reweight=False, **kw)
    assert pure[0].explored == 0 and mixed[0].explored == 0
    np.testing.assert_array_equal(np.asarray(pure[0].harvest.ml_counts),
                                  np.asarray(mixed[0].harvest.ml_counts))
    # round 1's MAIN population is identical (same seed fold, same round-0
    # models), so labeled splits exactly into main + explored (integer
    # counts in f32 — exact below 2^24)
    assert mixed[1].explored > 0
    assert mixed[1].labeled == pure[1].labeled + mixed[1].explored
    # merged counts dominate the pure harvest bucket-for-bucket: no losing
    # bucket the gate pruned away can vanish from the training stream
    assert np.all(np.asarray(mixed[1].harvest.ml_counts)
                  >= np.asarray(pure[1].harvest.ml_counts))
    # and the exploration population actually contributed LOSS labels (the
    # signal pure on-policy retraining starves on)
    extra = (np.asarray(mixed[1].harvest.ml_counts)
             - np.asarray(pure[1].harvest.ml_counts))
    assert extra[:, 0].sum() > 0


def test_reweight_to_base_restores_bucket_frequencies():
    """harvest.reweight_to_base: the importance-weighted refresh sees the
    BASE bucket frequencies with the merged label proportions (the pooled
    IRLS under-prune fix)."""
    base = HV.EngineHarvest.zero()
    surv = HV.EngineHarvest.zero()
    # bucket 0: base 10 losses + 10 wins; survivors pile 40 wins on top
    base = base._replace(ml_counts=base.ml_counts.at[0].set(
        jnp.array([10.0, 10.0])))
    surv = surv._replace(ml_counts=surv.ml_counts.at[0].set(
        jnp.array([0.0, 40.0])))
    # bucket 1: exploration-only (the gate pruned it) — 6 losses, 2 wins
    base = base._replace(ml_counts=base.ml_counts.at[1].set(
        jnp.array([6.0, 2.0])))
    # bucket 2: survivor-only (exploration never reached it) — dropped
    surv = surv._replace(ml_counts=surv.ml_counts.at[2].set(
        jnp.array([0.0, 3.0])))
    # policy block: counts AND feature sums must share one per-bucket scale
    base = base._replace(
        pol_counts=base.pol_counts.at[0].set(jnp.array([4.0, 4.0])))
    surv = surv._replace(
        pol_counts=surv.pol_counts.at[0].set(jnp.array([0.0, 8.0])),
        pol_sum_x1=surv.pol_sum_x1.at[0].set(jnp.array([0.0, 8.0])))

    rw = HV.reweight_to_base(base.merge(surv), base)
    ml = np.asarray(rw.ml_counts)
    # bucket 0: total back to the base 20, merged proportions (10:50) kept
    np.testing.assert_allclose(ml[0], [20 * 10 / 60, 20 * 50 / 60], rtol=1e-6)
    # bucket 1: untouched (exploration-only)
    np.testing.assert_allclose(ml[1], [6.0, 2.0])
    # bucket 2: zero base frequency -> zero weight
    np.testing.assert_allclose(ml[2], [0.0, 0.0])
    # policy: scale 8/16, sums scale with counts (bucket means invariant)
    np.testing.assert_allclose(np.asarray(rw.pol_counts)[0], [2.0, 6.0])
    np.testing.assert_allclose(np.asarray(rw.pol_sum_x1)[0], [0.0, 4.0])
