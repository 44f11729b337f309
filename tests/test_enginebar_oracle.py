"""Wicked-bar scalar-oracle parity for the FULL-engine MC surface.

``engine_path_replay``'s intrabar logic (stop/target off bar extremes, the
distance-weighted same-bar tie coin :3472-3480, escalation interacting with
intrabar extremes) is not exercised by flat-wick tapes, where ties are
impossible.  These tests replay random
WICKED tapes (GBM bridge extremes, paddings tight enough that both barriers
routinely land inside one bar) through the scalar oracle
(tests/oracle/enginebar.py) and require exact trades/wins/losses/escalation
parity plus f32-tolerance equity/drawdown."""

import jax.numpy as jnp
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.ops import pathgen as PG
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu.types import Levels

import jax

LEVEL_ROWS = [
    {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
    {"color": "orange", "type": "dashed", "index": 0, "price": 100.3},
    {"color": "teal", "type": "solid", "index": 0, "price": 99.7},
    {"color": "black", "type": "dashed", "index": 0, "price": 100.6},
]
LEVELS = Levels.from_rows(LEVEL_ROWS, max_levels=8)
ORACLE_LEVELS = [(100.0, 1), (100.3, 0), (99.7, 1), (100.6, 0)]


def _wicked_tape(seed, p, w, sigma=1.2):
    """High-vol GBM bars: bar ranges ~0.3-0.5 at s0=100 so tight stop/target
    pairs routinely both fall inside one bar (real tie-coin traffic)."""
    bars = PG.gbm_paths(
        jax.random.key(seed), num_paths=p, num_bars=w, s0=100.0,
        sigma=sigma, volume_model=PG.VolumeModel(ret_coupling=0.8))
    rng = np.random.default_rng(seed + 1)
    tie = rng.uniform(size=(p, w)).astype(np.float32)
    return bars, jnp.asarray(tie)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.slow
def test_engine_replay_matches_wicked_bar_oracle(seed):
    from .oracle import enginebar as OB

    p, w = 10, 160
    bars, tie = _wicked_tape(seed, p, w)
    params = EngineParams.default(
        stop_padding=0.12, tp_padding=0.08, cooldown_s=120.0)

    out = EP.engine_path_replay(
        bars, LEVELS, params, tie, escalation=True, bar0_minute=0)

    o = np.asarray(bars.open)
    h = np.asarray(bars.high)
    l = np.asarray(bars.low)
    c = np.asarray(bars.close)
    v = np.asarray(bars.volume)
    tie_np = np.asarray(tie)

    ties_total = 0
    for i in range(p):
        res = OB.engine_bar_path(
            o[i], h[i], l[i], c[i], v[i], tie_np[i], ORACLE_LEVELS,
            stop_padding=0.12, tp_padding=0.08, cooldown_s=120.0,
            escalation=True)
        ties_total += res["ties_seen"]
        assert res["trades"] == int(out.trades[i]), f"path {i} trades"
        assert res["wins"] == int(out.wins[i]), f"path {i} wins"
        assert res["losses"] == int(out.losses[i]), f"path {i} losses"
        assert res["escalations"] == int(out.escalations[i]), f"path {i} escal"
        assert res["open_at_end"] == bool(out.open_at_end[i])
        np.testing.assert_allclose(res["equity"], float(out.equity[i]),
                                   atol=2e-4)
        np.testing.assert_allclose(res["max_dd"], float(out.max_dd[i]),
                                   atol=2e-4)
    # the tape actually exercises the tie coin (the point of this test)
    assert ties_total > 0


def test_wicked_tape_exercises_escalation_and_skips():
    """Escalation fires on at least one wicked tape, and the oracle's
    first-fail skip tally matches the pipeline's aggregate table."""
    from .oracle import enginebar as OB

    p, w = 24, 200
    bars, tie = _wicked_tape(7, p, w, sigma=0.9)
    params = EngineParams.default(
        stop_padding=0.25, tp_padding=0.18, cooldown_s=60.0)

    out = EP.engine_path_replay(
        bars, LEVELS, params, tie, escalation=True, bar0_minute=0)

    o, h, l = np.asarray(bars.open), np.asarray(bars.high), np.asarray(bars.low)
    c, v = np.asarray(bars.close), np.asarray(bars.volume)
    tie_np = np.asarray(tie)

    agg: dict[str, int] = {}
    escal = 0
    for i in range(p):
        res = OB.engine_bar_path(
            o[i], h[i], l[i], c[i], v[i], tie_np[i], ORACLE_LEVELS,
            stop_padding=0.25, tp_padding=0.18, cooldown_s=60.0,
            escalation=True)
        escal += res["escalations"]
        for k, n in res["skips"].items():
            agg[k] = agg.get(k, 0) + n
    assert escal == int(np.asarray(out.escalations).sum())
    assert escal > 0, "tape must exercise escalation-on-extremes"
    skip_map = {r.name: int(s)
                for r, s in zip(EP.SKIP_REASONS, np.asarray(out.skip_counts))}
    for k, n in agg.items():
        assert skip_map.get(k, 0) == n, (k, n, skip_map.get(k, 0))
    assert sum(agg.values()) == int(np.asarray(out.skip_counts).sum())
