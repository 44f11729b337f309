"""The XLA lifecycle pipelines against the scalar oracles, for every sampler.

Bars come from the production sampler (``sim/pathsim.sample_block``: gbm,
bootstrap, block bootstrap and heston, with and without antithetic pairs);
the gated replay (``sim/gatedpath``) and the full engine
(``sim/enginepath``) must then reach exactly the oracle's decisions path by
path (tests/oracle/gated.py, tests/oracle/enginebar.py).  The validation the
samplers share is checked on the pipelines' public entry points."""

import jax
import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
from qmmx_monolithic_monte_carlo_tpu.sim import gatedpath
from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
from qmmx_monolithic_monte_carlo_tpu.sim.gatedpath import GateConfig
from qmmx_monolithic_monte_carlo_tpu.types import Levels

from .samples import DT, history

LEVEL_ROWS = [
    {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
    {"color": "orange", "type": "dashed", "index": 0, "price": 100.3},
    {"color": "teal", "type": "solid", "index": 0, "price": 99.7},
]
LEVELS = Levels.from_rows(LEVEL_ROWS, max_levels=8)
ORACLE_LEVELS = [(100.0, 1), (100.3, 0), (99.7, 1)]
HESTON = dict(v0=0.2, kappa=2.0, theta=0.2, xi=0.9, rho=-0.6)
SAMPLERS = [("gbm", False), ("gbm", True), ("bootstrap", False),
            ("block_bootstrap", False), ("heston", False), ("heston", True)]


def _bars(sampler, antithetic, p, w, seed):
    bars = pathsim.sample_block(
        jax.random.key(seed), block_paths=p, num_bars=w, s0=100.0, mu=0.0,
        sigma=0.9, dt=DT, sampler=sampler,
        hist_bars=history(seed, 300) if "bootstrap" in sampler else None,
        antithetic=antithetic, block_len=5, heston=HESTON)
    tie = np.random.default_rng(seed).uniform(size=(p, w)).astype(np.float32)
    return bars, tie


def _np(bars):
    return [np.asarray(getattr(bars, f)) for f in ("open", "high", "low", "close",
                                                   "volume")]


@pytest.mark.parametrize("sampler,antithetic", SAMPLERS)
def test_gated_pipeline_matches_oracle(sampler, antithetic):
    from .oracle import gated as O

    p, w = 16, 40
    bars, tie = _bars(sampler, antithetic, p, w, seed=11)
    params = EngineParams.default()
    gate = GateConfig.default()
    out = gatedpath.gated_path_replay(bars, LEVELS, params, gate, tie)
    o, h, l, c, _ = _np(bars)
    total = 0
    for i in range(p):
        want = O.lifecycle_path(
            o[i], h[i], l[i], c[i], tie[i], ORACLE_LEVELS,
            contact_prox=0.05, stop_padding=0.35, tp_padding=0.25,
            touch_limit=int(gate.touch_limit), q_min_prob=float(gate.q_min_prob),
            cooldown_bars=int(gate.cooldown_bars),
            touch_gap_bars=int(gate.touch_gap_bars))
        for k in ("trades", "wins", "losses"):
            assert int(np.asarray(getattr(out, k))[i]) == want[k], (i, k)
        assert bool(np.asarray(out.open_at_end)[i]) == want["open_at_end"]
        assert float(np.asarray(out.equity)[i]) == pytest.approx(want["equity"], abs=1e-5)
        total += want["trades"]
    assert total > 0


@pytest.mark.parametrize("sampler,antithetic", SAMPLERS)
def test_engine_pipeline_matches_oracle(sampler, antithetic):
    from .oracle import enginebar as OB

    p, w = 12, 48
    bars, tie = _bars(sampler, antithetic, p, w, seed=23)
    params = EngineParams.default(stop_padding=0.25, tp_padding=0.18,
                                  cooldown_s=60.0)
    out = EP.engine_path_replay(bars, LEVELS, params, tie, escalation=True)
    o, h, l, c, v = _np(bars)
    total = 0
    for i in range(p):
        want = OB.engine_bar_path(o[i], h[i], l[i], c[i], v[i], tie[i],
                                  ORACLE_LEVELS, stop_padding=0.25,
                                  tp_padding=0.18, cooldown_s=60.0,
                                  escalation=True)
        for k in ("trades", "wins", "losses", "escalations"):
            assert int(np.asarray(getattr(out, k))[i]) == want[k], (i, k)
        assert bool(np.asarray(out.open_at_end)[i]) == want["open_at_end"]
        np.testing.assert_allclose(float(np.asarray(out.equity)[i]),
                                   want["equity"], atol=2e-4)
        total += want["trades"]
    assert total > 0


@pytest.mark.parametrize("bad", ["no_history", "antithetic_bootstrap",
                                 "short_history", "unknown_sampler"])
@pytest.mark.parametrize("pipeline", ["gated", "engine"])
def test_pipelines_refuse_bad_sampler_setups(bad, pipeline):
    kw = dict(num_paths=256, num_bars=8, block_paths=256)
    if bad == "no_history":
        kw.update(sampler="bootstrap")
    elif bad == "antithetic_bootstrap":
        kw.update(sampler="bootstrap", hist_bars=history(3, 100), antithetic=True)
    elif bad == "short_history":
        kw.update(sampler="block_bootstrap", hist_bars=history(3, 30), block_len=40)
    else:
        kw.update(sampler="garch")
    run = (lambda: gatedpath.mc_paths_gated(jax.random.key(0), LEVELS,
                                            EngineParams.default(), **kw)) \
        if pipeline == "gated" else \
        (lambda: EP.mc_paths_engine(jax.random.key(0), LEVELS,
                                    EngineParams.default(), **kw))
    with pytest.raises(ValueError):
        run()
