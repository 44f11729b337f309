"""Decisions that sit on a threshold stay exact in float32.

On an H100 the OnlinePolicy heads at the default matmul precision run in TF32
and flip about one in seven decisions within 1e-4 of their threshold, so
their products ask for HIGHEST.  The ML gate's four-term product and the IRLS
fit are computed exactly at the default precision and ask for nothing.  Here:
the decisions within 1e-4 of the thresholds equal float64 NumPy (the same
check ``chip_smoke.py`` makes on the card), and the policy jaxprs carry the
precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as CS
from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
from qmmx_monolithic_monte_carlo_tpu.engine import gates as GT
from qmmx_monolithic_monte_carlo_tpu.engine.state import MlModel
from qmmx_monolithic_monte_carlo_tpu.models import logistic as L
from qmmx_monolithic_monte_carlo_tpu.models import online_policy as OP
from qmmx_monolithic_monte_carlo_tpu.types import DIR_UP

PARAMS = EngineParams.default()
Q = float(np.asarray(PARAMS.q_min_prob))


def _ml_ok(model, stop, x, lp=np.float32(100.0)):
    ok, _, _ = GT._ml_allowed(
        model, PARAMS, level_solid=x[0] > 0.5, level_price=lp, stop=stop,
        touch_count=x[2].astype(jnp.int32),
        direction=jnp.where(x[3] > 0.5, DIR_UP, DIR_UP + 1))
    return ok


def test_ml_gate_decisions_at_the_threshold_match_float64():
    coef, b, stop, x, want = CS.near_threshold_ml(1 << 16, Q, 3)
    got = np.asarray(jax.jit(lambda s, xx: _ml_ok(MlModel.from_weights(coef, b), s, xx))(
        jnp.asarray(stop), jnp.asarray(x)))
    assert want.size > 1000
    np.testing.assert_array_equal(got, want)


def test_policy_decisions_at_the_threshold_match_float64():
    w, x, want = CS.near_threshold_policy(1 << 16, 0.60, 4)
    pol = OP.PolicyParams.init().replace(w_entry=jnp.asarray(w))
    got = np.asarray(jax.jit(lambda xx: OP.score_entry(pol, xx) >= 0.60)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_irls_fit_matches_float64_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2048, 4)).astype(np.float32)
    y = rng.uniform(size=2048) < 1 / (1 + np.exp(-(x @ [0.8, -0.4, 0.3, 1.1] - 0.2)))
    w = rng.uniform(0.5, 2.0, 2048)
    ref_c, ref_b = CS.irls_f64(x, y, w)
    m = L.fit(jnp.asarray(x), jnp.asarray(y.astype(np.int32)), jnp.asarray(w, jnp.float32))
    np.testing.assert_allclose(np.asarray(m.coef), ref_c, atol=1e-4)
    assert float(m.intercept) == pytest.approx(ref_b, abs=1e-4)


@pytest.mark.parametrize("fn", ["policy_heads", "exit_heads", "policy_update"])
def test_products_ask_for_highest_precision(fn):
    pol = OP.PolicyParams.init()
    x = jnp.ones((8, 7), jnp.float32)
    if fn == "policy_heads":
        jaxpr = jax.make_jaxpr(lambda xx: OP.score_entry(pol, xx))(x)
    elif fn == "exit_heads":
        jaxpr = jax.make_jaxpr(lambda xx: OP.score_exit(pol, xx))(x)
    else:
        jaxpr = jax.make_jaxpr(lambda xx: OP.update_entry(pol, xx, 0, 1))(x[0])
    text = str(jaxpr)
    assert "dot_general" in text
    assert text.count("precision=None") == 0
    assert "HIGHEST" in text
