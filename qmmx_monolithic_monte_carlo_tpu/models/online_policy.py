"""OnlinePolicy: the two-head online logistic model, in pure JAX.

Re-expression of the reference ``OnlinePolicy`` (qmmx_monolithic.py:274-379):

* entry head over actions (go_long, go_short, skip); exit head over
  (exit_now, hold); one weight vector per action, all ``POLICY_FEATURE_DIM``-dim.
* ``score_*``: sigmoid(w . x) per action, with the reference's hard clamp of the
  logit at +/-50 (:20-26).
* SGD update (:337-341): w -= lr * ((pred - y) * x + l2 * w), lr=0.03, l2=1e-6.
* perceptron update (:343-347): w += lr * (y - 1[pred >= 0.5]) * x.

Everything is jit-able and vmap-able over batches of (x, action, label) so the
incremental retraining pass (ref :3753-3803) becomes one ``lax.scan`` over the
event stream — updates are order-dependent (true SGD), so a scan, not a mean.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops.features import POLICY_FEATURE_DIM
from ..utils import tracectx

ENTRY_ACTIONS = ("go_long", "go_short", "skip")
EXIT_ACTIONS = ("exit_now", "hold")
A_GO_LONG, A_GO_SHORT, A_SKIP = 0, 1, 2
A_EXIT_NOW, A_HOLD = 0, 1


@struct.dataclass
class PolicyParams:
    w_entry: jnp.ndarray  # f32[3, D]
    w_exit: jnp.ndarray   # f32[2, D]
    lr: jnp.ndarray       # f32
    l2: jnp.ndarray       # f32
    use_perceptron: jnp.ndarray  # bool

    @classmethod
    def init(cls, lr: float = 0.03, l2: float = 1e-6,
             use_perceptron: bool = False, dim: int = POLICY_FEATURE_DIM) -> "PolicyParams":
        # cached per (args, default backend): eager scalar creation
        # dispatches one op per scalar (see ops/guard.GuardParams.default);
        # never cached under a trace (utils/tracectx)
        if not tracectx.eager():
            return _build_policy_init(float(lr), float(l2),
                                      bool(use_perceptron), int(dim))
        return _policy_init(float(lr), float(l2), bool(use_perceptron),
                            int(dim), jax.default_backend())


@functools.lru_cache(maxsize=None)
def _policy_init(lr: float, l2: float, use_perceptron: bool, dim: int,
                 backend: str) -> "PolicyParams":
    return _build_policy_init(lr, l2, use_perceptron, dim)


def _build_policy_init(lr: float, l2: float, use_perceptron: bool,
                       dim: int) -> "PolicyParams":
    return PolicyParams(
        w_entry=jnp.zeros((len(ENTRY_ACTIONS), dim), jnp.float32),
        w_exit=jnp.zeros((len(EXIT_ACTIONS), dim), jnp.float32),
        lr=jnp.float32(lr),
        l2=jnp.float32(l2),
        use_perceptron=jnp.asarray(use_perceptron),
    )


def _sigmoid_clamped(z):
    """Reference ``_sigmoid`` (:20-26): exactly 0/1 outside +/-50."""
    return jnp.where(z < -50.0, 0.0, jnp.where(z > 50.0, 1.0, jax.nn.sigmoid(z)))


# Full float32 products: on a GPU a TF32 product can flip a gate decision near
# its threshold, which the CPU oracles pin.
_HIGHEST = jax.lax.Precision.HIGHEST


def _head_scores(w, x) -> jnp.ndarray:
    return _sigmoid_clamped(jnp.einsum("ad,...d->...a", w, jnp.asarray(x, jnp.float32),
                                       precision=_HIGHEST))


def score_entry(params: PolicyParams, x) -> jnp.ndarray:
    """Per-action probabilities, f32[..., 3] ordered as ENTRY_ACTIONS."""
    return _head_scores(params.w_entry, x)


def score_exit(params: PolicyParams, x) -> jnp.ndarray:
    return _head_scores(params.w_exit, x)


def _update_head(w, lr, l2, use_perceptron, x, action, label):
    """One SGD/perceptron step on head ``w`` (f32[A, D]) for a single event."""
    x = jnp.asarray(x, jnp.float32)
    wa = w[action]
    pred = _sigmoid_clamped(jnp.dot(wa, x, precision=_HIGHEST))
    y = jnp.asarray(label, jnp.float32)
    sgd_delta = -lr * ((pred - y) * x + l2 * wa)
    perc_delta = lr * (y - (pred >= 0.5).astype(jnp.float32)) * x
    delta = jnp.where(use_perceptron, perc_delta, sgd_delta)
    return w.at[action].add(delta)


def update_entry(params: PolicyParams, x, action, label) -> PolicyParams:
    """``update_entry`` (:357-363) as a pure step."""
    return params.replace(
        w_entry=_update_head(
            params.w_entry, params.lr, params.l2, params.use_perceptron, x, action, label
        )
    )


def update_exit(params: PolicyParams, x, action, label) -> PolicyParams:
    return params.replace(
        w_exit=_update_head(
            params.w_exit, params.lr, params.l2, params.use_perceptron, x, action, label
        )
    )


@jax.jit
def train_events(params: PolicyParams, xs, phases, actions, labels, valid) -> PolicyParams:
    """Sequential SGD over a labeled event stream (the incremental retrain pass,
    ref :3753-3803), as one ``lax.scan``.

    xs: f32[N, D]; phases: i32[N] (0=entry, 1=exit); actions: i32[N] (index into
    the phase's action tuple); labels: i32[N]; valid: bool[N] masks padding.
    """

    def step(p, ev):
        x, phase, action, label, ok = ev
        p_entry = update_entry(p, x, action, label)
        p_exit = update_exit(p, x, action, label)
        new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(phase == 0, a, b), p_entry, p_exit
        )
        new = jax.tree_util.tree_map(lambda a, b: jnp.where(ok, a, b), new, p)
        return new, None

    out, _ = jax.lax.scan(
        step, params,
        (jnp.asarray(xs, jnp.float32), jnp.asarray(phases, jnp.int32),
         jnp.asarray(actions, jnp.int32), jnp.asarray(labels, jnp.int32),
         jnp.asarray(valid)),
    )
    return out


def entry_gate(params: PolicyParams, x, side_is_long,
               min_go: float = 0.60, max_skip: float = 0.55) -> jnp.ndarray:
    """The app-level policy gate (ref :3083-3085): chosen-action score >= 0.60 AND
    skip score < 0.55."""
    scores = score_entry(params, x)
    chosen = jnp.where(jnp.asarray(side_is_long), scores[..., A_GO_LONG], scores[..., A_GO_SHORT])
    return jnp.logical_and(chosen >= min_go, scores[..., A_SKIP] < max_skip)
