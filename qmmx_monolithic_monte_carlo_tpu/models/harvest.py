"""Per-trade label harvest: the reference's learning flywheel at path scale.

In the reference every trade labels its attached policy_event by pnl sign on
close (qmmx_monolithic.py:1934-1945); labeled events retrain the OnlinePolicy
every 2 minutes (:3753-3803) and the ``contact_events ⋈ trades`` join feeds
the batch sklearn LR (:3833-3894).  Simulation/trading *produces the training
data*.  At host scale that loop lives in ``io/trainstore.py``; this module is
its scaled re-expression for the billion-path engine surface
(sim/enginepath.py):

* every CLOSED simulated trade contributes one labeled example — label
  ``pnl > 0`` exactly as :1934-1945 — with features captured at its ENTRY bar;
* the per-trade features are tiny and near-discrete, so the harvest is a set
  of exact sufficient statistics small enough to ride in the scan carry:

  - **ML gate** (4-dim, :1457-1461): ``[lvl_kind, |level-stop|, touch_count,
    direction]``.  At entry ``|level-stop| == stop_padding`` (a config
    constant) and the other three are small ints, so a count per
    ``(touch_count, kind, direction, label)`` bucket is EXACT:
    ``ml_counts[TC_CAP*4 buckets, 2 labels]``.
  - **OnlinePolicy entry head** (7-dim, :308-331): at path scale the vector is
    ``[1, min(1,dist), 0, 1-glf, glf, confl, min(1,(bar0+t)/390)]``.  The
    discrete part keys the bucket ``(glf, confl)``; the two continuous
    coordinates are harvested as per-bucket SUMS (count, Σx1, Σx6), so the
    refresh trains on exact per-bucket means.

* ``ml_model_from_harvest`` replays :3833-3853 on the harvested counts: a
  weighted IRLS logistic fit (models/logistic.fit, sample_weight = bucket
  count) behind the same ≥ ``min_samples`` gate (:3838-3840), hot-swappable
  into the engine as a 4-feature ``MlModel`` (the fixed-skew posture —
  PARITY.md Q5).
* ``policy_from_harvest`` replays the incremental entry-head refresh
  (:3753-3803) as weighted logistic fits of the go_long / go_short heads on
  the bucket-mean feature rows (the skip and exit heads are never labeled by
  trades in the reference, so they are left untouched).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..engine.state import MlModel
from . import logistic
from .online_policy import A_GO_LONG, A_GO_SHORT, PolicyParams

TC_CAP = 8            # touch-count clamp for the ML bucket axis (entries with
                      # tc >= overtouch_limit are gated; default limit is 4)
ML_BUCKETS = TC_CAP * 4          # (tc, kind, glf) → tc*4 + kind*2 + glf
POL_BUCKETS = 4                  # (glf, confl)    → glf*2 + confl


class EngineHarvest(NamedTuple):
    """Sufficient statistics of the closed-trade label stream (leading axes
    broadcast, e.g. [S] for per-symbol universes)."""

    ml_counts: jnp.ndarray   # f32[..., ML_BUCKETS, 2]  (bucket, label)
    pol_counts: jnp.ndarray  # f32[..., POL_BUCKETS, 2]
    pol_sum_x1: jnp.ndarray  # f32[..., POL_BUCKETS, 2]  Σ min(1, dist)
    pol_sum_x6: jnp.ndarray  # f32[..., POL_BUCKETS, 2]  Σ min(1, minutes/390)

    @classmethod
    def zero(cls, *lead) -> "EngineHarvest":
        return cls(
            ml_counts=jnp.zeros(lead + (ML_BUCKETS, 2), jnp.float32),
            pol_counts=jnp.zeros(lead + (POL_BUCKETS, 2), jnp.float32),
            pol_sum_x1=jnp.zeros(lead + (POL_BUCKETS, 2), jnp.float32),
            pol_sum_x6=jnp.zeros(lead + (POL_BUCKETS, 2), jnp.float32),
        )

    def merge(self, other: "EngineHarvest") -> "EngineHarvest":
        return jax.tree_util.tree_map(jnp.add, self, other)

    @property
    def n_labeled(self) -> jnp.ndarray:
        """Total closed-trade examples harvested."""
        return jnp.sum(self.ml_counts, axis=(-2, -1))


def reweight_to_base(merged: EngineHarvest, base: EngineHarvest) -> EngineHarvest:
    """Importance-reweight a survivors+exploration merge to the BASE
    (gates-off) bucket distribution.

    The ML/policy gates decide DETERMINISTICALLY per bucket, so a merged
    harvest's within-bucket label proportions are unbiased (passed buckets:
    survivors + exploration; pruned buckets: exploration only — acceptance
    is 0/1, no importance weights needed inside a bucket).  What the merge
    distorts is the CROSS-bucket weighting the pooled IRLS fit sees: passed
    buckets carry survivor counts on top of their exploration counts, so a
    win-tilted stream inflates every shared coefficient and the refreshed
    gate under-prunes.  Scaling each bucket's counts AND feature sums to the
    exploration harvest's bucket totals restores the base frequencies while
    keeping the merged (higher-precision) per-bucket proportions and bucket-
    mean features — the importance-weighted refresh.  Buckets the
    exploration population never reached scale to zero weight (their base
    frequency is ~0 at this sample size)."""
    def rw(m, b):
        m_tot = jnp.sum(m, axis=-1, keepdims=True)
        b_tot = jnp.sum(b, axis=-1, keepdims=True)
        return m * jnp.where(m_tot > 0, b_tot / jnp.maximum(m_tot, 1.0), 0.0)

    ml_scaled = rw(merged.ml_counts, base.ml_counts)
    # one shared per-bucket scale for the policy block: counts and Σx must
    # scale together so bucket-mean features (Σx / n) are unchanged
    p_tot = jnp.sum(merged.pol_counts, axis=-1, keepdims=True)
    b_tot = jnp.sum(base.pol_counts, axis=-1, keepdims=True)
    p_scale = jnp.where(p_tot > 0, b_tot / jnp.maximum(p_tot, 1.0), 0.0)
    return EngineHarvest(
        ml_counts=ml_scaled,
        pol_counts=merged.pol_counts * p_scale,
        pol_sum_x1=merged.pol_sum_x1 * p_scale,
        pol_sum_x6=merged.pol_sum_x6 * p_scale,
    )


def ml_bucket(touch_count, kind_solid, go_long):
    """ML-gate bucket index: tc*4 + kind*2 + glf, tc clamped to TC_CAP-1."""
    tc = jnp.clip(jnp.asarray(touch_count, jnp.int32), 0, TC_CAP - 1)
    k = jnp.asarray(kind_solid).astype(jnp.int32)
    g = jnp.asarray(go_long).astype(jnp.int32)
    return tc * 4 + k * 2 + g


def pol_bucket(go_long, confluence):
    """Policy bucket index: glf*2 + confl."""
    g = jnp.asarray(go_long).astype(jnp.int32)
    c = jnp.asarray(confluence).astype(jnp.int32)
    return g * 2 + c


def harvest_closed(
    h: EngineHarvest, *, closed, label_pos, pend_ml, pend_pol, pend_x1,
    pend_x6,
) -> EngineHarvest:
    """Fold one bar's closed trades ([P] masks/indices) into the harvest.

    ``pend_*`` are the entry-time bucket indices / continuous coords carried
    while each position was open; ``label_pos`` is pnl > 0 (:1934-1945)."""
    closed_f = jnp.asarray(closed).astype(jnp.float32)
    lab = jnp.asarray(label_pos).astype(jnp.int32)
    ml_oh = jax.nn.one_hot(pend_ml * 2 + lab, 2 * ML_BUCKETS,
                           dtype=jnp.float32) * closed_f[:, None]
    pol_oh = jax.nn.one_hot(pend_pol * 2 + lab, 2 * POL_BUCKETS,
                            dtype=jnp.float32) * closed_f[:, None]
    return EngineHarvest(
        ml_counts=h.ml_counts + ml_oh.sum(0).reshape(ML_BUCKETS, 2),
        pol_counts=h.pol_counts + pol_oh.sum(0).reshape(POL_BUCKETS, 2),
        pol_sum_x1=h.pol_sum_x1
        + (pol_oh * pend_x1[:, None]).sum(0).reshape(POL_BUCKETS, 2),
        pol_sum_x6=h.pol_sum_x6
        + (pol_oh * pend_x6[:, None]).sum(0).reshape(POL_BUCKETS, 2),
    )


def _ml_bucket_features(stop_padding):
    """The exact 4-dim serving features of every ML bucket (:1457-1461):
    [kind_solid, |level-stop| = stop_padding, touch_count, go_long].
    Uses the default float dtype so the refresh fit runs in f64 when x64 is
    enabled (the BASELINE 1e-6 sklearn-parity posture)."""
    b = jnp.arange(ML_BUCKETS)
    tc = (b // 4) * 1.0
    kind = ((b // 2) % 2) * 1.0
    glf = (b % 2) * 1.0
    pad = jnp.full((ML_BUCKETS,), stop_padding, tc.dtype)
    return jnp.stack([kind, pad, tc, glf], axis=1)       # [B, 4]


# Billion-path harvests produce count masses ~1e8+: against sklearn's fixed
# L2 (C=1) the data term then dwarfs the penalty and near-separable bucket
# sets drive unbounded Newton steps (saturated sigmoids → a singular
# unpenalized-intercept row → NaN).  Refreshes above this mass rescale the
# weights to it — identical label proportions, so the fit is statistically
# the same model with a numerically meaningful penalty.
WEIGHT_MASS_CAP = 1.0e5


def _capped(w):
    tot = jnp.sum(w)
    scale = jnp.where(tot > WEIGHT_MASS_CAP, WEIGHT_MASS_CAP / tot, 1.0)
    return w * scale, tot


def ml_model_from_harvest(
    h: EngineHarvest, *, stop_padding, min_samples: int = 50, c: float = 1.0,
    max_iter: int = 100,
) -> MlModel:
    """The batch-LR retrain (:3833-3853) on harvested counts.

    Weighted IRLS on the exact bucket features; below ``min_samples`` labeled
    trades the model stays absent (reference gate :3838-3840).  jit-safe: the
    sample gate is a traced select, so this composes with jitted loops."""
    feats = _ml_bucket_features(stop_padding)            # [B, 4]
    x = jnp.concatenate([feats, feats], axis=0)          # label-0 rows, label-1
    y = jnp.concatenate([jnp.zeros(ML_BUCKETS), jnp.ones(ML_BUCKETS)])
    w, tot = _capped(jnp.concatenate([h.ml_counts[:, 0], h.ml_counts[:, 1]]))
    m = logistic.fit(x, y, sample_weight=w, c=c, max_iter=max_iter)
    ok = jnp.logical_and(
        tot >= min_samples,
        jnp.all(jnp.isfinite(m.coef)) & jnp.isfinite(m.intercept))
    return MlModel(
        coef=jnp.where(ok, m.coef.astype(jnp.float32),
                       jnp.zeros((4,), jnp.float32)),
        intercept=jnp.where(ok, m.intercept.astype(jnp.float32), 0.0),
        n_features=jnp.int32(4),
        present=ok,
    )


def _pol_bucket_features(h: EngineHarvest):
    """Bucket-mean 6-dim feature rows (bias handled by the fit intercept):
    [x1̄, vol_trend=0, from_above, from_below, confl, x6̄] per (bucket, label)
    → [2*POL_BUCKETS, 6] plus the matching labels and counts."""
    cnt = h.pol_counts.reshape(-1)                       # [B*2] (label-major last)
    safe = jnp.maximum(cnt, 1.0)
    x1 = h.pol_sum_x1.reshape(-1) / safe
    x6 = h.pol_sum_x6.reshape(-1) / safe
    b = jnp.arange(POL_BUCKETS).repeat(2)
    glf = (b // 2).astype(jnp.float32)
    confl = (b % 2).astype(jnp.float32)
    vt = jnp.zeros_like(x1)
    feats = jnp.stack([x1, vt, 1.0 - glf, glf, confl, x6], axis=1)
    labels = jnp.tile(jnp.arange(2), POL_BUCKETS).astype(jnp.float32)
    return feats, labels, cnt, glf


def ml_batch_from_harvest(h: EngineHarvest, *, stop_padding):
    """Expand an [S]-batched harvest into the (xs, ys, weights) triple of
    ``parallel.universe.universe_policy_refresh`` / ``logistic.fit_batched``:
    per-symbol weighted bucket rows (xs [S, 2B, 4], ys [S, 2B], w [S, 2B]).
    This is what BASELINE config 4's per-symbol LR refresh trains on —
    HARVESTED simulation output, not synthetic draws."""
    counts = jnp.asarray(h.ml_counts)          # [S, B, 2]
    s = counts.shape[0]
    feats = _ml_bucket_features(stop_padding)  # [B, 4]
    xs = jnp.broadcast_to(
        jnp.concatenate([feats, feats], axis=0)[None], (s, 2 * ML_BUCKETS, 4))
    ys = jnp.broadcast_to(
        jnp.concatenate([jnp.zeros(ML_BUCKETS), jnp.ones(ML_BUCKETS)])[None],
        (s, 2 * ML_BUCKETS))
    w = jnp.concatenate([counts[:, :, 0], counts[:, :, 1]], axis=1)
    return xs, ys, w


def policy_from_harvest(
    policy: PolicyParams, h: EngineHarvest, *, min_samples: int = 1,
    c: float = 1.0, max_iter: int = 100,
) -> PolicyParams:
    """Refresh the entry go_long / go_short heads from harvested labels.

    The scaled analog of the 2-minute incremental pass (:3753-3803): each
    head fits a weighted logistic on its own bucket-mean rows (the action
    recorded at entry is the chosen side, so glf splits the event stream by
    head exactly as ``update_entry`` would).  Heads with fewer than
    ``min_samples`` events keep their current weights; skip/exit heads are
    never trade-labeled (reference behavior) and are left untouched."""
    feats, labels, cnt, glf = _pol_bucket_features(h)

    def head(sel_glf):
        w, tot = _capped(jnp.where(glf == sel_glf, cnt, 0.0))
        m = logistic.fit(feats, labels, sample_weight=w, c=c,
                         max_iter=max_iter)
        vec = jnp.concatenate(
            [m.intercept.reshape(1), m.coef]).astype(jnp.float32)  # [7]
        ok = jnp.logical_and(tot >= min_samples,
                             jnp.all(jnp.isfinite(vec)))
        return vec, ok

    w_long, ok_long = head(1.0)
    w_short, ok_short = head(0.0)
    w_entry = policy.w_entry
    w_entry = w_entry.at[A_GO_LONG].set(
        jnp.where(ok_long, w_long, w_entry[A_GO_LONG]))
    w_entry = w_entry.at[A_GO_SHORT].set(
        jnp.where(ok_short, w_short, w_entry[A_GO_SHORT]))
    return policy.replace(w_entry=w_entry)
