"""Configuration: engine parameters, compat flags and the settings-key inventory.

The reference keeps all knobs in a SQLite ``settings`` KV table (qmmx_monolithic.py:71-74)
read via ``settings_get(key, default)``; some are cached on engine init (:1371-1386) and
some re-read per use (:1670-1674, :1711-1715).  The rebuild splits them into:

* ``EngineParams`` — a device-resident pytree of scalars consumed by the pure gate
  stack / sims (donated into jit, so live settings edits just rebuild the pytree);
* ``CompatFlags`` — *static* Python booleans selecting reference-quirk behavior
  (Q1–Q7 in SURVEY.md §3); they change trace structure, so they are hashable
  static args, not traced values;
* ``SETTINGS_DEFAULTS`` — the full key inventory with the reference's defaults,
  used by the host SQLite layer (io/db.py).
"""

from __future__ import annotations

import dataclasses

import jax

import jax.numpy as jnp
from .utils import struct

from .utils import tracectx

# Full settings-key inventory of the reference (SURVEY.md §5; sources cited per key).
SETTINGS_DEFAULTS: dict[str, str] = {
    "symbol": "SPY",                      # :2037
    "polygon_api_key": "",                # :2038
    "allow_after_hours": "0",             # :2039
    "chart_candles": "120",               # :2040
    "portfolio_start": "10000",           # :2041
    "CONTACT_PROX": "0.05",               # :1371
    "Q_SIGNAL_COOLDOWN": "8",             # :1372 (seconds)
    "STOP_PADDING": "0.35",               # :1374
    "TP_PADDING": "0.25",                 # :1375
    "Q_MIN_PROB": "0.60",                 # :1434-1447 (accepts 0-1 or percent; legacy 'minp')
    "ENABLE_VETO": "1",                   # :1380
    "VETO_VOL_STRONG": "0.25",            # :1381
    "VETO_PROX": "0.06",                  # :1382
    "DISABLE_ML_GATE": "0",               # :1383
    "DISABLE_POLICY_GATE": "0",           # :3090
    "USE_BLEND": "0",                     # :1711
    "W_RULES": "0.7",                     # :1714
    "W_ML": "0.3",                        # :1715
    "retrain_time": "02:00",              # :3741
    "auto_retrain": "1",                  # :3740
    "last_trained_policy_event_id": "0",  # :3758
    # rebuild-only keys (no reference analog): opt-in exit-head gating — the
    # reference trains score_exit but never consults it live (:366 uncalled)
    "USE_EXIT_HEAD": "0",
    "EXIT_HEAD_MIN": "0.60",
}


def parse_prob_threshold(raw) -> float:
    """Reference ``_read_prob_threshold`` semantics (qmmx_monolithic.py:1429-1447):
    accepts 0-1 or 0-100 (percent), falls back to 0.60 on parse error or out-of-range."""
    try:
        val = float(raw)
    except (TypeError, ValueError):
        val = 0.60
    if val > 1.0:
        val = val / 100.0
    if not (0.0 <= val <= 0.99):
        val = 0.60
    return val


_ENGINE_DEFAULT_CACHE: dict = {}


@struct.dataclass
class EngineParams:
    """Device pytree of the engine's numeric knobs (defaults = reference defaults)."""

    contact_prox: jnp.ndarray          # CONTACT_PROX, 0.05 (:1371)
    cooldown_s: jnp.ndarray            # Q_SIGNAL_COOLDOWN, 8 (:1372)
    reverse_touch_decay: jnp.ndarray   # 0.08 hardcoded (:1373)
    stop_padding: jnp.ndarray          # 0.35 (:1374)
    tp_padding: jnp.ndarray            # 0.25 (:1375)
    q_min_prob: jnp.ndarray            # 0.60 (:1386)
    enable_veto: jnp.ndarray           # bool (:1380)
    veto_vol_strong: jnp.ndarray       # 0.25 (:1381)
    veto_prox: jnp.ndarray             # 0.06 (:1382)
    disable_ml_gate: jnp.ndarray       # bool (:1383)
    use_blend: jnp.ndarray             # bool (:1711)
    w_rules: jnp.ndarray               # 0.7 (:1714)
    w_ml: jnp.ndarray                  # 0.3 (:1715)
    stale_ms: jnp.ndarray              # 15000 hardcoded (:1499)
    confluence_within: jnp.ndarray     # 0.15 hardcoded (:1681/:1886)
    overtouch_limit: jnp.ndarray       # 4 hardcoded (:1579)

    @classmethod
    def default(cls, **overrides) -> "EngineParams":
        # cache by (override items, default backend) when the values are
        # hashable scalars — eager jnp scalar creation dispatches one op per
        # scalar and hot MC wrappers build defaults per launch (see
        # ops/guard.GuardParams.default); sweep builders passing arrays
        # fall through to the uncached path
        if not tracectx.eager():     # never cache under a trace
            key = None
        else:
            try:
                key = (tuple(sorted(overrides.items())),
                       jax.default_backend())
                hash(key)
            except TypeError:
                key = None
        if key is not None:
            cached = _ENGINE_DEFAULT_CACHE.get(key)
            if cached is None:
                cached = cls._build_default(**overrides)
                _ENGINE_DEFAULT_CACHE[key] = cached
            return cached
        return cls._build_default(**overrides)

    @classmethod
    def _build_default(cls, **overrides) -> "EngineParams":
        vals = dict(
            contact_prox=0.05,
            cooldown_s=8.0,
            reverse_touch_decay=0.08,
            stop_padding=0.35,
            tp_padding=0.25,
            q_min_prob=0.60,
            enable_veto=True,
            veto_vol_strong=0.25,
            veto_prox=0.06,
            disable_ml_gate=False,
            use_blend=False,
            w_rules=0.7,
            w_ml=0.3,
            stale_ms=15000,
            confluence_within=0.15,
            overtouch_limit=4,
        )
        vals.update(overrides)
        out = {}
        for k, v in vals.items():
            if isinstance(v, bool):
                out[k] = jnp.asarray(v)
            elif k in ("stale_ms", "overtouch_limit"):
                out[k] = jnp.asarray(int(v), jnp.int32)
            else:
                out[k] = jnp.asarray(float(v), jnp.float32)
        return cls(**out)

    @classmethod
    def from_settings(cls, get) -> "EngineParams":
        """Build from a ``settings_get``-style callable (host layer)."""
        def g(key):
            return get(key, SETTINGS_DEFAULTS[key])

        return cls.default(
            contact_prox=float(g("CONTACT_PROX")),
            cooldown_s=float(g("Q_SIGNAL_COOLDOWN")),
            stop_padding=float(g("STOP_PADDING")),
            tp_padding=float(g("TP_PADDING")),
            q_min_prob=parse_prob_threshold(get("Q_MIN_PROB", get("minp", "0.60"))),
            enable_veto=g("ENABLE_VETO") == "1",
            veto_vol_strong=float(g("VETO_VOL_STRONG")),
            veto_prox=float(g("VETO_PROX")),
            disable_ml_gate=g("DISABLE_ML_GATE") == "1",
            use_blend=g("USE_BLEND") == "1",
            w_rules=float(g("W_RULES") or 0.7),
            w_ml=float(g("W_ML") or 0.3),
        )


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Static switches selecting reference-quirk behavior (SURVEY.md §3 Q1-Q7).

    Defaults are the *fixed* behaviors; set ``strict_reference_quirks()`` for
    audit-parity replays against the reference's recorded WAL.
    """

    # Q1: reference's VETO reason-code NameError → vetoes surface as ENGINE_ERR.
    veto_nameerror: bool = False
    # Q2: evaluate_entry called twice per tick with identical args (:2936-2949),
    # doubling touch-latch and policy-event side effects.
    double_evaluate: bool = False
    # Q5: sklearn gate train/serve feature skew (4 served vs 3 trained) silently
    # disables the ML gate via except → (True, None) (:1454-1466).
    ml_feature_skew: bool = False
    # Q7: sims mutate live engine state. The rebuild is always pure; this flag makes
    # the sim *seed* its gate state from the live state (as the reference effectively
    # does) instead of a fresh state.
    sim_seeds_from_live_state: bool = True
    # Q9 (found during the rebuild): NOTHING in the reference ever inserts into
    # contact_events, so the batch LR retrain's contact⋈trade join is always
    # empty and "Retrain Now" can never reach its ≥50-sample gate (:3838,
    # :3864-3894 read a table no code writes). The rebuild records a contact
    # event on every fresh touch latch; False reproduces the never-trains quirk.
    record_contact_events: bool = True
    # Q8 (found during the rebuild): live escalation never fires in the reference —
    # get_minute_bars returns {t,o,h,l,c} dicts while ExitStrategy indexes
    # (price, volume, ts) tuples; the KeyError is swallowed and should_exit reports
    # basis=None (:2972, :986-987, :781-782). True reproduces the broken behavior.
    escalation_broken: bool = False

    @classmethod
    def strict_reference_quirks(cls) -> "CompatFlags":
        return cls(
            veto_nameerror=True,
            double_evaluate=True,
            ml_feature_skew=True,
            sim_seeds_from_live_state=True,
            record_contact_events=False,
            escalation_broken=True,
        )

    def __hash__(self):
        return hash(dataclasses.astuple(self))
