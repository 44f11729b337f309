"""Candidate-signal discovery over a bar window — the shared detector of both sims.

Re-expression of the detector loops in ``simulate_last_bars`` (qmmx_monolithic.py:
3565-3607) and ``simulate_monte_carlo`` (:3385-3442) as one ``lax.scan`` over bars.
The two sims order their filters differently and that ordering is behavioral:

* replay: proximity → side → **gates** → touch-limit  (:3581-3607)
* monte carlo: proximity → side → **touch-limit** → gates, and the gate result may
  override level price and side (:3407-3426)

Gate re-runs mirror the reference exactly: a fabricated fresh timestamp
``now_ms = t0 + i*60_000`` with ``last_ts`` forced fresh (:3416-3417, :3584-3585),
and — unlike the live loop — NO ``last_direction``/price state updates between
bars, so flat bars reuse the seeded direction for the whole sim.  The gate state
(touch latches etc.) is threaded through the scan purely (fixing quirk Q7: the
live carry is copied in, never mutated).

COMPAT NOTE: the reference keys the sim touch-limit by ``round(level, 4)``; the
rebuild keys by nearest-level slot, which differs only when two levels share the
same 4-decimal rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import CompatFlags, EngineParams
from ..engine.gates import TickInput, evaluate_entry
from ..engine.state import EngineCarry, MlModel
from ..ops import features as F
from ..ops import touch as T
from ..types import SIDE_LONG, SIDE_SHORT, Bars, Levels


@struct.dataclass
class Candidates:
    """Per-bar candidate mask + trade scaffold (fixed shape [N])."""

    is_cand: jnp.ndarray     # bool[N]
    side: jnp.ndarray        # i32[N] SIDE_*
    level_idx: jnp.ndarray   # i32[N]
    level_price: jnp.ndarray  # f32[N] (possibly gate-overridden in MC mode)
    entry: jnp.ndarray       # f32[N] (= bar close)
    stop: jnp.ndarray        # f32[N]
    target: jnp.ndarray      # f32[N]
    touch_no: jnp.ndarray    # i32[N] touch ordinal at this level
    gate_reason: jnp.ndarray  # i32[N] Reason (OK when passed / gates off)
    gate_conf: jnp.ndarray   # f32[N] decision confidence at bars where gates ran
    gate_dist: jnp.ndarray   # f32[N] |close - nearest level| at those bars

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.is_cand.astype(jnp.int32))


def find_candidates(
    bars: Bars,
    levels: Levels,
    params: EngineParams,
    *,
    touch_limit: int = 1,
    with_gates: bool = True,
    mode: str = "mc",              # "mc" | "replay" (filter ordering, see above)
    carry: EngineCarry | None = None,
    ml_model: MlModel | None = None,
    t0_ms=0,
    compat: CompatFlags = CompatFlags(),
) -> Candidates:
    if mode not in ("mc", "replay"):
        raise ValueError(f"mode must be 'mc' or 'replay', got {mode!r}")
    if carry is None:
        carry = EngineCarry.init(levels.max_levels)
    if ml_model is None:
        ml_model = MlModel.absent()
    touch_params = T.TouchMemoryParams.default()

    n = bars.num_bars
    t0_ms = jnp.asarray(t0_ms, jnp.int32)

    def step(state, inp):
        i, c, valid = inp
        prev_c, prev_valid, touch_counts, gcarry = state

        idx, dist = F.nearest_level(levels, c)
        lvl = levels.price[idx]
        near = jnp.logical_and(valid, jnp.logical_and(prev_valid, dist <= params.contact_prox))
        det_side = jnp.where(c > prev_c, SIDE_LONG, SIDE_SHORT).astype(jnp.int32)

        # touch-limit bookkeeping (order depends on mode)
        tc_next = touch_counts[idx] + 1
        under_limit = tc_next <= touch_limit

        # gate re-run with fabricated freshness (:3416-3417)
        now_ms = t0_ms + i * 60_000
        g = gcarry.replace(last_ts_ms=now_ms, last_ts_valid=jnp.asarray(True))
        tick = TickInput(
            price=c,
            price_valid=jnp.asarray(True),
            prev_price=prev_c,
            prev_price_valid=prev_valid,
            now_ms=now_ms,
            api_key_present=jnp.asarray(True),
        )
        decision, g_after = evaluate_entry(g, levels, params, tick, ml_model, touch_params)
        if compat.double_evaluate:
            decision, g_after = evaluate_entry(
                g_after, levels, params, tick, ml_model, touch_params
            )

        if mode == "mc":
            # touch limit first; gates only evaluated for bars that survive it
            reaches_touch = near
            counted = jnp.logical_and(reaches_touch, under_limit)
            reaches_gates = counted
            passed = jnp.logical_and(reaches_gates, decision.ok if with_gates else True)
            # gate may override level/side (:3425-3426)
            use_gate = jnp.logical_and(passed, with_gates)
            out_lvl = jnp.where(use_gate, decision.level_price, lvl)
            out_side = jnp.where(use_gate, decision.side, det_side)
        else:
            # replay: gates first, then touch limit
            reaches_gates = near
            gate_ok = decision.ok if with_gates else jnp.asarray(True)
            after_gates = jnp.logical_and(reaches_gates, gate_ok)
            counted = jnp.logical_and(after_gates, under_limit)
            passed = counted
            out_lvl = lvl
            out_side = det_side

        touch_counts = touch_counts.at[idx].add(counted.astype(jnp.int32))

        # gate state evolves only on bars where the gates actually ran (:3588 runs
        # them for every near bar in replay; :3418 for every counted bar in MC)
        ran_gates = jnp.logical_and(reaches_gates, jnp.asarray(with_gates))
        from ..engine.gates import tree_select

        gcarry = tree_select(ran_gates, g_after, gcarry)

        stop = jnp.where(out_side == SIDE_LONG, out_lvl - params.stop_padding,
                         out_lvl + params.stop_padding)
        target = jnp.where(out_side == SIDE_LONG, out_lvl + params.tp_padding,
                           out_lvl - params.tp_padding)

        out = (
            passed,
            out_side,
            idx.astype(jnp.int32),
            out_lvl,
            c,
            stop,
            target,
            tc_next.astype(jnp.int32),
            jnp.where(ran_gates, decision.reason, 0).astype(jnp.int32),
            jnp.where(ran_gates, decision.conf, 0.0),
            dist,
        )
        new_state = (
            jnp.where(valid, c, prev_c),
            jnp.logical_or(prev_valid, valid),
            touch_counts,
            gcarry,
        )
        return new_state, out

    init = (
        jnp.float32(0.0),
        jnp.asarray(False),
        jnp.zeros((levels.max_levels,), jnp.int32),
        carry,
    )
    _, outs = jax.lax.scan(
        step, init, (jnp.arange(n, dtype=jnp.int32), bars.close, bars.valid)
    )
    return Candidates(
        is_cand=outs[0], side=outs[1], level_idx=outs[2], level_price=outs[3],
        entry=outs[4], stop=outs[5], target=outs[6], touch_no=outs[7],
        gate_reason=outs[8], gate_conf=outs[9], gate_dist=outs[10],
    )
