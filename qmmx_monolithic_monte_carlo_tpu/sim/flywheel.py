"""The closed learning loop at path scale: simulate → label → retrain → re-simulate.

In the reference, trading produces the training data: every closed trade
labels its policy_event by pnl sign (qmmx_monolithic.py:1934-1945), the
labeled stream retrains the OnlinePolicy every 2 minutes (:3753-3803), and
the contact⋈trade join feeds the batch sklearn LR (:3833-3894).  At host
scale that loop is io/trainstore.py.  This module closes it at PATH scale:
each iteration runs the FULL-engine MC with the label harvest on, refreshes
the ML gate (weighted IRLS on the harvested bucket counts, the :3833-3853
analog) and the OnlinePolicy entry heads (models/harvest.policy_from_harvest,
the :3753-3803 analog), then re-simulates with the refreshed models ARMED —
so a billion simulated trades actually train the gates that veto the next
billion.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineParams
from ..engine.state import MlModel
from ..models import harvest as HV
from ..models import online_policy as OP
from ..types import Levels
from . import enginepath as EP


class FlywheelRound(NamedTuple):
    """One simulate→refresh iteration's observables."""

    stats: object             # PathStats of the simulation that ran
    skips: np.ndarray         # f32[len(SKIP_REASONS)]
    escalations: float
    harvest: HV.EngineHarvest
    labeled: float            # closed trades harvested this round
    ml_model: MlModel         # model REFRESHED from this round's harvest
    policy: OP.PolicyParams   # policy refreshed from this round's harvest
    explored: float = 0.0     # labels merged from the exploration harvest


def policy_iteration(
    seed,
    levels: Levels,
    params: EngineParams,
    *,
    rounds: int = 2,
    num_paths: int = 1 << 13,
    num_bars: int = 40,
    s0: float = 100.0,
    sigma: float = 0.3,
    dt: float = 1.0 / (390.0 * 252.0),
    min_samples: int = 50,        # the reference retrain gate (:3838-3840)
    arm_policy_gate: bool = False,
    block_paths: int = 1 << 13,
    sampler: str = "gbm",
    hist_bars=None,
    block_len: int = 10,
    heston=None,
    explore_paths: int = 0,
    explore_reweight: bool = True,
) -> list[FlywheelRound]:
    """Run ``rounds`` simulate→harvest→refresh iterations.

    Round 0 simulates with no ML model and the policy gate disarmed (the
    reference's cold start); each later round arms the previous round's
    refreshed ML gate (and, with ``arm_policy_gate``, the OnlinePolicy
    heads).  The policy gate stays DISARMED by default — its pass rule
    (chosen-action score >= 0.60, :3085) only clears when a bucket's win
    probability exceeds 60%, so a correctly calibrated head vetoes every
    entry whenever the strategy's win rate sits below that; the reference
    ships DISABLE_POLICY_GATE for exactly this posture, and the ML gate is
    the per-bucket pruner that actually shifts the mix.  Returns the
    per-round observables — the skip table / hit-rate shift across rounds is
    the closed-loop evidence (tests/test_harvest.py).

    ``explore_paths > 0`` fixes the survivorship regression: pure on-policy
    retraining harvests ONLY trades that survived the previous gate, so
    after one hard-pruning round no losing bucket remains observable and the
    refreshed gate prunes nothing (the reference's trade-labeled
    retraining, qmmx_monolithic.py:3833-3894, shares the dynamic).  Every
    armed round (r >= 1) then ALSO harvests a gates-off exploration
    population of ``explore_paths`` paths on a disjoint seed fold and merges
    it into the round's harvest before the model refresh —
    ε-greedy at path scale: each bucket's base rate stays observable while
    the main population still measures the armed surface.

    ``explore_reweight`` (default on) additionally importance-reweights the
    merged harvest to the exploration population's bucket frequencies
    (models/harvest.reweight_to_base): a plain merge is per-bucket unbiased
    but over-weights gate-passed buckets in the POOLED IRLS fit (survivor
    counts stack on top of exploration counts), which under-prunes.  The
    reweighted refresh sees base-distribution bucket weights with
    merged-precision label proportions.
    """
    # disjoint seed fold for exploration populations (any odd constant far
    # from the per-round stride; must not collide with round indices)
    xfold = 104729

    def _simulate(r, n, ml_m, pol, fold=0):
        return EP.mc_paths_engine(
            jax.random.fold_in(jax.random.key(int(seed)), r + fold),
            levels, params,
            num_paths=n, num_bars=num_bars, s0=s0, sigma=sigma,
            dt=dt, block_paths=min(block_paths, n),
            policy=pol, ml_model=ml_m,
            policy_gate_disabled=pol is None,
            harvest=True, sampler=sampler, hist_bars=hist_bars,
            block_len=block_len, heston=heston,
        )

    ml: MlModel | None = None
    policy: OP.PolicyParams | None = None
    out: list[FlywheelRound] = []
    for r in range(rounds):
        armed_policy = policy if arm_policy_gate else None
        stats, skips, escal, hv = _simulate(r, num_paths, ml, armed_policy)
        explored = 0.0
        if explore_paths and r >= 1:
            # round 0 is already gates-off: only armed rounds need the mix
            _, _, _, hv_x = _simulate(r, explore_paths, None, None,
                                      fold=xfold)
            explored = float(np.asarray(hv_x.n_labeled))
            hv = hv.merge(hv_x)
            if explore_reweight:
                hv = HV.reweight_to_base(hv, hv_x)
        ml = HV.ml_model_from_harvest(
            hv, stop_padding=float(np.asarray(params.stop_padding)),
            min_samples=min_samples)
        policy = HV.policy_from_harvest(
            OP.PolicyParams.init() if policy is None else policy, hv,
            min_samples=max(1, min_samples // 2))
        out.append(FlywheelRound(
            stats=stats, skips=np.asarray(skips),
            escalations=float(np.asarray(escal)),
            harvest=hv, labeled=float(np.asarray(hv.n_labeled)),
            ml_model=ml, policy=policy, explored=explored,
        ))
    return out


def holdout_eval(
    train_seed,
    eval_seed,
    levels: Levels,
    params: EngineParams,
    *,
    rounds: int = 2,
    num_paths: int = 1 << 13,
    eval_paths: int | None = None,
    num_bars: int = 40,
    s0: float = 100.0,
    sigma: float = 0.3,
    dt: float = 1.0 / (390.0 * 252.0),
    min_samples: int = 50,
    arm_policy_gate: bool = False,
    block_paths: int = 1 << 13,
    sampler: str = "gbm",
    hist_bars=None,
    block_len: int = 10,
    heston=None,
    exact_tail: bool = False,     # exact held-out VaR/CVaR
    explore_paths: int = 0,       # see policy_iteration (survivorship fix)
    explore_reweight: bool = True,
) -> tuple[list[FlywheelRound], list[dict]]:
    """Does the flywheel LEARN, or just train?

    Trains the gates on the ``train_seed`` population via
    ``policy_iteration``, then evaluates each round's refreshed models on a
    DISJOINT ``eval_seed`` population the models never saw — armed vs
    disarmed, same paths (CRN: every arm replays the identical eval
    population, so differences are pure gate effects).  The reference's loop
    exists to improve live expectancy (:3753-3803, :3833-3894); this is the
    held-out measurement of whether the refreshed gates do.

    Returns (train_rounds, eval_rows): one eval row per arm —
    ``disarmed`` (no ML model, policy gate off: round 0's posture), then
    ``round{i}`` for each trained round's ML gate (plus OnlinePolicy heads
    when ``arm_policy_gate``).  Rows carry per-trade expectancy
    (sum_r/trades), per-entered-path mean R, hit rate, trade mix, VaR/CVaR
    (exact via sim/tailexact when ``exact_tail``, else histogram), and the
    ML/policy skip counts that show how much the gate pruned."""
    train_rounds = policy_iteration(
        train_seed, levels, params, rounds=rounds, num_paths=num_paths,
        num_bars=num_bars, s0=s0, sigma=sigma, dt=dt,
        min_samples=min_samples,
        arm_policy_gate=arm_policy_gate, block_paths=block_paths,
        sampler=sampler, hist_bars=hist_bars, block_len=block_len,
        heston=heston, explore_paths=explore_paths,
        explore_reweight=explore_reweight)

    eval_paths = int(eval_paths or num_paths)
    arms = [("disarmed", None, None)]
    for i, rd in enumerate(train_rounds):
        arms.append((f"round{i}", rd.ml_model,
                     rd.policy if arm_policy_gate else None))

    names = [r.name for r in EP.SKIP_REASONS]
    rows: list[dict] = []
    for label, ml, pol in arms:
        stats, skips, escal = EP.mc_paths_engine(
            jax.random.key(int(eval_seed)), levels, params,
            num_paths=eval_paths, num_bars=num_bars, s0=s0, sigma=sigma,
            dt=dt, block_paths=min(block_paths, eval_paths), policy=pol,
            ml_model=ml, policy_gate_disabled=pol is None,
            sampler=sampler, hist_bars=hist_bars, block_len=block_len,
            heston=heston)
        skips = np.asarray(skips)
        trades = float(np.asarray(stats.sum_trades))
        row = {
            "arm": label,
            "ml_armed": ml is not None and bool(ml.present),
            "policy_armed": pol is not None,
            "paths": eval_paths,
            "trades": trades,
            "expectancy_r": (float(np.asarray(stats.sum_r)) / trades
                             if trades else 0.0),
            "mean_r": float(stats.mean_r),
            "hit_rate": float(stats.hit_rate),
            "mean_dd": float(stats.mean_dd),
            "escalations": float(np.asarray(escal)),
            "var_05": float(stats.quantile(0.05)),
            "cvar_05": float(stats.cvar(0.05)),
            "skips_ml": float(skips[names.index("ML_CONF_LOW")]),
            "skips_policy": float(skips[names.index("ONLINE_POLICY")]),
        }
        if exact_tail:
            from . import tailexact

            tail = tailexact.exact_tail_engine(
                jax.random.key(int(eval_seed)), levels, params,
                num_paths=eval_paths, num_bars=num_bars, s0=s0, sigma=sigma,
                dt=dt, block_paths=min(block_paths, eval_paths), policy=pol,
                ml_model=ml, policy_gate_disabled=pol is None,
                sampler=sampler, hist_bars=hist_bars, block_len=block_len,
                heston=heston)
            row["var_05"], row["cvar_05"] = tail.var, tail.cvar
            row["tail_exact"] = tail.certified
        rows.append(row)
    return train_rounds, rows
