"""qmmx_monolithic_monte_carlo_tpu — a Monte Carlo backtesting framework for NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the QMMX Monolithic
Monte Carlo reference application (see SURVEY.md for the structural analysis and
file:line citations used throughout this package's docstrings).

Layering (bottom-up):
  types/config/reasons — pytrees, params, compat flags, reason-code contract
  ops/        — pure batched kernels: featurizer, confidence, touch, guard,
                first-hit scans, path samplers, the fused first-contact
                kernel (Pallas, Triton route)
  engine/     — the 12-gate entry stack, trade lifecycle scan machine, exits/planner
  sim/        — deterministic replay + Monte Carlo + summary reductions
  models/     — OnlinePolicy (two-head SGD logistic) + batched IRLS/SGD LR
  parallel/   — mesh/shard_map scaling of MC reductions and sweeps
  io/         — SQLite audit store, QVoice narrator, analyzer, feed, portfolio
  host/       — live engine loop + CLI
  backend     — which backend runs (``auto`` / ``xla`` / ``triton``), compile cache
"""

from .version import __version__  # noqa: F401
from . import config, reasons, types  # noqa: F401
