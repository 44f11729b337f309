#!/usr/bin/env python3
"""First-contact Monte Carlo throughput on one GPU: 2^28 GBM paths x 40 bars.

Runs the backend that ``--backend`` resolves to (``auto`` picks the fused
Triton kernel on a GPU, see ``qmmx_monolithic_monte_carlo_tpu/backend.py``),
times three seeds after a warm-up call, and prints ONE JSON line on stdout:

    {"metric", "value", "unit", "backend", "platform", "device_kind",
     "device_count", "num_paths", "seconds_per_run", "hit_rate"}

It refuses to run anywhere but on a GPU: a number from another platform is
not this benchmark's number.

    python bench.py [--backend auto|xla|triton]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

NUM_PATHS = 1 << 28
NUM_BARS = 40
SIGMA = 0.3
DT = 1.0 / (390.0 * 252.0)
XLA_BLOCK_PATHS = 1 << 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="auto", choices=["auto", "xla", "triton"])
    args = ap.parse_args(argv)

    from qmmx_monolithic_monte_carlo_tpu import backend as B
    from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    B.setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; this process sees {dev.platform!r}",
              file=sys.stderr)
        return 2

    levels = Levels.from_rows(
        [
            {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
            {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
        ],
        max_levels=8,
    )
    params = EngineParams.default()
    backend = B.resolve(args.backend, kernel_reason=B.kernel_reason(
        levels, num_paths=NUM_PATHS, num_bars=NUM_BARS))

    def run(seed):
        return B.first_contact_paths(
            backend, seed, levels, params, num_paths=NUM_PATHS,
            num_bars=NUM_BARS, s0=100.0, sigma=SIGMA, dt=DT,
            block_paths=XLA_BLOCK_PATHS)

    float(run(0).sum_r)                     # compile + first run
    seeds = (1, 2, 3)
    t0 = time.perf_counter()
    for k in seeds:
        stats = run(k)
        float(stats.sum_r)                  # waits for the device
    per_run = (time.perf_counter() - t0) / len(seeds)

    print(json.dumps({
        "metric": "first_contact_paths_per_sec_40bar",
        "value": NUM_PATHS / per_run,
        "unit": "paths/s",
        "backend": backend,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "num_paths": NUM_PATHS,
        "seconds_per_run": per_run,
        "hit_rate": float(stats.hit_rate),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
