"""Device-mesh scaling of the Monte Carlo reductions.

The reference has no distributed execution (its MC is one serial Python loop,
qmmx_monolithic.py:3491); the rebuild scales through ``jax.sharding.Mesh`` +
``shard_map``:

* ``paths`` axis — each device generates ITS OWN path blocks from per-device
  folded keys and accumulates a local ``PathStats``; one ``psum`` across the
  devices merges them (the accumulator is associative by construction).  The
  cards of one host are joined all to all, so the mesh is a flat 1-D axis.
* ``symbols`` axis — independent (levels, params) universes vmap within a device
  and shard across the second mesh axis (BASELINE config #4).

The result of ``sharded_mc_paths(mesh, ...)`` is bitwise independent of the mesh
shape given the same key and total path count IF block boundaries align — each
block's RNG is keyed by its global block index, not by device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineParams
from ..sim import pathsim
from ..types import Levels


def make_mesh(n_devices: int | None = None, axis: str = "paths",
              devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.array(devices[:n_devices]), (axis,))


def sharded_mc_paths(
    mesh: Mesh,
    key,
    levels: Levels,
    params: EngineParams,
    *,
    num_paths: int,
    num_bars: int = 40,
    s0=100.0,
    mu: float = 0.0,
    sigma: float = 0.15,
    dt: float = 1.0 / (390.0 * 252.0),
    sampler: str = "gbm",
    hist_bars=None,
    block_paths: int = 1 << 16,
    antithetic: bool = False,
    axis: str = "paths",
    gate=None,
    engine: bool = False,
) -> pathsim.PathStats:
    """Generated-path MC sharded over the mesh's path axis; psum-merged stats.

    Pass ``gate`` (a sim.gatedpath.GateConfig) to run the engine-gated
    multi-trade lifecycle per path instead of first-contact replay — the
    accumulator stays associative either way, so the same psum/pmin/pmax
    merge applies."""
    n_dev = mesh.shape[axis]
    if num_paths % (n_dev * block_paths) != 0:
        raise ValueError(
            f"num_paths ({num_paths}) must divide evenly into "
            f"{n_dev} devices × block_paths ({block_paths})"
        )
    blocks_per_dev = num_paths // (n_dev * block_paths)

    from jax import shard_map

    if engine:
        # FULL 12-gate engine lifecycle (sim/enginepath.py); stats shard and
        # psum like the others (skip counts/escalations are per-device
        # diagnostics — use mc_paths_engine directly when you need them)
        from ..sim.enginepath import _one_block_engine

        def one_block(key, b, **kw):
            st = _one_block_engine(key, b, **kw)[0]
            return st

        zero = pathsim.PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    elif gate is not None:
        from ..sim.gatedpath import _one_block_gated
        one_block = partial(_one_block_gated, gate=gate)
        zero = pathsim.PathStats.zero(pathsim.LIFE_HIST_LO, pathsim.LIFE_HIST_HI)
    else:
        one_block = pathsim._one_block
        zero = pathsim.PathStats.zero()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(),
        check_vma=False,
    )
    def run(dev_block0):
        b0 = dev_block0[0]  # this device's first global block index

        def body(carry, i):
            stats = one_block(
                key, (b0 + i).astype(jnp.uint32),
                levels=levels, params=params, block_paths=block_paths,
                num_bars=num_bars, s0=s0, mu=mu, sigma=sigma, dt=dt,
                sampler=sampler, hist_bars=hist_bars, antithetic=antithetic,
            )
            return carry.merge(stats), None

        local, _ = jax.lax.scan(
            body, zero, jnp.arange(blocks_per_dev, dtype=jnp.uint32)
        )
        # additive leaves psum; extremes pmin/pmax
        merged = jax.tree_util.tree_map(lambda x: jax.lax.psum(x, axis), local)
        return merged.replace(
            min_r=jax.lax.pmin(local.min_r, axis),
            max_r=jax.lax.pmax(local.max_r, axis),
            max_dd=jax.lax.pmax(local.max_dd, axis),
        )

    # each device receives its starting global block index
    starts = jnp.arange(n_dev, dtype=jnp.uint32) * np.uint32(blocks_per_dev)
    starts = jax.device_put(starts, NamedSharding(mesh, P(axis)))
    return run(starts)


def replicate(mesh: Mesh, tree):
    """Place a pytree fully-replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
