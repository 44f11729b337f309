"""The one place that decides which backend runs, and where compiled code is kept.

Backends:

* ``xla``    — the plain JAX pipelines (``sim/``, ``parallel/``); any platform.
* ``triton`` — the fused first-contact kernel (``ops/triton_paths.py``), a
  Pallas kernel on the Triton route; GPU only, GBM sampler only.
* ``auto``   — ``triton`` where the kernel covers the run on a GPU, else ``xla``.

Asking for ``triton`` where it cannot run is an error, never a silent switch to
another backend or to Pallas interpret mode.
"""

from __future__ import annotations

import os

import jax

CHOICES = ("auto", "xla", "triton")
_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(_REPO_DIR, ".jax_cache")


class BackendError(ValueError):
    """A backend was asked for where it cannot run."""


def platform() -> str:
    """The default device's platform: ``"gpu"`` on CUDA, ``"cpu"`` otherwise."""
    return jax.devices()[0].platform


def resolve(requested: str = "auto", *, kernel_reason: str | None = None,
            platform_name: str | None = None) -> str:
    """Map ``--backend`` to the backend that runs.

    ``kernel_reason`` is None when the fused kernel covers this run, else a
    sentence saying why it does not (sampler, level count, horizon, ...)."""
    if requested not in CHOICES:
        raise BackendError(f"unknown backend {requested!r}; choose from {CHOICES}")
    if requested == "xla":
        return "xla"
    plat = platform_name or platform()
    if requested == "triton":
        if plat != "gpu":
            raise BackendError(
                f"--backend triton needs a GPU; this process runs on {plat!r}")
        if kernel_reason is not None:
            raise BackendError(f"--backend triton cannot run this: {kernel_reason}")
        return "triton"
    return "triton" if plat == "gpu" and kernel_reason is None else "xla"


def kernel_reason(levels, *, num_paths: int, num_bars: int,
                  sampler: str = "gbm") -> str | None:
    """Why the fused first-contact kernel cannot run this shape, or None."""
    from .ops import triton_paths

    try:
        triton_paths.check_args(levels, num_paths=num_paths, num_bars=num_bars,
                                sampler=sampler)
    except ValueError as e:
        return str(e)
    return None


def first_contact_paths(backend: str, seed: int, levels, params, *,
                        num_paths: int, num_bars: int, s0, sigma,
                        dt: float = 1.0 / (390.0 * 252.0), noise=None,
                        antithetic: bool = False, block_paths: int, **xla_kw):
    """First-contact MC on ``backend`` as ``resolve`` returned it: the fused
    kernel, or ``sim.pathsim.mc_paths`` in blocks of ``block_paths``.
    ``xla_kw`` (sampler, hist_bars, block_len, heston) go to the XLA pipeline
    only; ``resolve`` has already refused them for the kernel."""
    kw = dict(num_paths=num_paths, num_bars=num_bars, s0=s0, sigma=sigma, dt=dt,
              noise=noise, antithetic=antithetic)
    if backend == "triton":
        from .ops.triton_paths import mc_paths_triton

        return mc_paths_triton(seed, levels, params, **kw)
    from .sim import pathsim

    return pathsim.mc_paths(jax.random.key(seed), levels, params,
                            block_paths=min(num_paths, block_paths), **kw,
                            **xla_kw)


def setup_compile_cache() -> str:
    """Keep compiled programs across processes.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself).  Otherwise the cache lives at one fixed path in the checkout,
    ``<repo>/.jax_cache``.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
