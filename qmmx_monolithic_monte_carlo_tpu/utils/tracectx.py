"""Trace-context probe for the cached default-param constructors.

The default param pytrees are cached (eager jnp scalar creation dispatches
one device op per scalar).  Those caches must NEVER
be populated or served while a jax trace is active: under jit, `jnp.zeros`
etc. produce `DynamicJaxprTracer`s, and caching a tracer leaks it into
every later trace (UnexpectedTracerError).  Inside a trace, fresh
construction is free anyway — nothing is dispatched to a device — so the
cached fast path is only ever needed (and only ever correct) in eager
context.
"""

from __future__ import annotations


def eager() -> bool:
    """True when no jax trace is active (safe to use the eager caches)."""
    try:
        from jax._src.core import trace_state_clean
        return bool(trace_state_clean())
    except Exception:       # API moved — fail safe: never cache
        return False
