"""Optional host<->device transfer vs device-compute accounting.

With FQZ5_DEVTIME=1 the device engine routes its bulk transfers and
batched walks through the helpers here, each synchronised, so a
measurement can report device-compute seconds separately from transfer
seconds and count the fused device calls of a wave.

When disabled (the default) the helpers degrade to plain jnp.asarray /
np.asarray / call-through with no extra synchronisation, so the hot
path keeps XLA's async dispatch pipelining.
"""

from __future__ import annotations

import os
import time

import numpy as np

enabled = os.environ.get("FQZ5_DEVTIME", "0") not in ("", "0")

link_s = 0.0        # seconds spent in host<->device transfers
link_bytes = 0      # bytes moved over the link (both directions)
compute_s = 0.0     # seconds blocked on device computation
compute_calls = 0


def reset() -> None:
    global link_s, link_bytes, compute_s, compute_calls
    link_s = 0.0
    link_bytes = 0
    compute_s = 0.0
    compute_calls = 0


def snapshot() -> dict:
    return {"link_s": link_s, "link_bytes": link_bytes,
            "compute_s": compute_s, "compute_calls": compute_calls}


def put(x):
    """Host array -> device array (timed upload when enabled)."""
    import jax
    import jax.numpy as jnp

    if not enabled:
        return jnp.asarray(x)
    global link_s, link_bytes
    t0 = time.perf_counter()
    d = jax.device_put(np.ascontiguousarray(x))
    jax.block_until_ready(d)
    link_s += time.perf_counter() - t0
    link_bytes += x.nbytes if hasattr(x, "nbytes") else 0
    return d


def get(x) -> np.ndarray:
    """Device array -> host numpy (timed download when enabled)."""
    if not enabled:
        return np.asarray(x)
    global link_s, link_bytes
    import jax

    jax.block_until_ready(x)  # exclude compute still in flight
    t0 = time.perf_counter()
    out = np.asarray(x)
    link_s += time.perf_counter() - t0
    link_bytes += out.nbytes
    return out


def compute(thunk):
    """Run a device computation thunk; when enabled, block until ready
    and attribute the wall time to device compute.  Inputs must already
    be device-resident (use put) for the attribution to be honest."""
    if not enabled:
        return thunk()
    global compute_s, compute_calls
    import jax

    t0 = time.perf_counter()
    out = thunk()
    jax.block_until_ready(out)
    compute_s += time.perf_counter() - t0
    compute_calls += 1
    return out
