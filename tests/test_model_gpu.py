"""Pass-2 evolution kernel (ops/model_gpu.py) vs the lax.scan
formulation, in the Pallas interpreter: the (cum, freq, tot) planes
must be bit-identical (the scan path is pinned to the native
AdaptiveModel by tests/test_fqz_model_device.py)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from fqzcomp5_tpu.ops import fqz_model_jax, model_gpu  # noqa: E402


def _case(seed, C, T, max_sym):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, max_sym, (C, T)).astype(np.int32)
    counts = rng.integers(0, T + 1, C).astype(np.int32)
    return sym, counts, np.full(C, max_sym, np.int32)


@pytest.mark.parametrize("seed,C,T,max_sym,lanes", [
    (1, 13, 128, 46, 128),
    (2, 9, 256, 96, 128),
    (3, 6, 512, 4, 128),
    (4, 5, 96, 200, 256),
])
def test_kernel_evolve_matches_scan(seed, C, T, max_sym, lanes):
    sym, counts, ms = _case(seed, C, T, max_sym)
    want = fqz_model_jax.evolve(jnp.asarray(sym), jnp.asarray(counts),
                                jnp.asarray(ms), jnp.int32(16),
                                lanes=lanes)
    got = model_gpu.evolve_walk(jnp.asarray(sym), jnp.asarray(counts),
                                jnp.asarray(ms), lanes=lanes,
                                interpret=True)
    for g, w, name in zip(got, want, ("cum", "freq", "tot")):
        g = np.asarray(g)
        w = np.asarray(w)
        # compare only the active cells (garbage past counts[c])
        for c in range(C):
            n = counts[c]
            assert np.array_equal(g[c, :n], w[c, :n]), (name, c)


def test_kernel_evolve_normalisation_path():
    """Long walks push totals past MAX_FREQ: the halving + re-total
    must stay bit-exact."""
    C, T = 4, 8192
    rng = np.random.default_rng(9)
    # small alphabet so overflow hits fast: tot grows 16/step from 4
    sym = rng.integers(0, 4, (C, T)).astype(np.int32)
    counts = np.full(C, T, np.int32)
    ms = np.full(C, 4, np.int32)
    want = fqz_model_jax.evolve(jnp.asarray(sym), jnp.asarray(counts),
                                jnp.asarray(ms), jnp.int32(16))
    got = model_gpu.evolve_walk(jnp.asarray(sym), jnp.asarray(counts),
                                jnp.asarray(ms), interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
