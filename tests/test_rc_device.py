"""Batched device range-coder walk vs the native coder (bit-exact).

The RC walk (ops/rc_jax.py) is the serialization stage of the two-pass
device decomposition for the adaptive codecs
(docs/DEVICE_ADAPTIVE_CODECS.md)."""

import numpy as np
import pytest

from fqzcomp5_tpu.codecs import native
from fqzcomp5_tpu.ops import rc_jax

rc_native_encode = native.rc_encode_raw


def _triples(rng, B, T, tot_lo=2, tot_hi=60000):
    tot = rng.integers(tot_lo, tot_hi, (B, T)).astype(np.uint32)
    freq = (rng.random((B, T)) * tot * 0.9).astype(np.uint32) + 1
    freq = np.minimum(freq, tot)
    cum = (rng.random((B, T)) * (tot - freq)).astype(np.uint32)
    return cum, freq, tot


@pytest.mark.parametrize("seed,B,T,lo,hi", [
    (0, 5, 400, 2, 60000),
    (1, 3, 1000, 2, 8),          # tiny totals: huge quotients
    (2, 4, 600, 60000, 65535),   # near the 2^16 bound
    (3, 7, 37, 2, 65535),
])
def test_rc_walk_bit_exact(seed, B, T, lo, hi):
    rng = np.random.default_rng(seed)
    cum, freq, tot = _triples(rng, B, T, lo, hi)
    state, (fl, ca, ff, cy) = rc_jax.encode_scan(cum, freq, tot)
    tails = rc_jax.finish_events(state)
    fl, ca, ff, cy = map(np.asarray, (fl, ca, ff, cy))
    for b in range(B):
        got = rc_jax.assemble_stream(fl[b], ca[b], ff[b], cy[b],
                                     tails[b])
        want = rc_native_encode(cum[b], freq[b], tot[b])
        assert got == want, f"stream {b}"


def test_rc_walk_skewed_carry_runs():
    """Maximal-cum symbols push low toward the carry/FF-run paths."""
    rng = np.random.default_rng(9)
    B, T = 3, 800
    tot = np.full((B, T), 1 << 15, np.uint32)
    freq = np.ones((B, T), np.uint32)
    cum = np.full((B, T), (1 << 15) - 1, np.uint32)
    # sprinkle normal symbols so the state keeps moving
    m = rng.random((B, T)) < 0.3
    freq[m] = 1 << 14
    cum[m] = 0
    state, evs = rc_jax.encode_scan(cum, freq, tot)
    tails = rc_jax.finish_events(state)
    evs = [np.asarray(e) for e in evs]
    for b in range(B):
        got = rc_jax.assemble_stream(evs[0][b], evs[1][b], evs[2][b],
                                     evs[3][b], tails[b])
        want = rc_native_encode(cum[b], freq[b], tot[b])
        assert got == want


def test_rc_walk_ragged_active():
    """Ragged batches: inactive steps must not disturb the stream."""
    rng = np.random.default_rng(4)
    B, T = 4, 300
    cum, freq, tot = _triples(rng, B, T)
    treal = np.array([300, 17, 1, 299])
    active = np.arange(T)[None, :] < treal[:, None]
    state, evs = rc_jax.encode_scan(cum, freq, tot, active=active)
    tails = rc_jax.finish_events(state)
    evs = [np.asarray(e) for e in evs]
    for b in range(B):
        n = treal[b]
        got = rc_jax.assemble_stream(evs[0][b], evs[1][b], evs[2][b],
                                     evs[3][b], tails[b])
        want = rc_native_encode(cum[b][:n], freq[b][:n], tot[b][:n])
        assert got == want, f"stream {b} n={n}"


# ---- pass-3 kernel (ops/rc_gpu.py), Pallas interpreter -------------

def _kernel_walk(cum, freq, tot, active=None, chunks=None,
                 compact=False):
    """Walk with the kernel in T-chunks (state carried); bytes come
    from the device compaction or from the host assembly of the event
    planes."""
    import jax.numpy as jnp

    from fqzcomp5_tpu.ops import rc_gpu

    B, T = cum.shape
    state = rc_gpu.init_state(B)
    parts = [[] for _ in range(B)]
    step = chunks or T
    for t0 in range(0, T, step):
        t1 = min(t0 + step, T)
        act = None if active is None else jnp.asarray(active[:, t0:t1])
        P0, P1 = rc_gpu.pack_planes(jnp.asarray(cum[:, t0:t1]),
                                    jnp.asarray(freq[:, t0:t1]),
                                    jnp.asarray(tot[:, t0:t1]), act)
        ev, state = rc_gpu.walk_events(P0, P1, state, interpret=True)
        if compact:
            totals = np.asarray(rc_gpu.event_totals(*ev))
            by = np.asarray(rc_gpu.compact_events(
                *ev, outcap=max(int(totals.max()), 1)))
            for b in range(B):
                parts[b].append(by[b, :totals[b]].tobytes())
            continue
        ff0, ev0, ff1, ev1 = (np.asarray(e) for e in ev)
        fl = np.stack([(ev0 >> 16) & 1, (ev1 >> 16) & 1], -1) != 0
        ca = np.stack([ev0 & 0xFF, ev1 & 0xFF], -1)
        cy = np.stack([(ev0 >> 8) & 0xFF, (ev1 >> 8) & 0xFF], -1)
        ff = np.stack([ff0, ff1], -1)
        for b in range(B):
            parts[b].append(rc_jax.assemble_stream(
                fl[b], ca[b], ff[b], cy[b], b""))
    tails = rc_jax.finish_events(tuple(np.asarray(state).T))
    return [b"".join(parts[b]) + tails[b] for b in range(B)]


def _skewed(rng, B, T):
    """Maximal-cum symbols push low toward the carry/FF-run paths."""
    tot = np.full((B, T), 1 << 15, np.uint32)
    freq = np.ones((B, T), np.uint32)
    cum = np.full((B, T), (1 << 15) - 1, np.uint32)
    m = rng.random((B, T)) < 0.3
    freq[m] = 1 << 14
    cum[m] = 0
    return cum, freq, tot


@pytest.mark.parametrize("seed,B,T,lo,hi", [
    (0, 5, 400, 2, 60000),
    (1, 3, 700, 2, 8),
    (2, 4, 500, 60000, 65535),
    (3, 40, 37, 2, 65535),       # >32 streams: two programs
])
def test_rc_kernel_bit_exact(seed, B, T, lo, hi):
    rng = np.random.default_rng(seed)
    cum, freq, tot = _triples(rng, B, T, lo, hi)
    outs = _kernel_walk(cum, freq, tot)
    for b in range(B):
        want = rc_native_encode(cum[b], freq[b], tot[b])
        assert outs[b] == want, f"stream {b}"


def test_rc_kernel_skewed_carry_runs():
    cum, freq, tot = _skewed(np.random.default_rng(9), 3, 800)
    outs = _kernel_walk(cum, freq, tot)
    for b in range(3):
        assert outs[b] == rc_native_encode(cum[b], freq[b], tot[b])


def test_rc_kernel_ragged_chunked():
    """Ragged active masks + chunked state carry across device calls."""
    rng = np.random.default_rng(4)
    B, T = 4, 300
    cum, freq, tot = _triples(rng, B, T)
    treal = np.array([300, 17, 1, 299])
    active = np.arange(T)[None, :] < treal[:, None]
    outs = _kernel_walk(cum, freq, tot, active=active, chunks=128)
    for b in range(B):
        n = treal[b]
        want = rc_native_encode(cum[b][:n], freq[b][:n], tot[b][:n])
        assert outs[b] == want, f"stream {b} n={n}"


@pytest.mark.parametrize("seed,B,T,lo,hi", [
    (0, 5, 400, 2, 60000),
    (2, 4, 500, 60000, 65535),
    (3, 40, 37, 2, 65535),
])
def test_rc_kernel_compact_bit_exact(seed, B, T, lo, hi):
    """Device-side byte assembly equals the native coder."""
    rng = np.random.default_rng(seed)
    cum, freq, tot = _triples(rng, B, T, lo, hi)
    outs = _kernel_walk(cum, freq, tot, compact=True)
    for b in range(B):
        want = rc_native_encode(cum[b], freq[b], tot[b])
        assert outs[b] == want, f"stream {b}"


def test_rc_kernel_compact_carry_runs_chunked():
    """0xFF carry runs crossing chunk boundaries through the compact
    path (ff counts carried in STATE; runs land in a later chunk)."""
    cum, freq, tot = _skewed(np.random.default_rng(9), 3, 800)
    outs = _kernel_walk(cum, freq, tot, chunks=128, compact=True)
    for b in range(3):
        assert outs[b] == rc_native_encode(cum[b], freq[b], tot[b])


def test_rc_kernel_compact_ragged():
    rng = np.random.default_rng(4)
    B, T = 4, 300
    cum, freq, tot = _triples(rng, B, T)
    treal = np.array([300, 17, 1, 299])
    active = np.arange(T)[None, :] < treal[:, None]
    outs = _kernel_walk(cum, freq, tot, active=active, chunks=128,
                        compact=True)
    for b in range(B):
        n = treal[b]
        want = rc_native_encode(cum[b][:n], freq[b][:n], tot[b][:n])
        assert outs[b] == want, f"stream {b} n={n}"


def test_rc_kernel_compact_idx_bit_exact(monkeypatch):
    """Pass 3 over index planes into device-resident triples
    (adaptive_batch.rc_walk_batch_idx, kernel path) must reproduce the
    native coder bytes, including chunked state carry, ragged stream
    ends (sentinel indices), and the inactive sentinel's (0,1,2)
    triple."""
    import jax.numpy as jnp

    from fqzcomp5_tpu.ops import adaptive_batch, backend

    monkeypatch.setattr(backend, "INTERPRET", True)
    monkeypatch.setattr(adaptive_batch, "CHUNK_T", 256)
    rng = np.random.default_rng(12)
    B, T = 5, 700
    cum, freq, tot = _triples(rng, B, T)
    treal = np.array([700, 123, 1, 699, 400])

    # device-resident vectors with a host-side shuffle (as DevTriples
    # produces: values live at arbitrary flat positions)
    n = B * T
    perm = rng.permutation(n)
    Vc = np.zeros(n + 1, np.int32)
    Vf = np.ones(n + 1, np.int32)
    Vt = np.full(n + 1, 2, np.int32)
    Vc[perm] = cum.reshape(-1)
    Vf[perm] = freq.reshape(-1)
    Vt[perm] = tot.reshape(-1)
    flat = perm.reshape(B, T)
    V = tuple(jnp.asarray(x) for x in (Vc, Vf, Vt))
    got = adaptive_batch.rc_walk_batch_idx(
        [flat[b, :treal[b]] for b in range(B)], V)
    for b in range(B):
        nr = treal[b]
        want = rc_native_encode(cum[b][:nr], freq[b][:nr], tot[b][:nr])
        assert got[b] == want, f"stream {b} n={nr}"


def test_rc_walk_events_reference_matches_kernel():
    """rc_jax.walk_events (the CPU path of pass 3) and the kernel give
    identical event planes and state."""
    import jax.numpy as jnp

    from fqzcomp5_tpu.ops import rc_gpu

    rng = np.random.default_rng(21)
    cum, freq, tot = _triples(rng, 6, 90)
    active = np.arange(90)[None, :] < rng.integers(0, 91, 6)[:, None]
    P0, P1 = rc_gpu.pack_planes(jnp.asarray(cum), jnp.asarray(freq),
                                jnp.asarray(tot), jnp.asarray(active))
    s0 = rc_gpu.init_state(6)
    ev_r, st_r = rc_jax.walk_events(P0, P1, s0)
    ev_k, st_k = rc_gpu.walk_events(P0, P1, s0, interpret=True)
    for a, b in zip(list(ev_r) + [st_r], list(ev_k) + [st_k]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
