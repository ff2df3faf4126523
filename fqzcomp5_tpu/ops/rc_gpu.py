"""Pallas (Triton route) kernel for the pass-3 range-coder encode walk.

Pass 3 of the adaptive-codec decomposition serialises every
fqz-qual/SEQ stream through the carry-counting range coder
(native/rc.h, htscodecs c_range_coder.h:26-166).  One lane walks one
stream; a program holds BS streams (one warp) with the five uint32
coder registers (low, range, cache, ff_num, carry) in registers for the
whole chunk.  `range / tot` is a native unsigned division.  Inputs are
T-leading (T, B) planes, so each step's loads for a program's streams
are one contiguous line, and a loop iteration issues CH steps' loads
before it uses the first.  Per symbol

  P0[t] = cum << 16 | freq          (both < 2^16: tot < 2^16)
  P1[t] = active << 16 | tot

Each step runs at most two conditional shift_lows; slot k records

  ffk[t] = ff run length
  evk[t] = flush << 16 | (carry & 0xFF) << 8 | (cache & 0xFF)

Only carry's low byte reaches output bytes ((cache+carry) & 0xFF and
(carry-1) & 0xFF runs, rc.h:92-106); the carried state keeps full
width.  The event planes are expanded into bytes on the device
(`compact_events`), so only payload bytes come back to the host.

Bit-exact vs rc_jax.encode_scan and the native coder
(tests/test_rc_device.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

BS = 32           # streams per program
CH = 8            # steps whose loads issue together
K_TOP = np.uint32(1 << 24)
K_THRESH = np.uint32(0xFF000000)
_INIT = (0, 0xFFFFFFFF, 0, 0, 0)   # low, range, cache, ff_num, carry


def _rc_kernel(T: int, p0_ref, p1_ref, s0_ref, ff0_ref, ev0_ref,
               ff1_ref, ev1_ref, sf_ref):
    cols = pl.ds(pl.program_id(0) * BS, BS)

    def step(t, st, p0, p1):
        low0, rng0, ca0, ffn0, cy0 = st
        cum = p0 >> 16
        f = p0 & 0xFFFF
        tot = p1 & 0xFFFF
        act = (p1 >> 16) != 0
        rng2 = rng0 // tot
        low = low0 + cum * rng2
        rng = rng2 * f
        cy = cy0 + (low < low0).astype(jnp.uint32)
        ca, ffn = ca0, ffn0
        evs = []
        for _slot in range(2):
            need = rng < K_TOP
            flush = (low < K_THRESH) | (cy != 0)
            evs.append((flush & need & act, ffn, ca, cy))
            ca = jnp.where(need & flush, low >> 24, ca)
            ffn = jnp.where(need, jnp.where(flush, 0, ffn + 1), ffn)
            cy = jnp.where(need & flush, 0, cy)
            low = jnp.where(need, low << 8, low)
            rng = jnp.where(need, rng << 8, rng)
        for (fl, fk, ck, yk), ff_ref, ev_ref in zip(
                evs, (ff0_ref, ff1_ref), (ev0_ref, ev1_ref)):
            ff_ref[t, cols] = fk
            ev_ref[t, cols] = ((fl.astype(jnp.uint32) << 16)
                               | ((yk & 0xFF) << 8) | (ck & 0xFF))
        return tuple(jnp.where(act, n, o) for n, o in
                     zip((low, rng, ca, ffn, cy), st))

    def chunk(i, st):
        t0 = i * CH
        p0 = [p0_ref[t0 + k, cols] for k in range(CH)]
        p1 = [p1_ref[t0 + k, cols] for k in range(CH)]
        for k in range(CH):
            st = step(t0 + k, st, p0[k], p1[k])
        return st

    st = jax.lax.fori_loop(0, T // CH, chunk,
                           tuple(s0_ref[k, cols] for k in range(5)))
    for k in range(5):
        sf_ref[k, cols] = st[k]


@functools.partial(jax.jit, static_argnames=("interpret",))
def walk_events(P0, P1, state, *, interpret: bool = False):
    """Walk B coders over (B, T) packed planes (layout above) from
    state (B, 5) uint32 (low, range, cache, ff_num, carry).  Returns
    ((ff0, ev0, ff1, ev1) (B, T) uint32 event planes, final state
    (B, 5)), the interface of rc_jax.walk_events."""
    B, T = P0.shape
    Bp = -(-B // BS) * BS
    Tp = -(-T // CH) * CH

    def plane(x, fill):   # pad steps and pad streams run inactive
        return jnp.pad(x.astype(jnp.uint32), ((0, Bp - B), (0, Tp - T)),
                       constant_values=fill).T

    s0 = jnp.stack([jnp.pad(state[:, k].astype(jnp.uint32), (0, Bp - B),
                            constant_values=np.uint32(_INIT[k]))
                    for k in range(5)])
    evp = jax.ShapeDtypeStruct((Tp, Bp), jnp.uint32)
    *ev, sf = pl.pallas_call(
        functools.partial(_rc_kernel, Tp),
        grid=(Bp // BS,),
        out_shape=[evp] * 4 + [jax.ShapeDtypeStruct((5, Bp), jnp.uint32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1,
                                                 num_stages=1),
        interpret=interpret,
        name="rc_encode_walk",
    )(plane(P0, 1), plane(P1, 2), s0)
    return tuple(e.T[:B, :T] for e in ev), sf.T[:B]


def pack_planes(cum, freq, tot, active=None):
    """(B, T) triples (+ optional active mask) -> the kernel's P0/P1."""
    P0 = (cum.astype(jnp.uint32) << 16) | freq.astype(jnp.uint32)
    act = (jnp.ones(cum.shape, jnp.uint32) if active is None
           else active.astype(jnp.uint32))
    P1 = (act << 16) | tot.astype(jnp.uint32)
    return P0, P1


@jax.jit
def event_totals(ff0, ev0, ff1, ev1):
    """Per-stream output byte count of (B, T) event planes: the sum over
    flush events of (1 + ff)."""
    def count(ev, ff):
        return (((ev >> 16) & 1) * (1 + ff)).astype(jnp.int32).sum(1)

    return count(ev0, ff0) + count(ev1, ff1)


@functools.partial(jax.jit, static_argnames=("outcap",))
def compact_events(ff0, ev0, ff1, ev1, *, outcap: int):
    """Expand (B, T) event planes into dense per-stream output bytes on
    the device (shift_low semantics, rc_jax.assemble_stream: a flush
    emits (cache+carry) & 0xFF then ff bytes of (carry-1) & 0xFF).
    Returns bytes (B, outcap) uint8; row b's payload is its first
    event_totals[b] bytes."""
    B, T = ev0.shape
    ev = jnp.stack([ev0, ev1], axis=-1).reshape(B, 2 * T).astype(jnp.int32)
    ff = jnp.stack([ff0, ff1], axis=-1).reshape(B, 2 * T).astype(jnp.int32)
    fl = (ev >> 16) & 1
    ca = ev & 0xFF
    cy = (ev >> 8) & 0xFF
    k = fl * (1 + ff)                       # bytes per event
    cumk = jnp.cumsum(k, axis=1)            # inclusive
    total = cumk[:, -1]
    j = jnp.arange(outcap, dtype=jnp.int32)
    # covering event per output position
    e_idx = jax.vmap(
        lambda row: jnp.searchsorted(row, j, side="right"))(cumk)
    e_idx = jnp.minimum(e_idx, 2 * T - 1)
    g = lambda a: jnp.take_along_axis(a, e_idx, axis=1)  # noqa: E731
    first = j[None, :] == g(cumk) - g(k)
    byte = jnp.where(first, g(ca + cy), g(cy - 1)) & 0xFF
    byte = jnp.where(j[None, :] < total[:, None], byte, 0)
    return byte.astype(jnp.uint8)


def init_state(B: int) -> np.ndarray:
    """(B, 5) uint32 fresh coder registers."""
    return np.tile(np.array(_INIT, np.uint32), (B, 1))
