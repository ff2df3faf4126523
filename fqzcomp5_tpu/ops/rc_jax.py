"""Batched range-coder ENCODE walks on device.

The adaptive codecs (fqz-qual, seq model, arith) serialize through the
carry-counting range coder (c_range_coder.h:26-166; native/rc.h).  The
two-pass context-sorted encode decomposition
(docs/DEVICE_ADAPTIVE_CODECS.md) needs exactly this kernel: given the
per-symbol (cum, freq, tot) triples — which passes 1-2 compute — walk
the RC state for B independent streams at once.

Device formulation notes:

- the coder state is pure u32 (low, range, cache, ff_num, carry): no
  64-bit types needed;
- `range /= tot` is the only division.  tot < 2^16 for every model in
  the family, so a base-256 schoolbook division is exact in f32:
  each digit's dividend is < 256 * tot < 2^24 (exact in f32) and each
  quotient digit < 256, with a +-1 integer correction per digit;
- renormalisation runs at most twice per symbol (range >= 2^8 after
  the update), and each shift emits either nothing (the 0xFF-run
  counter grows) or a flush event of 1 + ff_num bytes whose values
  depend only on (cache, carry, ff_num).  The scan records two event
  slots per step; the host expands them into bytes afterwards (the
  expansion is data-dependent length, but linear and branch-trivial).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

K_TOP = jnp.uint32(1 << 24)
K_THRESH = jnp.uint32(255 << 24)


def _div_u32_u16(a, b_f32, b):
    """Exact floor(a / b) for uint32 a and uint32 b < 2^16, via two
    base-65536 digits each computed with an f32 reciprocal multiply and
    corrected; the digit dividends stay < 2^16 * b so quotient digits
    fit 16 bits and one +-1 correction suffices."""
    inv = 1.0 / b_f32
    hi = jnp.right_shift(a, jnp.uint32(16))
    q1 = (hi.astype(jnp.float32) * inv).astype(jnp.uint32)
    r1 = hi - q1 * b
    fix = (r1.astype(jnp.int32) < 0)
    q1 = jnp.where(fix, q1 - 1, q1)
    r1 = jnp.where(fix, r1 + b, r1)
    fix = r1 >= b
    q1 = jnp.where(fix, q1 + 1, q1)
    r1 = jnp.where(fix, r1 - b, r1)

    lo = (r1 << jnp.uint32(16)) | (a & jnp.uint32(0xFFFF))
    q2 = (lo.astype(jnp.float32) * inv).astype(jnp.uint32)
    r2 = lo - q2 * b
    fix = (r2.astype(jnp.int32) < 0)
    q2 = jnp.where(fix, q2 - 1, q2)
    r2 = jnp.where(fix, r2 + b, r2)
    fix = r2 >= b
    q2 = jnp.where(fix, q2 + 1, q2)
    return (q1 << jnp.uint32(16)) + q2


def _shift_low(state):
    """One conditional shift_low (native/rc.h:92-106).  Returns the
    new state plus an event tuple (flush?, cache byte, ff count,
    carry)."""
    low, rng, cache, ffnum, carry = state
    flush = (low < K_THRESH) | (carry > 0)
    ev_cache = cache
    ev_ff = ffnum
    ev_carry = carry
    cache = jnp.where(flush, jnp.right_shift(low, jnp.uint32(24)), cache)
    ffnum = jnp.where(flush, jnp.uint32(0), ffnum + 1)
    carry = jnp.where(flush, jnp.uint32(0), carry)
    low = low << jnp.uint32(8)
    return (low, rng, cache, ffnum, carry), (flush, ev_cache, ev_ff,
                                             ev_carry)


@jax.jit
def encode_scan(cum, freq, tot, active=None, state0=None):
    """Walk B range coders over T symbols each.

    cum/freq/tot: (B, T) uint32 with tot < 2^16 (inactive steps: pass
    freq=tot so range is unchanged... or use `active`).  active:
    optional (B, T) bool; inactive steps leave the state untouched.
    state0: optional carried state from a previous chunk (the 5-tuple
    this function returns), enabling long streams to walk in T-chunks
    with the event planes drained between chunks.

    Returns (final_state tuple of (B,) arrays,
             events: (flush (B,T,2) bool, cache (B,T,2) u32,
                      ff (B,T,2) u32, carry (B,T,2) u32))."""
    B, T = cum.shape

    def step(state, xs):
        c, f, t, act = xs
        low, rng, cache, ffnum, carry = state
        old_low = low
        rng2 = _div_u32_u16(rng, t.astype(jnp.float32), t)
        low2 = low + c * rng2
        rng2 = rng2 * f
        carry2 = carry + (low2 < old_low).astype(jnp.uint32)

        s2 = (low2, rng2, cache, ffnum, carry2)
        evs = []
        for _ in range(2):
            need = s2[1] < K_TOP
            s3, ev = _shift_low(s2)
            s3 = (jnp.where(need, s3[0], s2[0]),
                  jnp.where(need, s3[1] << jnp.uint32(8), s2[1]),
                  jnp.where(need, s3[2], s2[2]),
                  jnp.where(need, s3[3], s2[3]),
                  jnp.where(need, s3[4], s2[4]))
            evs.append((ev[0] & need, ev[1], ev[2], ev[3]))
            s2 = s3

        if act is not None:
            keep = act
            s2 = tuple(jnp.where(keep, n, o) for n, o in zip(s2, state))
            evs = [(e[0] & keep, e[1], e[2], e[3]) for e in evs]
        out_ev = tuple(jnp.stack([evs[0][k], evs[1][k]], axis=-1)
                       for k in range(4))
        return s2, out_ev

    if state0 is None:
        z = jnp.zeros((B,), jnp.uint32)
        state0 = (z, jnp.full((B,), 0xFFFFFFFF, jnp.uint32), z, z, z)
    xs = (jnp.swapaxes(cum.astype(jnp.uint32), 0, 1),
          jnp.swapaxes(freq.astype(jnp.uint32), 0, 1),
          jnp.swapaxes(tot.astype(jnp.uint32), 0, 1),
          jnp.swapaxes(active, 0, 1) if active is not None else
          jnp.ones((T, B), bool))
    statef, (flush, cache, ff, carry) = jax.lax.scan(step, state0, xs)
    return statef, (jnp.swapaxes(flush, 0, 1), jnp.swapaxes(cache, 0, 1),
                    jnp.swapaxes(ff, 0, 1), jnp.swapaxes(carry, 0, 1))


@jax.jit
def walk_events(P0, P1, state):
    """encode_scan behind the packed-plane interface of the pass-3
    kernel (ops/rc_gpu.walk_events): (B, T) planes P0 = cum << 16 |
    freq, P1 = active << 16 | tot and state (B, 5) in; (ff0, ev0, ff1,
    ev1) (B, T) event planes and the final (B, 5) state out."""
    act = (P1 >> 16) != 0
    st, (fl, ca, ff, cy) = encode_scan(
        P0 >> 16, P0 & 0xFFFF, P1 & 0xFFFF, active=act,
        state0=tuple(state[:, k].astype(jnp.uint32) for k in range(5)))
    ev = [(fl[..., k].astype(jnp.uint32) << 16)
          | ((cy[..., k] & 0xFF) << 8) | (ca[..., k] & 0xFF)
          for k in range(2)]
    return (ff[..., 0], ev[0], ff[..., 1], ev[1]), jnp.stack(st, axis=1)


def finish_events(state):
    """The 5 finish_encode shift_lows, computed on host (tiny)."""
    low, rng, cache, ffnum, carry = [np.asarray(x) for x in state]
    B = low.shape[0]
    tails = []
    for b in range(B):
        lo, ca, ff, cy = int(low[b]), int(cache[b]), int(ffnum[b]), \
            int(carry[b])
        out = []
        for _ in range(5):
            if lo < (255 << 24) or cy:
                out.append((ca + cy) & 0xFF)
                out.extend([(cy - 1) & 0xFF] * ff)
                ca = (lo >> 24) & 0xFF
                ff = 0
                cy = 0
            else:
                ff += 1
            lo = (lo << 8) & 0xFFFFFFFF
        tails.append(bytes(out))
    return tails


def assemble_stream(flush_b, cache_b, ff_b, carry_b, tail: bytes) -> bytes:
    """Expand one stream's event planes into bytes.

    Event semantics (shift_low): when flush fires, emit
    (cache + carry) & 0xFF followed by ff bytes of (carry - 1) & 0xFF.
    NB the first flush of a stream reproduces the coder's leading 0
    byte (cache starts at 0), matching the reference's framing."""
    fl = flush_b.reshape(-1)
    ca = cache_b.reshape(-1).astype(np.int64)
    ff = ff_b.reshape(-1).astype(np.int64)
    cy = carry_b.reshape(-1).astype(np.int64)
    idx = np.flatnonzero(fl)
    if idx.size == 0:
        return tail
    caf = ca[idx]
    cyf = cy[idx]
    fff = ff[idx]
    # per-event byte counts: 1 + ff
    counts = 1 + fff
    total = int(counts.sum())
    out = np.empty(total, np.uint8)
    pos = np.cumsum(counts) - counts
    out[pos] = (caf + cyf) & 0xFF
    # fill the 0xFF runs: positions between events take (carry-1)
    run_ev = np.repeat(np.arange(idx.size), fff)
    if run_ev.size:
        run_pos = np.arange(total)
        mask = np.ones(total, bool)
        mask[pos] = False
        out[run_pos[mask]] = (cyf[run_ev] - 1) & 0xFF
    return out.tobytes() + tail
