"""Batched 32-lane rANS cores as JAX computations: the plain `lax`
references of the walk kernels in ops/rans_gpu.py.

Formulation of the reference's 32x16 SIMD rANS
(htscodecs/rANS_static32x16pr*.c): the 32 interleaved states are the
minor axis, and **independent streams batch along the leading axis**
as a (B, 32) state matrix.  The per-symbol dependency chain runs as a
`lax.scan`; all per-step work (table gathers, renormalisation
prefix-sums, word gathers) is vectorised.

Bitstreams are identical to the native/reference codec: table
construction and stream framing stay on the host (tiny), these kernels
do the O(n) state walk.

Encode trick: states emit at most one u16 per symbol.  The scan only
records (word, mask) planes; compaction into the final backwards-
written stream is a single vectorised pass afterwards, so the scan
body stays branch-free.

Decode trick: each step consumes 0..32 words from the shared stream.
A per-step exclusive prefix sum over the renormalisation mask gives
every lane its word offset; a carried scalar cursor tracks the total.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

N = 32           # interleaved states
RANS_L = 1 << 15
TF_SHIFT = 12    # order-0
MASK12 = (1 << TF_SHIFT) - 1


# ---------------------------------------------------------------------
# Encoder symbol tables (host-side prep, numpy)

def build_enc_tables(freqs: np.ndarray, shift: int):
    """Per-symbol (x_max, rcp, rcp_shift, bias, cmpl) arrays.

    freqs: (..., 256) normalised to sum 1<<shift (rows of zeros allowed
    for absent order-1 contexts).  Mirrors RansEncSymbolInit
    (rANS_word.h:195-260).
    """
    f64 = np.ascontiguousarray(freqs, np.int64)
    start = np.cumsum(f64, axis=-1) - f64
    x_max = (((RANS_L >> shift) << 16) * f64 - 1).astype(np.uint32)
    cmpl = ((1 << shift) - f64).astype(np.uint32)
    rcp = np.full(f64.shape, 0xFFFFFFFF, np.uint32)
    rcp_shift = np.zeros(f64.shape, np.uint32)
    bias = (start + (1 << shift) - 1).astype(np.uint32)

    # the log/divide reciprocal setup only applies to freq >= 2 —
    # order-1 tables are ~98% zeros, so compute it sparsely (this is
    # the dominant host prep cost at large waves otherwise)
    flat_f = f64.reshape(-1)
    nz = np.flatnonzero(flat_f >= 2)
    if nz.size:
        fv = flat_f[nz].astype(np.uint64)
        sh = np.ceil(np.log2(fv.astype(np.float64))).astype(np.uint64)
        # exact: smallest sh with freq <= 1<<sh
        sh = np.where((np.uint64(1) << sh) < fv, sh + 1, sh)
        r = ((np.uint64(1) << (sh + np.uint64(31))) + fv
             - np.uint64(1)) // fv
        rcp.reshape(-1)[nz] = r.astype(np.uint32)
        rcp_shift.reshape(-1)[nz] = (sh - 1).astype(np.uint32)
        bias.reshape(-1)[nz] = start.reshape(-1)[nz].astype(np.uint32)
    return x_max, rcp, rcp_shift, bias, cmpl


def build_s3(freqs: np.ndarray, shift: int) -> np.ndarray:
    """Flattened decode LUT: slot -> freq<<(shift+8) | bias<<8 | sym.

    freqs: (..., 256) normalised; returns (..., 1<<shift) uint32.
    Mirrors rans_F_to_s3 (rANS_static16_int.h:540).
    """
    lead = freqs.shape[:-1]
    tot = 1 << shift
    out = np.zeros(lead + (tot,), np.uint32)
    flat_f = freqs.reshape(-1, 256)
    flat_o = out.reshape(-1, tot)
    for r in range(flat_f.shape[0]):
        F = flat_f[r]
        x = 0
        for j in np.flatnonzero(F):
            fj = int(F[j])
            base = (int(fj) << (shift + 8)) | int(j)
            flat_o[r, x:x + fj] = ((base +
                                    (np.arange(fj, dtype=np.uint64) << 8))
                                   & 0xFFFFFFFF).astype(np.uint32)
            x += fj
    return out


# ---------------------------------------------------------------------
# uint32 helpers (jnp)

def _mulhi32(a, b):
    """High 32 bits of a*b for uint32 inputs, without 64-bit types."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    m0 = a0 * b0
    m1 = a1 * b0 + (m0 >> 16)
    m2 = a0 * b1
    lo = (m1 & 0xFFFF) + (m2 & 0xFFFF)
    return a1 * b1 + (m1 >> 16) + (m2 >> 16) + (lo >> 16)


# ---------------------------------------------------------------------
# Order-0 encode core

@functools.partial(jax.jit, static_argnames=("shift",))
def encode_scan(syms, x_max, rcp, rcp_shift, bias, cmpl, shift: int,
                R0=None):
    """Walk (B, T, N) symbols in reverse, returning emitted word planes.

    Returns (final_states (B,N), words (B,T,N) u16-in-u32,
    mask (B,T,N) bool).  Symbol tables are (B, S) gathered per lane.
    R0 optionally seeds the states (also lets shard_map callers pass a
    carry with the right varying mesh axes)."""
    B = syms.shape[0]

    def step(R, sym_t):
        # sym_t: (B, N) symbol ids
        xm = jnp.take_along_axis(x_max, sym_t, axis=1)
        emit = R > xm
        word = R & 0xFFFF
        R = jnp.where(emit, R >> 16, R)
        q = _mulhi32(R, jnp.take_along_axis(rcp, sym_t, axis=1))
        q = q >> jnp.take_along_axis(rcp_shift, sym_t, axis=1)
        R = (R + jnp.take_along_axis(bias, sym_t, axis=1)
             + q * jnp.take_along_axis(cmpl, sym_t, axis=1))
        return R, (word, emit)

    if R0 is None:
        R0 = jnp.full((B, N), RANS_L, jnp.uint32)
    syms_t = jnp.swapaxes(syms.astype(jnp.int32), 0, 1)  # (T, B, N)
    Rf, (words, mask) = jax.lax.scan(step, R0.astype(jnp.uint32), syms_t,
                                     reverse=True)
    return Rf, jnp.swapaxes(words, 0, 1), jnp.swapaxes(mask, 0, 1)


def assemble_o0_stream(final_states: np.ndarray, words: np.ndarray,
                       mask: np.ndarray) -> bytes:
    """Host-side compaction of one stream's scan outputs into payload
    bytes (after the freq table).  Emission happened (t desc, z desc);
    the stream is written backwards, so ascending order is flush words
    then (t asc, z asc)."""
    flush = final_states.astype("<u4").tobytes()  # z = 0..31, 4B each
    w = words.reshape(-1)[mask.reshape(-1)].astype("<u2")
    return flush + w.tobytes()


# ---------------------------------------------------------------------
# Order-0 decode core

@functools.partial(jax.jit, static_argnames=("shift", "T"))
def decode_scan(words, R0, s3, T: int = None, shift: int = TF_SHIFT,
                t_real=None):
    """Decode (B,*,N)-interleaved symbols.

    words: (B, W) uint32 (u16 values), R0: (B, N) initial states,
    s3: (B, 1<<shift) LUT.  t_real: optional (B,) per-stream active
    step counts (for batches of different lengths; inactive steps
    neither mutate state nor consume words).  Returns (syms (B, T, N),
    final states, final cursors)."""
    B = words.shape[0]
    mask = (1 << shift) - 1

    def step(carry, _):
        R, ptr, t = carry
        active = (t < t_real) if t_real is not None else None
        m = R & mask
        S = jnp.take_along_axis(s3, m.astype(jnp.int32), axis=1)
        sym = (S & 0xFF).astype(jnp.uint8)
        Rn = (S >> (shift + 8)) * (R >> shift) + ((S >> 8) & mask)
        need = Rn < RANS_L
        if active is not None:
            need = need & active[:, None]
        offs = jnp.cumsum(need.astype(jnp.int32), axis=1)
        idx = ptr[:, None] + offs - 1
        idx = jnp.clip(idx, 0, words.shape[1] - 1)
        w = jnp.take_along_axis(words, idx, axis=1)
        Rn = jnp.where(need, (Rn << 16) | w, Rn)
        if active is not None:
            Rn = jnp.where(active[:, None], Rn, R)
        R = Rn
        ptr = ptr + offs[:, -1]
        return (R, ptr, t + 1), sym

    ptr0 = jnp.zeros((B,), jnp.int32)
    t0 = jnp.zeros((B,), jnp.int32)
    (Rf, ptrf, _), syms = jax.lax.scan(step, (R0, ptr0, t0), None, length=T)
    return jnp.swapaxes(syms, 0, 1), Rf, ptrf


# ---------------------------------------------------------------------
# Order-1 cores: same state walk, but tables are indexed by
# (prev_symbol, x).  The encoder gathers from (B, 256*256) tables with
# index ctx*256+sym; the decoder gathers s3 from (B, 256<<shift).

@functools.partial(jax.jit, static_argnames=("shift",))
def encode_scan_o1(syms, prev, x_max, rcp, rcp_shift, bias, cmpl,
                   shift: int, R0=None):
    """O1 encode walk.  syms/prev: (B, T, N) symbol and context ids
    (context 256 with any sym, or flat NOP handling via encode_scan_flat,
    marks inactive lanes).

    R0 (B, N) seeds the states (lane 31 may carry a host-walked tail)."""
    flat = prev.astype(jnp.int32) * 256 + syms.astype(jnp.int32)
    return encode_scan_flat(flat, x_max, rcp, rcp_shift, bias, cmpl, R0)


@jax.jit
def encode_scan_flat(flat, x_max, rcp, rcp_shift, bias, cmpl, R0=None):
    """Encode walk over precomputed flat table indices (B, T, N).

    Works for any context structure; a "nop" table row (x_max=2^32-1,
    rcp=bias=cmpl=0) makes a lane step inert, which implements both the
    order-0 remainder and variable-length batch padding."""
    B = flat.shape[0]

    def step(R, flat_t):
        xm = jnp.take_along_axis(x_max, flat_t, axis=1)
        emit = R > xm
        word = R & 0xFFFF
        R = jnp.where(emit, R >> 16, R)
        q = _mulhi32(R, jnp.take_along_axis(rcp, flat_t, axis=1))
        q = q >> jnp.take_along_axis(rcp_shift, flat_t, axis=1)
        R = (R + jnp.take_along_axis(bias, flat_t, axis=1)
             + q * jnp.take_along_axis(cmpl, flat_t, axis=1))
        return R, (word, emit)

    if R0 is None:
        R0 = jnp.full((B, N), RANS_L, jnp.uint32)
    Rf, (words, mask) = jax.lax.scan(
        step, R0.astype(jnp.uint32),
        jnp.swapaxes(flat.astype(jnp.int32), 0, 1), reverse=True)
    return Rf, jnp.swapaxes(words, 0, 1), jnp.swapaxes(mask, 0, 1)


@functools.partial(jax.jit, static_argnames=("shift", "T"))
def decode_scan_o1(words, R0, s3, T: int, shift: int, t_real=None):
    """O1 decode: carries last-symbol per lane; s3 is (B, 256<<shift).
    t_real: optional (B,) active step counts for ragged batches."""
    B = words.shape[0]
    mask = (1 << shift) - 1

    def step(carry, _):
        R, ptr, last, t = carry
        active = (t < t_real) if t_real is not None else None
        m = R & mask
        flat = last * (mask + 1) + m.astype(jnp.int32)
        S = jnp.take_along_axis(s3, flat, axis=1)
        sym = (S & 0xFF).astype(jnp.int32)
        Rn = (S >> (shift + 8)) * (R >> shift) + ((S >> 8) & mask)
        need = Rn < RANS_L
        if active is not None:
            need = need & active[:, None]
        offs = jnp.cumsum(need.astype(jnp.int32), axis=1)
        idx = jnp.clip(ptr[:, None] + offs - 1, 0, words.shape[1] - 1)
        w = jnp.take_along_axis(words, idx, axis=1)
        Rn = jnp.where(need, (Rn << 16) | w, Rn)
        if active is not None:
            Rn = jnp.where(active[:, None], Rn, R)
            sym = jnp.where(active[:, None], sym, last)
        R = Rn
        last = sym
        ptr = ptr + offs[:, -1]
        return (R, ptr, last, t + 1), sym.astype(jnp.uint8)

    ptr0 = jnp.zeros((B,), jnp.int32)
    last0 = jnp.zeros((B, N), jnp.int32)
    t0 = jnp.zeros((B,), jnp.int32)
    (Rf, ptrf, _, _), syms = jax.lax.scan(step, (R0, ptr0, last0, t0),
                                          None, length=T)
    return jnp.swapaxes(syms, 0, 1), Rf, ptrf
