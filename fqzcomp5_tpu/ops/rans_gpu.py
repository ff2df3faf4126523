"""Pallas (Triton route) kernels for the batched 32-lane rANS walks.

One program walks one stream: its 32 interleaved rANS states are the 32
lanes of one warp (the reference's 32x16 layout,
rANS_static32x16pr.c), and the whole T-step chain runs inside the
kernel with the states in registers.  Streams are independent, so B
streams are B programs.  Arithmetic is native uint32 with integer
division; both kernels equal their `lax.scan` references in
ops/rans_jax.py bit for bit (tests/test_rans_gpu.py).

Encode (`encode_walk`): input is the per-step table plane
P = (freq << shift) | start, gathered by XLA from the stream's table
before the call.  Each loop iteration issues the loads of CH steps
before the first of them is used, so the serial state chain does not
wait on one memory round trip per step.

Decode (`decode_walk`): the s3 LUT (freq<<(shift+8) | bias<<8 | sym,
ops/rans_jax.build_s3) is gathered per lane from device memory; for
order 1 it is indexed by (previous symbol, slot).  Renormalising lanes
take words at ptr + (inclusive count of renormalising lanes up to them)
- 1, the reference's own 32-way loop.  Each stream walks its own step
count, so ragged batches cost nothing for their padding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

N = 32
RANS_L = 1 << 15
CH = 8   # encode steps whose loads issue together


def _params(num_warps: int = 1):
    return pl_triton.CompilerParams(num_warps=num_warps, num_stages=1)


def _encode_kernel(shift: int, T: int, p_ref, r0_ref, out_ref, rf_ref):
    b = pl.program_id(0)
    mask = jnp.uint32((1 << shift) - 1)

    def chunk(i, R):
        t0 = T - (i + 1) * CH
        P = [p_ref[b, t0 + k, :] for k in range(CH)]
        for k in reversed(range(CH)):
            f = P[k] >> shift
            start = P[k] & mask
            # R > x_max = (f << (31 - shift)) - 1
            emit = (R >> (31 - shift)) >= f
            out_ref[b, t0 + k, :] = ((R & 0xFFFF)
                                     | (emit.astype(jnp.uint32) << 16))
            R = jnp.where(emit, R >> 16, R)
            q = R // f
            R = (q << shift) + (R - q * f) + start
        return R

    R = jax.lax.fori_loop(0, T // CH, chunk, r0_ref[b, :])
    rf_ref[b, :] = R


@functools.partial(jax.jit, static_argnames=("shift", "interpret"))
def encode_walk(P, R0, *, shift: int, interpret: bool = False):
    """Reversed encode walk over (B, T, 32) uint32 planes of
    (freq << shift) | start; T must be a multiple of CH (pad with the
    identity entry 1 << (2*shift)).  R0: (B, 32) uint32.  Returns
    (Rf (B, 32), out (B, T, 32)) uint32 with out = word | emit << 16,
    equal to rans_jax.encode_scan_flat."""
    B, T, n = P.shape
    assert n == N and T % CH == 0, (P.shape, CH)
    out, Rf = pl.pallas_call(
        functools.partial(_encode_kernel, shift, T),
        grid=(B,),
        out_shape=[jax.ShapeDtypeStruct((B, T, N), jnp.uint32),
                   jax.ShapeDtypeStruct((B, N), jnp.uint32)],
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="rans_encode_walk",
    )(P.astype(jnp.uint32), R0.astype(jnp.uint32))
    return Rf, out


def _decode_kernel(shift: int, order1: bool, T: int, w_ref, r0_ref,
                   s3_ref, tr_ref, sym_ref, rf_ref, ptr_ref):
    b = pl.program_id(0)
    W = w_ref.shape[1]
    mask = jnp.uint32((1 << shift) - 1)

    def step(t, carry):
        R, ptr, last = carry
        m = R & mask
        slot = m.astype(jnp.int32)
        if order1:
            slot = last * (1 << shift) + slot
        S = s3_ref[b, slot]
        sym = (S & 0xFF).astype(jnp.int32)
        Rn = (S >> (shift + 8)) * (R >> shift) + ((S >> 8) & mask)
        need = Rn < RANS_L
        offs = jnp.cumsum(need.astype(jnp.int32))
        widx = jnp.clip(ptr + offs - 1, 0, W - 1)
        w = w_ref[b, widx]
        Rn = jnp.where(need, (Rn << 16) | w, Rn)
        sym_ref[b, t, :] = sym
        return Rn, ptr + jnp.sum(need.astype(jnp.int32)), sym

    n = jnp.minimum(tr_ref[b], T)
    R, ptr, _ = jax.lax.fori_loop(
        0, n, step, (r0_ref[b, :], jnp.int32(0), jnp.zeros(N, jnp.int32)))
    rf_ref[b, :] = R
    ptr_ref[b] = ptr


@functools.partial(jax.jit,
                   static_argnames=("T", "shift", "order1", "interpret"))
def decode_walk(words, R0, s3, t_real, *, T: int, shift: int,
                order1: bool, interpret: bool = False):
    """Decode B streams.  words: (B, W) uint32 (u16 values), R0: (B, 32)
    uint32, s3: (B, (256 if order1 else 1) << shift) uint32, t_real: (B,)
    int32 steps per stream (<= T).  Returns (syms (B, T, 32) int32 —
    rows past t_real are undefined —, final states (B, 32), final word
    cursors (B,)), equal to rans_jax.decode_scan / decode_scan_o1."""
    B = words.shape[0]
    syms, Rf, ptr = pl.pallas_call(
        functools.partial(_decode_kernel, shift, order1, T),
        grid=(B,),
        out_shape=[jax.ShapeDtypeStruct((B, T, N), jnp.int32),
                   jax.ShapeDtypeStruct((B, N), jnp.uint32),
                   jax.ShapeDtypeStruct((B,), jnp.int32)],
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="rans_decode_walk_o1" if order1 else "rans_decode_walk_o0",
    )(words.astype(jnp.uint32), R0.astype(jnp.uint32),
      s3.astype(jnp.uint32), t_real.astype(jnp.int32))
    return syms, Rf, ptr
