"""Pallas (Triton route) kernel for pass-2 AdaptiveModel evolution.

The recurrence of fqz_model_jax.evolve (c_simple_model.h:63-171: STEP
bump, normalise at MAX_FREQ with zero-preserving halving, adjacent
bubble swap) runs with CB contexts per program: the block's
(CB, lanes) symbol and frequency arrays stay in registers while the
program walks its contexts' occurrences, up to the largest occurrence
count in the block.  The bubble swap is a compare-and-select on the
lanes at pos and pos-1.  Output (cum, freq, tot) triples equal the
`lax.scan` reference bit for bit (tests/test_model_gpu.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

K_MAX_FREQ = (1 << 16) - 17
CB = 4   # contexts per program


def _evolve_kernel(step_inc: int, lanes: int, sym_ref, cnt_ref, ms_ref,
                   cum_ref, f_ref, tot_ref):
    rows = pl.program_id(0) * CB + jnp.arange(CB, dtype=jnp.int32)
    cnt = cnt_ref[rows]
    ms = ms_ref[rows]
    lane = jnp.arange(lanes, dtype=jnp.int32)[None, :]
    symv = jnp.broadcast_to(lane, (CB, lanes))
    freqv = jnp.where(lane < ms[:, None], 1, 0)

    def step(t, carry):
        symv, freqv, tot = carry
        s = sym_ref[rows, t]
        act = t < cnt
        active = act[:, None]
        onpos = symv == s[:, None]
        pos = jnp.sum(jnp.where(onpos, lane, 0), axis=1)
        cum = jnp.sum(jnp.where(lane < pos[:, None], freqv, 0), axis=1)
        f = jnp.sum(jnp.where(onpos, freqv, 0), axis=1)
        cum_ref[rows, t] = cum
        f_ref[rows, t] = f
        tot_ref[rows, t] = tot

        freq2 = freqv + jnp.where(onpos, step_inc, 0)
        tot2 = tot + step_inc
        over = tot2 > K_MAX_FREQ
        freq2 = jnp.where(over[:, None], freq2 - (freq2 >> 1), freq2)
        tot2 = jnp.where(over, jnp.sum(freq2, axis=1), tot2)
        fval = f + step_inc
        fval = jnp.where(over, fval - (fval >> 1), fval)
        onprev = lane == (pos - 1)[:, None]
        fprev = jnp.sum(jnp.where(onprev, freq2, 0), axis=1)
        sprev = jnp.sum(jnp.where(onprev, symv, 0), axis=1)
        do = ((pos > 0) & (fval > fprev))[:, None]
        symv2 = jnp.where(do & onpos, sprev[:, None],
                          jnp.where(do & onprev, s[:, None], symv))
        freq3 = jnp.where(do & onpos, fprev[:, None],
                          jnp.where(do & onprev, fval[:, None], freq2))
        return (jnp.where(active, symv2, symv),
                jnp.where(active, freq3, freqv),
                jnp.where(act, tot2, tot))

    jax.lax.fori_loop(0, jnp.max(cnt), step, (symv, freqv, ms))


@functools.partial(jax.jit,
                   static_argnames=("step_inc", "lanes", "interpret"))
def evolve_walk(symplane, counts, max_sym, *, step_inc: int = 16,
                lanes: int = 128, interpret: bool = False):
    """Evolve C AdaptiveModels.  symplane: (C, T) symbols, counts: (C,)
    occurrences, max_sym: (C,) model sizes.  Returns (cum, freq, tot)
    (C, T) uint32 planes, defined where t < counts[c] — the
    fqz_model_jax.evolve interface."""
    C, T = symplane.shape
    Cp = -(-C // CB) * CB
    pad = ((0, Cp - C),)
    plane = jax.ShapeDtypeStruct((Cp, T), jnp.int32)
    cum, f, tot = pl.pallas_call(
        functools.partial(_evolve_kernel, step_inc, lanes),
        grid=(Cp // CB,),
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4,
                                                 num_stages=1),
        interpret=interpret,
        name="model_evolve_walk",
    )(jnp.pad(symplane.astype(jnp.int32), pad + ((0, 0),)),
      jnp.pad(counts.astype(jnp.int32), pad),
      jnp.pad(jnp.broadcast_to(max_sym, (C,)).astype(jnp.int32), pad,
              constant_values=2))
    return tuple(x[:C].astype(jnp.uint32) for x in (cum, f, tot))
