"""Pass 2 of the fqz-qual device decomposition: per-context model
evolution.

The SIMPLE_MODEL recurrence (c_simple_model.h:63-171; native/rc.h
AdaptiveModel) looked sequential — the bubble reordering makes each
occurrence's cumulative frequency depend on the whole history — but it
vectorises along a different axis: the model's symbol ARRAY lives on
the 128 lanes (position-major: lane j holds (sym, freq) of array slot
j), and thousands of independent CONTEXTS batch along rows.  Each step
then processes occurrence t of every context at once:

  find     pos of the encoded symbol   -> lane compare + index reduce
  cum      sum of freqs before pos     -> masked lane reduce
  bump     freq += STEP at pos         -> masked add
  norm     f -= f>>1 when tot overflows-> elementwise (zeros stay zero,
                                          so the reference's stop-at-
                                          zero loop is equivalent)
  bubble   adjacent swap when the bumped freq passes its neighbour
                                       -> two masked selects

Occurrences are grouped per context beforehand (a stable sort of the
pass-1 context plane); contexts with fewer occurrences than the step
index are masked.  Work is O(total_bytes * 128 lanes) — the lane
blowup buys full vectorisation of a branch-and-pointer CPU loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

K_MAX_FREQ = (1 << 16) - 17


@partial(jax.jit, static_argnames=("lanes",))
def evolve(symplane, counts, max_sym, step_inc, lanes=128):
    """Evolve C independent AdaptiveModels.

    symplane: (C, T) int32 — context c's t-th encoded symbol (padded);
    counts: (C,) int32 occurrence counts; max_sym: scalar int32 or
    (C,) vector (model init size — per-row so one batch can mix the
    qual models with the len/sel/dup overhead models); step_inc:
    scalar int32 (STEP); lanes: model array capacity — 128 covers the
    qual/sel/dup models, the AdaptiveModel<256> length-byte models
    need 256 (two lane registers per row).

    Returns (cum, freq, tot): (C, T) uint32 planes of the triples each
    encode uses (garbage past counts[c])."""
    C, T = symplane.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, lanes), 1)

    ms = jnp.broadcast_to(jnp.reshape(jnp.asarray(max_sym, jnp.int32),
                                      (-1, 1)), (C, 1))
    sym0 = jnp.broadcast_to(lane, (C, lanes)).astype(jnp.int32)
    freq0 = jnp.where(lane < ms, 1, 0).astype(jnp.int32)
    tot0 = ms

    def stepf(carry, t):
        symv, freqv, tot = carry
        s = jax.lax.dynamic_slice_in_dim(symplane, t, 1, 1)  # (C,1)
        active = (t < counts)[:, None]

        onpos = symv == s                      # (C, lanes) one-hot
        pos = jnp.sum(jnp.where(onpos, lane, 0), axis=1, keepdims=True)
        cum = jnp.sum(jnp.where(lane < pos, freqv, 0), axis=1,
                      keepdims=True)
        f = jnp.sum(jnp.where(onpos, freqv, 0), axis=1, keepdims=True)

        # bump
        freq2 = freqv + jnp.where(onpos, step_inc, 0)
        tot2 = tot + step_inc
        # normalize on overflow (zeros stay zero)
        over = tot2 > K_MAX_FREQ
        fn = freq2 - (freq2 >> 1)
        freq2 = jnp.where(over, fn, freq2)
        tot2 = jnp.where(over,
                         jnp.sum(freq2, axis=1, keepdims=True), tot2)
        # bubble: swap pos-1 <-> pos when freq[pos] > freq[pos-1]
        fval = jnp.sum(jnp.where(onpos, freq2, 0), axis=1,
                       keepdims=True)
        onprev = lane == (pos - 1)
        fprev = jnp.sum(jnp.where(onprev, freq2, 0), axis=1,
                        keepdims=True)
        sprev = jnp.sum(jnp.where(onprev, symv, 0), axis=1,
                        keepdims=True)
        do = (pos > 0) & (fval > fprev)
        symv2 = jnp.where(do & onpos, sprev,
                          jnp.where(do & onprev, s, symv))
        freq3 = jnp.where(do & onpos, fprev,
                          jnp.where(do & onprev, fval, freq2))

        symv2 = jnp.where(active, symv2, symv)
        freq3 = jnp.where(active, freq3, freqv)
        tot2 = jnp.where(active, tot2, tot)
        return (symv2, freq3, tot2), (cum[:, 0], f[:, 0], tot[:, 0])

    (_, _, _), (cums, freqs, tots) = jax.lax.scan(
        stepf, (sym0, freq0, tot0), jnp.arange(T, dtype=jnp.int32))
    return (jnp.swapaxes(cums, 0, 1).astype(jnp.uint32),
            jnp.swapaxes(freqs, 0, 1).astype(jnp.uint32),
            jnp.swapaxes(tots, 0, 1).astype(jnp.uint32))


@partial(jax.jit, static_argnames=("nsym",))
def tiny_evolve(symplane, counts, nsym=4):
    """Evolve C independent TinyModels (native/rc.h TinyModel; the
    seq codec's per-k-mer and state models).

    Far simpler than the AdaptiveModel: no reordering, STEP 1,
    normalisation when the PRE-bump total reaches 255.  Contexts ride
    the lanes; the nsym-wide freq vector is a tiny leading axis.
    Update-only events (the both-strands shadow walk) mutate state
    identically to encodes, so callers simply ignore their triples.

    symplane: (C, T) int32; counts: (C,) int32.  Returns (cum, freq,
    tot) uint32 (C, T) planes."""
    C, T = symplane.shape
    sidx = jax.lax.broadcasted_iota(jnp.int32, (nsym, 1), 0)
    freq0 = jnp.ones((nsym, C), jnp.int32)
    symT = jnp.swapaxes(symplane, 0, 1)  # (T, C)

    def stepf(freqv, inp):
        s, t = inp
        active = (t < counts)[None, :]
        onpos = sidx == s[None, :]
        tot = jnp.sum(freqv, axis=0)
        cum = jnp.sum(jnp.where(sidx < s[None, :], freqv, 0), axis=0)
        f = jnp.sum(jnp.where(onpos, freqv, 0), axis=0)
        freq2 = freqv + jnp.where(onpos, 1, 0)
        freq2 = jnp.where(tot[None, :] >= 255, freq2 - (freq2 >> 1),
                          freq2)
        freq2 = jnp.where(active, freq2, freqv)
        return freq2, (cum, f, tot)

    _, (cums, freqs, tots) = jax.lax.scan(
        stepf, freq0, (symT, jnp.arange(T, dtype=jnp.int32)))
    return (jnp.swapaxes(cums, 0, 1).astype(jnp.uint32),
            jnp.swapaxes(freqs, 0, 1).astype(jnp.uint32),
            jnp.swapaxes(tots, 0, 1).astype(jnp.uint32))


def pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _evolve_rows(symplane, counts, max_sym, *, step_inc: int,
                 lanes: int):
    return evolve(symplane.astype(jnp.int32), counts, max_sym,
                  jnp.int32(step_inc), lanes=lanes)


def evolve_dev(symplane, counts, max_sym, step_inc: int = 16,
               lanes: int = 128):
    """evolve on the walk device: the kernel of ops/model_gpu.py on a
    GPU, the scan above elsewhere (bit-identical, tests/
    test_model_gpu.py).  max_sym: (C,) per-row model sizes.  Context
    rows shard over an installed mesh."""
    from fqzcomp5_tpu.ops import backend, model_gpu

    if backend.use_kernel():
        fn = backend.bound(model_gpu.evolve_walk, step_inc=step_inc,
                           lanes=lanes, interpret=backend.INTERPRET)
    else:
        fn = backend.bound(_evolve_rows, step_inc=step_inc, lanes=lanes)
    return backend.row_call(fn, symplane, counts,
                            np.asarray(max_sym, np.int32))


def group_stream(ctx: np.ndarray, qm: np.ndarray):
    """Stable-group a stream's (ctx, sym) sequence by context — CSR
    form, memory O(n).

    Returns (uniq (C,), counts (C,) i64, starts (C,) i64 into the
    sorted order, order (n,) i64 stream positions sorted by context,
    syms_sorted (n,)).  The old dense (C, Tmax) plane form blew up to
    gigabytes on skewed distributions (every record resets its model
    context, so one context's count is >= nrec while C is huge)."""
    order = np.argsort(ctx, kind="stable")
    uniq, starts, counts = np.unique(ctx[order], return_index=True,
                                     return_counts=True)
    return (uniq, counts.astype(np.int64), starts.astype(np.int64),
            order.astype(np.int64), np.ascontiguousarray(qm[order]))


def _concat_arange(seg: np.ndarray) -> np.ndarray:
    """[0..seg[0]), [0..seg[1]), ... concatenated."""
    total = int(seg.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(seg) - seg, seg))


def evolve_grouped(g, run, rows=None, out=None, collect=None,
                   posmap=None):
    """Pass-2 evolve over a CSR-grouped stream, rows bucketed by
    occurrence count, results scattered straight back to per-event
    stream positions.

    A skewed context distribution makes a dense (C, Tmax) plane mostly
    padding, so each power-of-4 count bucket builds its own
    (rows, tb) plane from the sorted stream: total padded cells stay
    within ~4x the useful events regardless of skew, and the handful
    of pow2 shapes keeps compiles bounded.

    g: group_stream result.  run(sub_plane, sub_counts, rows) ->
    (cum, freq, tot) jnp arrays; sub arrays arrive pow2-padded on both
    dims, `rows` are GLOBAL row indices (into g's uniq) for per-row
    metadata lookups.  rows: optional subset of row indices to
    process.  out: optional (cum, freq, tot) (n,) uint32 arrays to
    scatter into (allocated when None).  Returns out.

    collect: optional DevTriples — results stay DEVICE-RESIDENT; each
    bucket's jnp triplet registers with collect keyed by event
    position (out is untouched; pass-3 gathers by index on device).
    posmap: optional map from this stream's local event positions to
    the collector's global positions."""
    from fqzcomp5_tpu.ops import backend

    uniq, counts, starts, order, ssorted = g
    if rows is None:
        rows = np.arange(len(uniq), dtype=np.int64)
    if out is None and collect is None:
        n = len(order)
        out = (np.zeros(n, np.uint32), np.zeros(n, np.uint32),
               np.zeros(n, np.uint32))
    cnt = counts[rows]
    maxc = int(cnt.max()) if len(cnt) else 0
    done = np.zeros(len(rows), bool)
    tb = 16
    while True:
        tbe = min(tb, max(maxc, 1))
        sel = np.flatnonzero(~done & (cnt <= tbe))
        if len(sel):
            r = rows[sel]
            C2 = pow2(len(sel))
            C2 += backend.pad_rows(C2)  # mesh-divisible row count
            seg = cnt[sel]
            src = np.repeat(starts[r], seg) + _concat_arange(seg)
            rloc = np.repeat(np.arange(len(sel)), seg)
            occ = _concat_arange(seg)
            vals = ssorted[src]
            # byte symbols (the wire format's envelope) upload as u8 —
            # a quarter of the int32 plane; callbacks widen on device
            dt = (np.uint8 if vals.size == 0 or vals.max() < 256
                  else np.int32)
            sp = np.zeros((C2, tbe), dt)
            sp[rloc, occ] = vals.astype(dt)
            ct = np.zeros(C2, np.int32)
            ct[:len(sel)] = seg
            cs, fs, ts = run(backend.shard_rows(sp, extra_dims=1),
                             backend.shard_rows(ct), r)
            posn = order[src]
            if collect is not None:
                if posmap is not None:
                    posn = posmap[posn]
                collect.add(cs, fs, ts, posn, rloc, occ, tbe)
            else:
                cs, fs, ts = map(np.asarray, (cs, fs, ts))
                cum, freq, tot = out
                cum[posn] = cs[rloc, occ]
                freq[posn] = fs[rloc, occ]
                tot[posn] = ts[rloc, occ]
            done[sel] = True
        if tbe >= maxc or done.all():
            break
        tb *= 4
    return out


def triples_for_stream(ctx: np.ndarray, qm: np.ndarray, max_sym: int,
                       step_inc: int = 16):
    """Convenience: full pass-2 for one stream — group, evolve,
    un-sort.  Returns (cum, freq, tot) uint32 arrays in stream order."""
    g = group_stream(ctx, qm)

    def run(sp, ct, r):
        return evolve(jnp.asarray(sp), jnp.asarray(ct),
                      jnp.int32(max_sym), jnp.int32(step_inc))

    return evolve_grouped(g, run)
