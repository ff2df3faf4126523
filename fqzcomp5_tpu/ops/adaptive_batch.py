"""Cross-block batched device encode for the adaptive codecs.

The three-pass context-sorted decomposition (docs/
DEVICE_ADAPTIVE_CODECS.md) was designed for the B>1 regime: many
blocks' SEQ/FQZ sections share ONE bucketed pass-2 batch and ONE
batched pass-3 range-coder walk per wave, so the per-step lane
utilisation scales with the number of blocks in flight instead of
running B=1 walks per block.  This module is that regime: the
`-e tpu` wave driver hands a wave's worth of sections here
(tpu_driver.encode_stream_tpu), and the FQZ5_DEVICE_ADAPTIVE host
path routes through it with a single job.

Jobs are namespaced into one event stream:

  job j, model id m   ->  global row key  j * JOB_OFF + m

and grouped into four model families, each evolved in one
evolve_grouped batch across ALL jobs:

  T4    TinyModel<4>        seq codec k-mer models
  T2    TinyModel<2>        seq codec state models
  N128  AdaptiveModel<=128  fqz qual / sel / dup models
  W256  AdaptiveModel<256>  fqz length-byte + seq run/literal models

The pass-2 triples stay on the device (DevTriples).  Pass 3 stacks
every job's encode events into (B, T) index planes (pow2-bucketed by
length), gathers the triples by index on the device and walks them in
chunked calls (the kernel of ops/rc_gpu.py on a GPU, rc_jax's scan on
the CPU), carrying the coder state across chunks so arbitrarily long
sections stream through bounded device memory.  Each chunk's output
bytes are assembled on the device, so the host receives ~1 B per
payload byte and sends 4 B per event.

Payloads are byte-identical to the native codecs
(native/fqzqual.cpp:663-762, native/seq.cpp:39-157); the wave driver
splices them into ordinary FQZ5 sections that the reference binary
decodes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import backend, fqz_model_jax, rc_gpu, rc_jax
from .fqz_device_encode import (MID_LEN0, MID_SEL, build_stream,
                                prepare_fqz)
from .seq_device_encode import FAM_SEQ, FAM_STATE, build_events

JOB_OFF = 1 << 32        # > any local model id (4^14 seq ctx, 2^16+6 fqz)
CHUNK_T = 1 << 20        # pass-3 steps per device call (bounds planes)

# global model families
F_T4, F_T2, F_N128, F_W256 = 0, 1, 2, 3


def _prep_job(job):
    """Expand one job into (kind, header, events, enc_mask, fam, mid,
    sym) host arrays.  kind 'fqz' jobs carry a native wire header."""
    if job[0] == "fqz":
        _, qual, lens, flags, seq_buf, strat = job
        hdr, P, sels = prepare_fqz(qual, lens, flags, seq_buf, strat)
        if int(P.max_sym) >= 96:
            # mirror the native codec's decline (Models::init,
            # native/fqzqual.cpp): >96-symbol alphabets are outside
            # the wire format's safe envelope
            raise ValueError("fqz alphabet exceeds 96 symbols")
        la = np.ascontiguousarray(lens, np.uint32)
        mids, syms, _ = build_stream(qual, la, sels, P, seq=seq_buf)
        is_w256 = (mids >= MID_LEN0) & (mids < MID_SEL)
        fam = np.where(is_w256, F_W256, F_N128).astype(np.int8)
        enc = np.ones(len(mids), bool)
        meta = (int(P.max_sym) + 1, int(P.max_sel) + 1)
        return hdr, fam, mids, syms, enc, meta
    _, seq_buf, lens, both, slevel = job
    sfam, mid, sym, upd = build_events(seq_buf, lens, both, slevel)
    fam = np.where(sfam == FAM_SEQ, F_T4,
                   np.where(sfam == FAM_STATE, F_T2,
                            F_W256)).astype(np.int8)
    return b"", fam, mid, sym, ~upd, None


class DevTriples:
    """Device-resident pass-2 results: per-bucket (cum, freq, tot)
    jnp arrays plus a host index (`flatpos`) from global event
    position to flat vector position.  Pass 3 gathers by index on the
    device, so the triples never travel to the host; only the 4-byte
    index plane goes up."""

    def __init__(self, n_total: int):
        self.flatpos = np.full(n_total, -1, np.int64)
        self.parts: list[tuple] = []
        self.vbase = 0

    def add(self, cs, fs, ts, posn, rloc, occ, tbe) -> None:
        self.flatpos[posn] = self.vbase + rloc * tbe + occ
        self.parts.append((cs, fs, ts))
        self.vbase += int(np.prod(cs.shape))

    def vectors(self):
        """(Vc, Vf, Vt) int32 device vectors with the inactive
        sentinel (cum 0, freq 1, tot 2) appended last, and the
        sentinel index (== self.vbase)."""
        import jax.numpy as jnp

        vs = []
        for k, dflt in ((0, 0), (1, 1), (2, 2)):
            vs.append(jnp.concatenate(
                [p[k].reshape(-1).astype(jnp.int32)
                 for p in self.parts]
                + [jnp.full(1, dflt, jnp.int32)]))
        idx = self.flatpos.copy()
        idx[idx < 0] = self.vbase
        return tuple(vs), idx


def _evolve_families(jobvec, fam, mid, sym, metas, collect):
    """Pass 2 for the whole batch: group rows per family across jobs,
    evolve, and register the device-resident (cum, freq, tot) results
    with `collect` (a DevTriples) by event position."""
    gmid = jobvec * JOB_OFF + mid
    for F in (F_T4, F_T2, F_N128, F_W256):
        sel = np.flatnonzero(fam == F)
        if not len(sel):
            continue
        g = fqz_model_jax.group_stream(gmid[sel], sym[sel])
        uniq = g[0]
        kw = dict(collect=collect, posmap=sel)
        if F in (F_T4, F_T2):
            def run(sp, ct, r, _n=4 if F == F_T4 else 2):
                return fqz_model_jax.tiny_evolve(
                    jnp.asarray(sp).astype(jnp.int32),
                    jnp.asarray(ct), nsym=_n)
            fqz_model_jax.evolve_grouped(g, run, **kw)
            continue
        if F == F_W256:
            ms_rows = np.full(len(uniq), 256, np.int32)
        else:
            # per-row alphabet: qual models use the job's max_sym+1,
            # the sel model max_sel+1, the dup model 2
            ujob = (uniq // JOB_OFF).astype(np.int64)
            ulm = uniq % JOB_OFF
            msym = np.array([m[0] if m else 2 for m in metas], np.int32)
            msel = np.array([m[1] if m else 2 for m in metas], np.int32)
            ms_rows = np.where(ulm < MID_LEN0, msym[ujob],
                               np.where(ulm == MID_SEL, msel[ujob],
                                        2)).astype(np.int32)
        # rows whose alphabet exceeds 128 take the 256-lane evolve
        wide = ms_rows > 128
        for lanes, rows in ((256, np.flatnonzero(wide)),
                            (128, np.flatnonzero(~wide))):
            if len(rows):
                fqz_model_jax.evolve_grouped(
                    g, _evolve_run(ms_rows, lanes), rows=rows, **kw)


def _evolve_run(ms_rows, lanes: int):
    """evolve_grouped callback: per-row model sizes from ms_rows (pad
    rows get 2), evolved on the walk device."""
    def run(sp, ct, r):
        mr = np.full(len(ct), 2, np.int32)
        mr[:len(r)] = ms_rows[r]
        return fqz_model_jax.evolve_dev(sp, ct, mr, 16, lanes=lanes)
    return run


def _batch_budget_bytes() -> int:
    """Input bytes per batched chunk.  One event costs ~50-60 B of
    transient host memory across the three passes (event triple +
    sorted copies + rc planes), so an unbounded wave of 100 MB
    sections would need tens of GB; chunking keeps the working set
    bounded while leaving plenty of batch width for the device walks.
    Jobs are independent, so chunking never changes payload bytes."""
    import os

    return int(os.environ.get("FQZ5_ADAPTIVE_BATCH_MB", "128")) << 20


def encode_adaptive_batch(jobs) -> list[bytes]:
    """Encode many adaptive-codec jobs in batched three-pass runs.

    jobs: list of ('fqz', qual, lens, flags, seq_buf, strat) or
    ('seq', seq_buf, lens, both, slevel) tuples.  Returns the complete
    section payload per job (fqz jobs include the native wire header),
    byte-identical to the host codecs.  Waves whose summed input
    exceeds the memory budget run as several independent chunks."""
    if not jobs:
        return []
    budget = _batch_budget_bytes()
    total_in = sum(len(j[1]) for j in jobs)
    if total_in > budget and len(jobs) > 1:
        outs: list[bytes] = []
        chunk: list = []
        acc = 0
        for j in jobs:
            if chunk and acc + len(j[1]) > budget:
                outs.extend(_encode_adaptive_chunk(chunk))
                chunk, acc = [], 0
            chunk.append(j)
            acc += len(j[1])
        if chunk:
            outs.extend(_encode_adaptive_chunk(chunk))
        return outs
    return _encode_adaptive_chunk(jobs)


def _encode_adaptive_chunk(jobs) -> list[bytes]:
    preps = [_prep_job(j) for j in jobs]
    n_ev = np.array([len(p[2]) for p in preps], np.int64)
    base = np.concatenate(([0], np.cumsum(n_ev)))
    total = int(base[-1])

    jobvec = np.repeat(np.arange(len(jobs), dtype=np.int64), n_ev)
    fam = np.concatenate([p[1] for p in preps]) if total else \
        np.zeros(0, np.int8)
    mid = np.concatenate([p[2] for p in preps]) if total else \
        np.zeros(0, np.int64)
    sym = np.concatenate([p[3] for p in preps]) if total else \
        np.zeros(0, np.int32)

    collect = DevTriples(total)
    _evolve_families(jobvec, fam, mid, sym, [p[5] for p in preps],
                     collect)
    V, flatpos = collect.vectors()
    streams_idx = [flatpos[base[j]:base[j + 1]][p[4]]
                   for j, p in enumerate(preps)]
    payloads = rc_walk_batch_idx(streams_idx, V)
    return [p[0] + pay for p, pay in zip(preps, payloads)]


def rc_walk_streams(streams) -> list[bytes]:
    """Pass 3 for host-side (cum, freq, tot) streams: upload them as
    one triple vector and walk them like device-resident triples."""
    import jax.numpy as jnp

    lens = [len(c) for c, _f, _t in streams]
    V = tuple(jnp.asarray(np.concatenate(
        [np.asarray(st[k], np.int32) for st in streams]
        + [np.array([dflt], np.int32)]))
        for k, dflt in ((0, 0), (1, 1), (2, 2)))
    base = np.concatenate(([0], np.cumsum(lens)))
    return rc_walk_batch_idx(
        [np.arange(base[i], base[i + 1]) for i in range(len(streams))], V)


@jax.jit
def _planes_idx(Vc, Vf, Vt, idx):
    """Gather (cum, freq, tot) by event index from the device-resident
    vectors and pack the walk's P0/P1 planes; the last vector entry is
    the inactive sentinel."""
    act = idx != Vc.shape[0] - 1
    return rc_gpu.pack_planes(jnp.take(Vc, idx), jnp.take(Vf, idx),
                              jnp.take(Vt, idx), act)


def rc_walk_batch_idx(streams_idx, V) -> list[bytes]:
    """Pass 3: walk many streams given as INDEX arrays into the
    device-resident triples V.  Streams bucket by pow2 length (padding
    stays < 2x) and long buckets walk in CHUNK_T-step calls with the
    state carried across chunks.  Returns the payload bytes per
    stream."""
    from . import devtimer

    walk = (backend.bound(rc_gpu.walk_events, interpret=backend.INTERPRET)
            if backend.use_kernel() else rc_jax.walk_events)
    sentinel = int(V[0].shape[0] - 1)
    outs = [b""] * len(streams_idx)
    buckets: dict[int, list[int]] = {}
    for i, si in enumerate(streams_idx):
        if len(si) == 0:
            # an empty stream still runs finish_encode: 5 shift_lows
            # from the initial state
            outs[i] = rc_jax.finish_events(
                tuple(rc_gpu.init_state(1).T))[0]
            continue
        buckets.setdefault(fqz_model_jax.pow2(len(si)), []).append(i)

    for T2, idxs in sorted(buckets.items()):
        B = len(idxs)
        B2 = fqz_model_jax.pow2(B)
        B2 += backend.pad_rows(B2)  # mesh-divisible walk batch
        chunk = min(T2, CHUNK_T)
        Tmax = max(len(streams_idx[i]) for i in idxs)
        IDX = np.full((B2, -(-Tmax // chunk) * chunk), sentinel, np.int32)
        for r, i in enumerate(idxs):
            IDX[r, :len(streams_idx[i])] = streams_idx[i]
        state = rc_gpu.init_state(B2)
        parts: list[list[bytes]] = [[] for _ in idxs]
        for t0 in range(0, IDX.shape[1], chunk):
            P0, P1 = _planes_idx(*V, devtimer.put(IDX[:, t0:t0 + chunk]))
            ev, state = backend.row_call(walk, P0, P1, state)
            totals = devtimer.get(rc_gpu.event_totals(*ev))[:B]
            by = devtimer.get(rc_gpu.compact_events(
                *ev, outcap=backend._bucket(max(int(totals.max()), 1),
                                            lo=128))[:B])
            for r in range(B):
                parts[r].append(by[r, :totals[r]].tobytes())
        tails = rc_jax.finish_events(tuple(np.asarray(state)[:B].T))
        for r, i in enumerate(idxs):
            outs[i] = b"".join(parts[r]) + tails[r]
    return outs
