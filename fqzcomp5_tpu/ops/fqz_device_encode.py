"""End-to-end device encode for the fqz quality codec: passes 1+2+3
of the context-sorted decomposition composed into a byte-exact
replacement for the native range-coder payload.

Pipeline (docs/DEVICE_ADAPTIVE_CODECS.md):

  host   parameter picking + selector assignment (fqz5_fqz_dump_ctx's
         serialized blob — stats-heavy, by design host work)
  pass 1 per-byte model contexts, records along rows
         (ops/fqz_ctx_jax.compute_contexts)
  merge  host: interleave the per-record overhead symbols (sel,
         4 x len byte, dup bit — native/fqzqual.cpp:698-756) with the
         quality symbols in stream order, as (model_id, symbol) pairs
  pass 2 group by model id; evolve every touched AdaptiveModel in one
         batch — per-row alphabets mix the 96-ish-symbol qual models
         with the 256/2-symbol overhead models
         (ops/fqz_model_jax.evolve)
  pass 3 un-sort the (cum, freq, tot) triples to stream order and run
         the batched range-coder walk (ops/adaptive_batch pass 3)

The result byte-matches the native fqz_compress payload after the
parameter header (tests/test_fqz_device_encode.py).  Decode stays
host-native: contexts depend on decoded output, so the decomposition
has no decode analogue.

Known padding cost: the pass-2 plane is (models, max occurrences); a
block dominated by one hot context pads the cold rows.  Worst case is
bounded by (streams x longest-context run), same order as the byte
count for fqz's 16-bit context space on real data.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import fqz_ctx_jax, fqz_model_jax

K_G_MULTI_PARAM = 1   # native/fqzqual.cpp:29
K_G_HAVE_STAB = 2

# pseudo model ids above the 16-bit qual context space
MID_LEN0 = 1 << 16
MID_SEL = MID_LEN0 + 4
MID_DUP = MID_SEL + 1


def _dup_flags(quals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """dup[r] = record r byte-equals record r-1 (fqzqual.cpp:738-745)."""
    nrec = len(lens)
    dup = np.zeros(nrec, bool)
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens
    for r in range(1, nrec):
        if lens[r] == lens[r - 1]:
            a = quals[starts[r - 1]:ends[r - 1]]
            b = quals[starts[r]:ends[r]]
            dup[r] = bool((a == b).all())
    return dup


_BASE_LUT = np.zeros(256, np.int32)  # fqzqual.cpp:195-206
for _i, _cs in enumerate((b"Cc", b"Gg", b"TtUu")):
    for _c in _cs:
        _BASE_LUT[_c] = _i + 1


def build_stream(qual: bytes, lens, sels, P, seq: bytes | None = None):
    """Merge overhead + quality symbols into one (model_id, symbol)
    stream in the native encoder's order.  Returns (mids int64,
    syms int32, n_overhead).  seq enables the kGUseSeq base-
    conditioned contexts (bbits/bloc/boff params)."""
    qa = np.frombuffer(qual, np.uint8)
    lens = np.asarray(lens, np.uint32)
    sels = np.asarray(sels, np.uint32)
    nrec = len(lens)

    pidx = (P.stab[sels] if (P.gflags & K_G_HAVE_STAB)
            else sels).astype(np.int64)
    multi = bool(P.gflags & K_G_MULTI_PARAM)
    do_sel = P.do_sel.astype(bool)
    do_dedup = P.do_dedup.astype(bool)
    fixed_len = P.fixed_len.astype(bool)
    dup = (_dup_flags(qa, lens)
           if do_dedup.any() else np.zeros(nrec, bool))

    # pass 1 on device: per-byte contexts for every record; pow2
    # padding keeps one compile per shape bucket
    Lmax = int(lens.max()) if nrec else 0
    R2 = fqz_model_jax.pow2(nrec)
    L2 = fqz_model_jax.pow2(Lmax)
    quals2d = np.zeros((R2, L2), np.uint8)
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens
    rows_f = np.repeat(np.arange(nrec), lens)
    cols_f = np.arange(len(qa)) - np.repeat(starts, lens)
    quals2d[rows_f, cols_f] = qa
    lens_p = np.pad(lens, (0, R2 - nrec))
    pidx_p = np.pad(pidx, (0, R2 - nrec)).astype(np.int32)
    sels_p = np.pad(sels, (0, R2 - nrec))
    seqkw = {}
    if seq is not None and P.bbits.any():
        codes = _BASE_LUT[np.frombuffer(seq, np.uint8)]
        bases2d = np.zeros((R2, L2), np.int32)
        boff_r = P.boff[pidx].astype(np.int64)
        nb = np.maximum(lens.astype(np.int64) - boff_r, 0)
        rows_b = np.repeat(np.arange(nrec), nb)
        intra = np.arange(int(nb.sum())) - np.repeat(
            np.cumsum(nb) - nb, nb)
        bases2d[rows_b, intra] = codes[
            np.repeat(starts + boff_r, nb) + intra]
        # native seeds from seq[off+b] for ALL b < boff, even when the
        # record is shorter than boff (it reads into the next record's
        # bases in the concatenated buffer) — native/fqzqual.cpp:727.
        # Mirror that exactly; clamp only at the end of the whole
        # buffer (the one case native leaves undefined).
        seq0 = np.zeros(R2, np.uint32)
        for k in range(int(boff_r.max(initial=0))):
            upd = k < boff_r
            bc = codes[np.minimum(starts + k, len(codes) - 1)]
            seq0[:nrec] = np.where(upd, (seq0[:nrec] << 2) | bc,
                                   seq0[:nrec])
        seqkw = dict(bases=bases2d, seq0=seq0,
                     bbits=P.bbits, bloc=P.bloc)
    cj, qj = fqz_ctx_jax.compute_contexts(
        quals2d, lens_p, pidx_p, sels_p,
        P.qmap, P.qtab, P.ptab, P.dtab,
        P.qshift, P.qmask, P.qloc, P.sloc, P.context, **seqkw)
    cj = np.asarray(cj)[:nrec]
    qj = np.asarray(qj)[:nrec]

    # vectorised merge: per-record event counts -> prefix offsets ->
    # scatter each event class into its slots (the encoder tests
    # do_sel on the PREVIOUS record's pm, fqzqual.cpp:700)
    prev_p = np.concatenate(([0], pidx[:-1]))
    sel_emit = do_sel[prev_p] | multi
    len_emit = ~fixed_len[pidx]
    if nrec:
        len_emit[0] = True  # st.first_len
    dup_emit = do_dedup[pidx]
    qual_cnt = np.where(dup, 0, lens.astype(np.int64))
    per_rec = (sel_emit + 4 * len_emit + dup_emit).astype(np.int64) \
        + qual_cnt
    offs = np.concatenate(([0], np.cumsum(per_rec)))
    w = int(offs[-1])
    mids = np.empty(w, np.int64)
    syms = np.empty(w, np.int32)

    pos = offs[:-1].copy()
    ridx = np.flatnonzero(sel_emit)
    mids[pos[ridx]] = MID_SEL
    syms[pos[ridx]] = sels[ridx]
    pos += sel_emit
    ridx = np.flatnonzero(len_emit)
    for k in range(4):
        mids[pos[ridx] + k] = MID_LEN0 + k
        syms[pos[ridx] + k] = (lens[ridx].astype(np.int64)
                               >> (8 * k)) & 0xFF
    pos += 4 * len_emit
    ridx = np.flatnonzero(dup_emit)
    mids[pos[ridx]] = MID_DUP
    syms[pos[ridx]] = dup[ridx]
    pos += dup_emit
    # quality bytes: rows expand to ragged runs at each record's pos
    ridx = np.repeat(np.arange(nrec), qual_cnt)
    kidx = np.arange(len(ridx)) - np.repeat(
        np.cumsum(qual_cnt) - qual_cnt, qual_cnt)
    tgt = pos[ridx] + kidx
    mids[tgt] = cj[ridx, kidx]
    syms[tgt] = qj[ridx, kidx]
    n_qual = int(qual_cnt.sum())
    return mids, syms, w - n_qual


def encode_payload(qual: bytes, lens, sels, P,
                   seq: bytes | None = None) -> bytes:
    """Device range-coder payload for one fqz block (everything after
    the native header: put_uv(in_size) + store_parameters)."""
    from .adaptive_batch import _evolve_run, rc_walk_streams

    mids, syms, _ = build_stream(qual, lens, sels, P, seq=seq)

    # per-model alphabet sizes (Models::init, fqzqual.cpp:185-192)
    g = fqz_model_jax.group_stream(mids, syms)
    uniq = g[0]
    ms = np.where(uniq < MID_LEN0, P.max_sym + 1,
                  np.where(uniq < MID_SEL, 256,
                           np.where(uniq == MID_SEL, P.max_sel + 1,
                                    2))).astype(np.int32)
    n = len(mids)
    out = (np.zeros(n, np.uint32), np.zeros(n, np.uint32),
           np.zeros(n, np.uint32))
    # the 256-symbol length-byte models need the wide (256-lane)
    # variant; everything else fits the single-register 128-lane one
    for wide in (False, True):
        rows = (ms > 128) == wide
        if not rows.any():
            continue

        fqz_model_jax.evolve_grouped(
            g, _evolve_run(ms, 256 if wide else 128),
            rows=np.flatnonzero(rows), out=out)
    return rc_walk_streams([out])[0]


def prepare_fqz(qual: bytes, lens, flags, seq_buf: bytes | None,
                strat: int):
    """Host half of the fqz device encode: parameter picking, selector
    assignment and wire header via fqz5_fqz_prepare.  Returns
    (header_bytes, FqzParams, sels)."""
    from ..codecs import native

    L = native.lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    qa = np.frombuffer(qual, np.uint8)
    la = np.ascontiguousarray(lens, np.uint32)
    fl = np.array(flags, np.uint32)  # mutated by stats; pass a copy
    nrec = len(la)
    hdr = np.zeros(4096, np.uint8)
    hlen = np.zeros(1, np.uint32)
    par = np.zeros(4 + 256 + 256 * (13 + 256 + 256 + 1024 + 256),
                   np.uint32)
    sels = np.zeros(max(nrec, 1), np.uint32)
    if seq_buf is None:
        seqp = None
    else:
        sa = np.frombuffer(seq_buf, np.uint8)
        seqp = sa.ctypes.data_as(u8p)
    rc = L.fqz5_fqz_prepare(
        qa.ctypes.data_as(u8p), len(qa), la.ctypes.data_as(u32p),
        fl.ctypes.data_as(u32p), nrec, strat, seqp,
        hdr.ctypes.data_as(u8p), len(hdr), hlen.ctypes.data_as(u32p),
        par.ctypes.data_as(u32p), len(par), sels.ctypes.data_as(u32p))
    if rc < 0:
        raise ValueError("fqz_prepare failed")
    P = fqz_ctx_jax.FqzParams.parse(par[:rc])
    return hdr[:int(hlen[0])].tobytes(), P, sels[:nrec]


def fqz_compress_device(qual: bytes, lens, flags,
                        seq_buf: bytes | None, strat: int) -> bytes:
    """Drop-in for codecs.host.fqz_compress with the range-coder
    payload produced on device (byte-identical output).  Routed
    through the cross-block batch machinery with a single job so one
    implementation serves both the host driver and the wave engine."""
    from .adaptive_batch import encode_adaptive_batch

    return encode_adaptive_batch(
        [("fqz", qual, lens, flags, seq_buf, strat)])[0]
