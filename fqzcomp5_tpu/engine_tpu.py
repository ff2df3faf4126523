"""Device rANS engine: device state-walks + host table prep/framing.

Produces bit-identical rANS 32x16 payloads to the native/reference
codec.  The host (C++ helpers) builds/parses frequency tables and does
the byte-level framing; the per-symbol O(n) loop runs on the device as
batched walks over (B, 32) state matrices: the kernels of
ops/rans_gpu.py on a GPU, the `lax.scan` references of ops/rans_jax.py
on the CPU.

Layout recap (rANS_static32x16pr.c):
- order-0: symbol p -> lane p%32, walked 32 at a time; the <32-byte
  remainder maps to lanes 0..rem-1 and is encoded first (here: one
  masked trailing scan step using a no-op sentinel symbol).
- order-1: lane z owns the contiguous chunk [z*isz,(z+1)*isz);
  pairs are (ctx=prev byte, sym=byte), each chunk's first byte coded
  with ctx 0; the tail (>= 32*isz) belongs to lane 31 and is walked on
  the host before/after the scan (a few bytes at most).
"""

from __future__ import annotations

import ctypes

import numpy as np

from fqzcomp5_tpu.codecs import native
from fqzcomp5_tpu.ops import rans_jax

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _lib():
    L = native.lib()
    if not hasattr(L, "_prep_registered"):
        L.fqz5_rans_o0_prep.restype = ctypes.c_int64
        L.fqz5_rans_o0_prep.argtypes = [
            _u8p, ctypes.c_uint32, _u8p, ctypes.c_uint32, _u32p]
        L.fqz5_rans_o0_dec_prep.restype = ctypes.c_int64
        L.fqz5_rans_o0_dec_prep.argtypes = [_u8p, ctypes.c_uint32, _u32p]
        L.fqz5_rans_o1_prep.restype = ctypes.c_int64
        L.fqz5_rans_o1_prep.argtypes = [
            _u8p, ctypes.c_uint32, ctypes.c_int, _u8p, ctypes.c_uint32,
            _u32p, ctypes.POINTER(ctypes.c_int)]
        L.fqz5_rans_o1_dec_prep.restype = ctypes.c_int64
        L.fqz5_rans_o1_dec_prep.argtypes = [
            _u8p, ctypes.c_uint32, _u32p, ctypes.POINTER(ctypes.c_int)]
        L._prep_registered = True
    return L


def _ptr(arr):
    return arr.ctypes.data_as(_u8p)


# ---------------------------------------------------------------------
# host table prep

def o0_prep(data: bytes):
    L = _lib()
    arr = np.frombuffer(data, np.uint8)
    tab = np.empty(2048, np.uint8)
    freqs = np.empty(256, np.uint32)
    n = L.fqz5_rans_o0_prep(_ptr(arr), len(data), _ptr(tab), 2048,
                            freqs.ctypes.data_as(_u32p))
    if n < 0:
        raise ValueError("o0 prep failed")
    return tab[:n].tobytes(), freqs


def o1_prep(data: bytes, nway: int = 32):
    L = _lib()
    arr = np.frombuffer(data, np.uint8)
    cap = 257 * 257 * 3 + 1024
    tab = np.empty(cap, np.uint8)
    freqs = np.empty(256 * 256, np.uint32)
    shift = ctypes.c_int(0)
    n = L.fqz5_rans_o1_prep(_ptr(arr), len(data), nway, _ptr(tab), cap,
                            freqs.ctypes.data_as(_u32p),
                            ctypes.byref(shift))
    if n < 0:
        raise ValueError("o1 prep failed")
    return tab[:n].tobytes(), freqs.reshape(256, 256), shift.value


# ---------------------------------------------------------------------
# Order-0 core (table + 32-way stream)

def encode_o0_core(data: bytes) -> bytes:
    if len(data) == 0:
        return b""
    tab, freqs = o0_prep(data)
    x_max, rcp, rcp_shift, bias, cmpl = rans_jax.build_enc_tables(
        freqs, rans_jax.TF_SHIFT)

    def with_nop(a, v):
        return np.concatenate([a, np.array([v], a.dtype)])
    x_max = with_nop(x_max, 0xFFFFFFFF)
    rcp = with_nop(rcp, 0)
    rcp_shift = with_nop(rcp_shift, 0)
    bias = with_nop(bias, 0)
    cmpl = with_nop(cmpl, 0)

    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    T = n // 32
    rem = n - T * 32
    main = arr[:T * 32].reshape(T, 32).astype(np.int32)
    if rem:
        pad = np.full((1, 32), 256, np.int32)
        pad[0, :rem] = arr[T * 32:]
        main = np.concatenate([main, pad], axis=0)

    Rf, words, mask = rans_jax.encode_scan(
        main[None], x_max[None], rcp[None], rcp_shift[None], bias[None],
        cmpl[None], rans_jax.TF_SHIFT)
    return tab + rans_jax.assemble_o0_stream(
        np.asarray(Rf)[0], np.asarray(words)[0], np.asarray(mask)[0])


def decode_o0_core(payload: bytes, out_sz: int) -> bytes:
    L = _lib()
    arr = np.frombuffer(payload, np.uint8)
    s3 = np.empty(1 << 12, np.uint32)
    used = L.fqz5_rans_o0_dec_prep(_ptr(arr), len(arr),
                                   s3.ctypes.data_as(_u32p))
    if used < 0:
        raise ValueError("o0 dec prep failed")
    body = arr[used:]
    R0 = body[:128].copy().view("<u4").astype(np.uint32)
    words = body[128:]
    if len(words) & 1:
        words = np.concatenate([words, np.zeros(1, np.uint8)])
    words = words.copy().view("<u2").astype(np.uint32)
    if words.size == 0:
        words = np.zeros(1, np.uint32)

    T = out_sz // 32
    rem = out_sz - T * 32
    syms, Rf, _ = rans_jax.decode_scan(words[None], R0[None], s3[None], T)
    out = np.asarray(syms)[0].reshape(-1).astype(np.uint8)
    if rem:
        Rfin = np.asarray(Rf)[0]
        tail = (s3[Rfin[:rem] & rans_jax.MASK12] & 0xFF).astype(np.uint8)
        out = np.concatenate([out, tail])
    return out[:out_sz].tobytes()


# ---------------------------------------------------------------------
# Order-1 core

def _host_put(R: int, l: int, c_ctx: int, sym: int, flat, shift: int,
              words: list) -> tuple[int, int]:
    """One reference RansEncPutSymbol on the host (tail bytes)."""
    x_max, rcp, rcp_shift, bias, cmpl = flat
    idx = c_ctx * 256 + sym
    if R > int(x_max[idx]):
        words.append(R & 0xFFFF)
        R >>= 16
    q = (R * int(rcp[idx])) >> (32 + int(rcp_shift[idx]))
    R = (R + int(bias[idx]) + q * int(cmpl[idx])) & 0xFFFFFFFF
    return R, sym


def _o1_planes(arr: np.ndarray, isz: int):
    chunks = arr[:32 * isz].reshape(32, isz)
    syms = np.empty((isz, 32), np.int32)
    ctxs = np.empty((isz, 32), np.int32)
    syms[1:, :] = chunks.T[1:]
    ctxs[1:, :] = chunks.T[:-1]
    syms[0, :] = chunks.T[0]
    ctxs[0, :] = 0
    return syms, ctxs


def encode_o1_core(data: bytes) -> bytes:
    n = len(data)
    if n < 32:
        raise ValueError("O1 32-way needs >= 32 bytes")
    tab, freqs, shift = o1_prep(data)
    x_max, rcp, rcp_shift, bias, cmpl = rans_jax.build_enc_tables(
        freqs, shift)
    flat = (x_max.reshape(-1), rcp.reshape(-1), rcp_shift.reshape(-1),
            bias.reshape(-1), cmpl.reshape(-1))

    arr = np.frombuffer(data, np.uint8)
    isz = n // 32

    # lane 31's tail walk (emitted first => highest stream addresses)
    R31 = rans_jax.RANS_L
    tail_words: list[int] = []
    lsym = int(arr[n - 1])
    for i in range(n - 2, 32 * isz - 2, -1):
        R31, lsym = _host_put(R31, lsym, int(arr[i]), lsym, flat, shift,
                              tail_words)
        lsym = int(arr[i])

    syms, ctxs = _o1_planes(arr, isz)
    R0 = np.full(32, rans_jax.RANS_L, np.uint32)
    R0[31] = R31

    Rf, words, mask = rans_jax.encode_scan_o1(
        syms[None], ctxs[None],  # (1, T, 32)
        flat[0][None], flat[1][None], flat[2][None], flat[3][None],
        flat[4][None], shift, R0[None])
    Rf = np.asarray(Rf)[0]
    w = np.asarray(words)[0].reshape(-1)
    m = np.asarray(mask)[0].reshape(-1)
    stream = (Rf.astype("<u4").tobytes()
              + w[m].astype("<u2").tobytes()
              + np.array(tail_words[::-1], "<u2").tobytes())
    return tab + stream


def decode_o1_core(payload: bytes, out_sz: int) -> bytes:
    L = _lib()
    arr = np.frombuffer(payload, np.uint8)
    shift_c = ctypes.c_int(0)
    s3 = np.empty(256 << 12, np.uint32)  # max size; shift may be 10
    used = L.fqz5_rans_o1_dec_prep(_ptr(arr), len(arr),
                                   s3.ctypes.data_as(_u32p),
                                   ctypes.byref(shift_c))
    if used < 0:
        raise ValueError("o1 dec prep failed")
    shift = shift_c.value
    tot = 1 << shift
    s3 = s3[:256 * tot]

    body = arr[used:]
    R0 = body[:128].copy().view("<u4").astype(np.uint32)
    words = body[128:]
    if len(words) & 1:
        words = np.concatenate([words, np.zeros(1, np.uint8)])
    words = words.copy().view("<u2").astype(np.uint32)
    if words.size == 0:
        words = np.zeros(1, np.uint32)

    isz = out_sz // 32
    syms, Rf, ptrf = rans_jax.decode_scan_o1(
        words[None], R0[None], s3[None], isz, shift)
    # (isz, 32) -> chunks are columns
    out = np.asarray(syms)[0].T.reshape(-1).astype(np.uint8)

    # tail: lane 31 continues on the host
    rem = out_sz - 32 * isz
    if rem:
        R = int(np.asarray(Rf)[0][31])
        ptr = int(np.asarray(ptrf)[0])
        mask = tot - 1
        last = int(out[-1]) if isz else 0
        tail = np.empty(rem, np.uint8)
        for k in range(rem):
            m = R & mask
            S = int(s3[last * tot + m])
            c = S & 0xFF
            R = (S >> (shift + 8)) * (R >> shift) + ((S >> 8) & mask)
            if R < rans_jax.RANS_L and ptr < len(words):
                R = ((R << 16) | int(words[ptr])) & 0xFFFFFFFF
                ptr += 1
            tail[k] = c
            last = c
        out = np.concatenate([out, tail])
    return out[:out_sz].tobytes()


# ---------------------------------------------------------------------
# Batched multi-stream APIs: the production path.  Many independent
# sections (blocks x {seq,qual}, stripes) walk the device together; a
# no-op sentinel row pads ragged lengths on encode, and per-stream
# active-step masks handle them on decode.

_NOP_O1 = 256 * 256    # sentinel flat index (order-1 tables: 65537 rows)


def _with_nop_row(tables):
    x_max, rcp, rcp_shift, bias, cmpl = tables
    app = lambda a, v: np.concatenate(  # noqa: E731
        [a.reshape(-1), np.array([v], a.dtype)])
    return (app(x_max, 0xFFFFFFFF), app(rcp, 0), app(rcp_shift, 0),
            app(bias, 0), app(cmpl, 0))


def _assemble_payload(head: bytes, Rf: np.ndarray, cwords: np.ndarray,
                      tail: bytes = b"") -> bytes:
    """head + 32 final states + the COMPACT word stream (+ tail)."""
    return (head + Rf.astype("<u4").tobytes()
            + cwords.astype("<u2").tobytes() + tail)


class _LazyO0:
    """Deferred encode_o0_batch: `sizes` holds every stream's framed
    payload length (tables + 128 state bytes + 2*nwords, one int32
    download per stream); fetch(idxs) downloads only the requested
    winners' words.  Trial waves walk every candidate on device but
    never download loser payloads."""

    def __init__(self, datas: list[bytes]):
        from fqzcomp5_tpu.ops import backend

        B = len(datas)
        self._sizes: list[int] | None = None
        self._tabs: list[bytes] = []
        self._lz = None
        if B == 0:
            self._sizes = []
            return
        freq_rows = []
        Tmax = 1
        for d in datas:
            tab, freqs = o0_prep(d)
            self._tabs.append(tab)
            freq_rows.append(freqs)
            n = len(d)
            T = n // 32 + (1 if n % 32 else 0)
            Tmax = max(Tmax, T)

        # u8 symbol plane + packed nop bitmask, built directly: pad
        # slots are MASKED by the nop bits, so their content is never
        # read and needs no write — the old int32 sentinel plane paid
        # ~2.8s of np.full per 24MB wave (round-5 profile)
        small = np.empty((B, Tmax, 32), np.uint8)
        nopb = np.zeros((B, Tmax, 4), np.uint8)
        for b, d in enumerate(datas):
            arr = np.frombuffer(d, np.uint8)
            n = len(arr)
            Tfull = n // 32
            small[b, :Tfull] = arr[:Tfull * 32].reshape(Tfull, 32)
            rem = n - Tfull * 32
            pad_from = Tfull
            if rem:
                small[b, Tfull, :rem] = arr[Tfull * 32:]
                row = np.zeros(32, np.uint8)
                row[rem:] = 1
                nopb[b, Tfull] = np.packbits(row, bitorder="little")
                pad_from = Tfull + 1
            if pad_from < Tmax:
                nopb[b, pad_from:] = 0xFF

        self._lz = backend.encode_u8_lazy(
            small, nopb, np.stack(freq_rows), rans_jax.TF_SHIFT)

    @property
    def sizes(self) -> list[int]:
        """Framed payload length per stream.  Lazy (round 5): the
        first read flushes the deferred walk batch, so a caller can
        build several lazy encoders under backend.deferred_walks()
        and pay ONE fused device call for all their walks+counts."""
        if self._sizes is None:
            nw = self._lz.nwords()
            self._sizes = [len(self._tabs[b]) + 128 + 2 * int(nw[b])
                           for b in range(len(self._tabs))]
        return self._sizes

    def prefetch(self, idxs) -> None:
        """Queue winner gathers (see LazyFlat.prefetch)."""
        if self._lz is not None:
            self._lz.prefetch(idxs)

    def fetch(self, idxs) -> dict[int, bytes]:
        if self._lz is None:
            return {}
        rows = self._lz.fetch(idxs)
        return {i: _assemble_payload(self._tabs[i], *rows[i])
                for i in rows}

    def fetch_all(self) -> list[bytes]:
        if self._lz is None:
            return []
        Rf, words, mask = self._lz.fetch_all()
        return [_assemble_payload(
            self._tabs[b], Rf[b],
            words[b].reshape(-1)[mask[b].reshape(-1)])
            for b in range(len(self._tabs))]


def encode_o0_batch_lazy(datas: list[bytes]) -> "_LazyO0":
    return _LazyO0(datas)


def encode_o0_batch(datas: list[bytes]) -> list[bytes]:
    """rans_compress_O0_32x16 for many streams in one device walk."""
    return _LazyO0(datas).fetch_all()


def decode_o0_batch(payloads: list[bytes], out_szs: list[int],
                    *, lazy: bool = False):
    """Batched order-0 device decode.  With lazy=True, returns a
    zero-arg finisher instead of bytes: create several finishers under
    backend.deferred_walks() and their device walks flush as ONE fused
    call at the first finish (see tpu_driver decode flush)."""
    L = _lib()
    B = len(payloads)
    if B == 0:
        return (lambda: []) if lazy else []
    s3s = np.empty((B, 1 << 12), np.uint32)
    bodies = []
    for b, p in enumerate(payloads):
        arr = np.frombuffer(p, np.uint8)
        used = L.fqz5_rans_o0_dec_prep(_ptr(arr), len(arr),
                                       s3s[b].ctypes.data_as(_u32p))
        if used < 0:
            raise ValueError("o0 dec prep failed")
        bodies.append(arr[used:])

    t_real = np.array([sz // 32 for sz in out_szs], np.int32)
    Tmax = max(int(t_real.max()), 1)

    words = np.zeros((B, max(max((len(x) - 128 + 1) // 2
                                 for x in bodies), 1)), np.uint32)
    R0 = np.empty((B, 32), np.uint32)
    for b, body in enumerate(bodies):
        R0[b], words[b, :(len(body) - 127) // 2] = _split_body(body)
    resolve = _decode_walk(words, R0, s3s, t_real, Tmax,
                           rans_jax.TF_SHIFT, order1=False)

    def _finish():
        syms, Rf, _ = resolve()
        out = []
        for b, sz in enumerate(out_szs):
            full = syms[b, :sz // 32].reshape(-1)
            rem = sz - (sz // 32) * 32
            if rem:
                tail = (s3s[b][Rf[b, :rem] & rans_jax.MASK12] & 0xFF
                        ).astype(np.uint8)
                full = np.concatenate([full, tail])
            out.append(full[:sz].tobytes())
        return out

    return _finish if lazy else _finish()


def _split_body(body: np.ndarray):
    """A 32-way rANS body -> (initial states (32,), u16 words)."""
    R0 = body[:128].copy().view("<u4")
    wb = body[128:]
    if len(wb) & 1:
        wb = np.concatenate([wb, np.zeros(1, np.uint8)])
    return R0, wb.copy().view("<u2")


def _dec_rows(words, R0, s3, t_real, *, T: int, shift: int,
              order1: bool, interpret: bool):
    from fqzcomp5_tpu.ops import rans_gpu

    syms, Rf, ptr = rans_gpu.decode_walk(
        words, R0, s3, t_real, T=T, shift=shift, order1=order1,
        interpret=interpret)
    return syms.astype(np.uint8), Rf, ptr


def _decode_walk(words, R0, s3, t_real, T: int, shift: int,
                 order1: bool):
    """Batched decode walk of B streams: (B, W) u16 words, (B, 32)
    states, (B, S) s3 LUTs, (B,) step counts.  Rows, steps and words
    pad to power-of-two buckets (pad rows: degenerate tables, zero
    steps) so waves reuse compiled shapes.  The kernel path queues
    through backend.defer (fusable with sibling batches).  Returns a
    resolver -> (syms (B, T, 32) u8, final states (B, 32), final word
    cursors (B,))."""
    from fqzcomp5_tpu.ops import backend, devtimer

    B, W = words.shape
    Bp = backend._bucket(B, lo=1)
    Bp += backend.pad_rows(Bp)
    Tb = backend._bucket(T)
    wp = np.zeros((Bp, backend._bucket(W)), np.uint32)
    wp[:B, :W] = words
    R0p = np.full((Bp, 32), rans_jax.RANS_L, np.uint32)
    R0p[:B] = R0
    s3p = np.empty((Bp, s3.shape[1]), np.uint32)
    s3p[:B] = s3
    s3p[B:] = 1 << (shift + 8)   # degenerate: sym 0, f=1
    trp = np.zeros(Bp, np.int32)
    trp[:B] = t_real
    if backend.use_kernel():
        run = backend.bound(_dec_rows, T=Tb, shift=shift, order1=order1,
                            interpret=backend.INTERPRET)
        dev = [devtimer.put(x) for x in (wp, R0p, s3p, trp)]
        d = backend.defer(lambda: (backend.row_call(run, *dev), None))

        def resolve():
            syms, Rf, ptr = backend._resolve(d)
            return (devtimer.get(syms[:B, :T]), devtimer.get(Rf[:B]),
                    devtimer.get(ptr[:B]))
        return resolve
    scan = rans_jax.decode_scan_o1 if order1 else rans_jax.decode_scan
    syms, Rf, ptr = scan(
        backend.shard_rows(wp, 1), backend.shard_rows(R0p, 1),
        backend.shard_rows(s3p, 1), Tb, shift,
        t_real=backend.shard_rows(trp))
    res = (np.asarray(syms)[:B, :T], np.asarray(Rf)[:B],
           np.asarray(ptr)[:B])
    return lambda: res


class _LazyO1:
    """Deferred encode_o1_batch (see _LazyO0): sizes without loser
    downloads.  Streams are grouped by frequency shift (10 vs 12)."""

    def __init__(self, datas: list[bytes]):
        B = len(datas)
        self._n = B
        self._sizes: list[int] | None = None
        # per shift group: (idxs, LazyFlat, {i: head}, {i: tail})
        self._groups: list[tuple] = []
        if B == 0:
            self._sizes = []
            return
        self._build(datas)

    @property
    def sizes(self) -> list[int]:
        """Lazy per-stream framed lengths (see _LazyO0.sizes)."""
        if self._sizes is None:
            sz = [0] * self._n
            for idxs, lz, heads, tailbs in self._groups:
                nw = lz.nwords()
                for g, i in enumerate(idxs):
                    sz[i] = (len(heads[i]) + 128 + 2 * int(nw[g])
                             + len(tailbs[i]))
            self._sizes = sz
        return self._sizes

    def _build(self, datas: list[bytes]) -> None:
        preps = [o1_prep(d) for d in datas]
        for group_shift in (10, 12):
            self._build_group(datas, preps, group_shift)

    def _build_group(self, datas, preps, group_shift) -> None:
        from fqzcomp5_tpu.ops import backend
        idxs = [i for i, p in enumerate(preps) if p[2] == group_shift]
        if not idxs:
            return
        R0s = []
        tails = []
        Tmax = 1
        plans = []
        for i in idxs:
            d = datas[i]
            arr = np.frombuffer(d, np.uint8)
            n = len(arr)
            isz = n // 32
            # host-walk lane 31's tail: build encoder entries ONLY for
            # the <=31 (ctx, sym) pairs the tail touches — the full
            # 65536-entry table build was the dominant per-stream prep
            # cost at large waves
            R31 = rans_jax.RANS_L
            tail_words: list[int] = []
            lo = 32 * isz - 1
            if isz == 0 and n:
                # degenerate tiny stream: keep the original scalar
                # walk (incl. its j=-1 wrap step) via full tables
                flat5 = _with_nop_row(
                    rans_jax.build_enc_tables(preps[i][1],
                                              group_shift))
                lsym = int(arr[n - 1])
                for j in range(n - 2, -2, -1):
                    fl = (int(arr[j]) * 256 + lsym)
                    if R31 > int(flat5[0][fl]):
                        tail_words.append(R31 & 0xFFFF)
                        R31 >>= 16
                    q = ((R31 * int(flat5[1][fl]))
                         >> (32 + int(flat5[2][fl])))
                    R31 = (R31 + int(flat5[3][fl])
                           + q * int(flat5[4][fl])) & 0xFFFFFFFF
                    lsym = int(arr[j])
            elif n - 1 > lo:
                ctxs = arr[lo:n - 1].astype(np.int64)
                syms = arr[lo + 1:n].astype(np.int64)
                fr = preps[i][1]
                cs = np.cumsum(fr.astype(np.uint64), axis=-1)
                f = fr[ctxs, syms].astype(np.uint64)
                start = cs[ctxs, syms] - f
                x_max = (((rans_jax.RANS_L >> group_shift) << 16) * f
                         - 1).astype(np.int64)
                cmpl = ((1 << group_shift) - f).astype(np.int64)
                big = f >= 2
                fg = np.maximum(f, 1).astype(np.float64)
                sh = np.ceil(np.log2(fg)).astype(np.uint64)
                sh = np.where((np.uint64(1) << sh) < f, sh + 1, sh)
                rcp = np.where(
                    big,
                    ((np.uint64(1) << (sh + np.uint64(31))) + f
                     - np.uint64(1)) // np.maximum(f, 1),
                    np.uint64(0xFFFFFFFF)).astype(np.int64)
                rsh = np.where(big, sh - 1, 0).astype(np.int64)
                bias = np.where(
                    big, start,
                    start + (1 << group_shift) - 1).astype(np.int64)
                for k in range(len(ctxs) - 1, -1, -1):
                    if R31 > int(x_max[k]):
                        tail_words.append(R31 & 0xFFFF)
                        R31 >>= 16
                    q = (R31 * int(rcp[k])) >> (32 + int(rsh[k]))
                    R31 = (R31 + int(bias[k])
                           + q * int(cmpl[k])) & 0xFFFFFFFF
            R0 = np.full(32, rans_jax.RANS_L, np.uint32)
            R0[31] = R31
            R0s.append(R0)
            tails.append(tail_words)
            plans.append(isz)
            Tmax = max(Tmax, isz)

        G = len(idxs)
        # only the PAD region needs the sentinel
        flat = np.empty((G, Tmax, 32), np.int32)
        for g, i in enumerate(idxs):
            arr = np.frombuffer(datas[i], np.uint8)
            isz = plans[g]
            chunks = arr[:32 * isz].reshape(32, isz).astype(np.int32)
            f = np.empty((isz, 32), np.int32)
            f[1:] = chunks.T[:-1] * 256 + chunks.T[1:]
            f[0] = chunks.T[0]  # ctx 0
            flat[g, :isz] = f
            if isz < Tmax:
                flat[g, isz:] = _NOP_O1

        freqs_g = np.stack([preps[i][1] for i in idxs])  # (G, 256, 256)
        lz = backend.encode_flat_lazy(
            flat, freqs_g, group_shift, R0=np.stack(R0s))
        heads = {i: preps[i][0] for i in idxs}
        tailbs = {i: np.array(tails[g][::-1], "<u2").tobytes()
                  for g, i in enumerate(idxs)}
        self._groups.append((idxs, lz, heads, tailbs))

    def prefetch(self, want) -> None:
        """Queue winner gathers across shift groups (LazyFlat
        prefetch semantics)."""
        for idxs, lz, heads, tailbs in self._groups:
            gpos = {i: g for g, i in enumerate(idxs)}
            sub = [gpos[i] for i in want if i in gpos]
            if sub:
                lz.prefetch(sub)

    def fetch(self, want) -> dict[int, bytes]:
        out = {}
        for idxs, lz, heads, tailbs in self._groups:
            gpos = {i: g for g, i in enumerate(idxs)}
            sub = [i for i in want if i in gpos]
            if not sub:
                continue
            rows = lz.fetch([gpos[i] for i in sub])
            for i in sub:
                out[i] = _assemble_payload(heads[i], *rows[gpos[i]],
                                           tail=tailbs[i])
        return out

    def fetch_all(self) -> list[bytes]:
        out = [b""] * self._n
        for idxs, lz, heads, tailbs in self._groups:
            Rf, words, mask = lz.fetch_all()
            for g, i in enumerate(idxs):
                out[i] = _assemble_payload(
                    heads[i], Rf[g],
                    words[g].reshape(-1)[mask[g].reshape(-1)],
                    tail=tailbs[i])
        return out


def encode_o1_batch_lazy(datas: list[bytes]) -> "_LazyO1":
    return _LazyO1(datas)


def encode_o1_batch(datas: list[bytes]) -> list[bytes]:
    """rans_compress_O1_32x16 for many streams in one device walk (see
    _LazyO1 for shift grouping and the high-entropy host path)."""
    return _LazyO1(datas).fetch_all()


def decode_o1_batch(payloads: list[bytes], out_szs: list[int],
                    *, lazy: bool = False):
    """Batched order-1 device decode (lazy: see decode_o0_batch)."""
    L = _lib()
    B = len(payloads)
    if B == 0:
        return (lambda: []) if lazy else []
    out = [b""] * B
    parsed = []
    for b, p in enumerate(payloads):
        arr = np.frombuffer(p, np.uint8)
        shift_c = ctypes.c_int(0)
        s3 = np.empty(256 << 12, np.uint32)
        used = L.fqz5_rans_o1_dec_prep(_ptr(arr), len(arr),
                                       s3.ctypes.data_as(_u32p),
                                       ctypes.byref(shift_c))
        if used < 0:
            raise ValueError("o1 dec prep failed")
        parsed.append((shift_c.value, s3[:256 << shift_c.value],
                       arr[used:]))

    group_fins = []   # (group_shift, idxs, words, s3s, tot, resolver)
    for group_shift in (10, 12):
        idxs = [i for i, p in enumerate(parsed) if p[0] == group_shift]
        if not idxs:
            continue
        G = len(idxs)
        s3s = np.stack([parsed[i][1] for i in idxs])
        Wmax = max(max((len(parsed[i][2]) - 128 + 1) // 2
                       for i in idxs), 1)
        words = np.zeros((G, Wmax), np.uint32)
        R0 = np.empty((G, 32), np.uint32)
        for g, i in enumerate(idxs):
            body = parsed[i][2]
            R0[g], words[g, :(len(body) - 127) // 2] = _split_body(body)
        t_real = np.array([out_szs[i] // 32 for i in idxs], np.int32)
        resolver = _decode_walk(words, R0, s3s, t_real,
                                max(int(t_real.max()), 1), group_shift,
                                order1=True)
        group_fins.append((group_shift, idxs, words, s3s,
                           1 << group_shift, resolver))

    def _finish():
        for group_shift, idxs, words, s3s, tot, resolver in group_fins:
            syms, Rf, ptrf = resolver()
            for g, i in enumerate(idxs):
                sz = out_szs[i]
                isz = sz // 32
                res = syms[g, :isz].T.reshape(-1).astype(np.uint8)
                rem = sz - 32 * isz
                if rem:
                    R = int(Rf[g, 31])
                    ptr = int(ptrf[g])
                    mask = tot - 1
                    last = int(res[-1]) if isz else 0
                    tail = np.empty(rem, np.uint8)
                    wrow = words[g]
                    for k in range(rem):
                        m = R & mask
                        S = int(s3s[g][last * tot + m])
                        c = S & 0xFF
                        R = ((S >> (group_shift + 8))
                             * (R >> group_shift) + ((S >> 8) & mask))
                        if R < rans_jax.RANS_L and ptr < len(wrow):
                            R = ((R << 16)
                                 | int(wrow[ptr])) & 0xFFFFFFFF
                            ptr += 1
                        tail[k] = c
                        last = c
                    res = np.concatenate([res, tail])
                out[i] = res[:sz].tobytes()
        return out

    if lazy:
        return _finish
    return _finish()
