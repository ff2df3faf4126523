"""Device placement and kernel choice for the batched walks.

The kernel for a walk follows the platform of the device it runs on:
on a GPU the Pallas (Triton route) kernels of ops/rans_gpu.py,
ops/model_gpu.py and ops/rc_gpu.py; on the CPU (tests) the plain `lax`
references they are checked against.  Both produce identical bits.
Under an installed mesh every kernel call runs as a shard_map over its
row axis (rows are independent streams), so one card or four use the
same kernels.
"""

from __future__ import annotations

import functools
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, ".jax_cache")

# Tests set this to run the Hopper kernels through the Pallas
# interpreter on the CPU.
INTERPRET = False


def _bucket(n: int, lo: int = 64) -> int:
    """Round up to a power of two (>= lo): each distinct shape compiles
    once, so waves of varying block counts and lengths land on a small
    set of shapes."""
    b = lo
    while b < n:
        b <<= 1
    return b


_mesh = None


def set_mesh(mesh) -> None:
    """Install a jax.sharding.Mesh for the batched walks: leading (row)
    dims of the device batches shard over ALL mesh axes (dp x sp
    flattened — every row is an independent stream, the reference's
    thread-pool data parallelism).  Stripe sub-streams are laid out
    contiguously per section by the wave driver, so the N stripes of
    one section land on adjacent devices — the sp-axis neighbours
    (SURVEY.md §5 long-context analog).  Pass None to go back to
    single-device placement."""
    global _mesh
    _mesh = mesh


def shard_rows(arr, extra_dims: int = 0):
    """device_put with the leading dim sharded over the mesh (no-op
    without one).  The caller must have padded dim 0 to a multiple of
    mesh.size (see pad_rows)."""
    if _mesh is None:
        from fqzcomp5_tpu.ops import devtimer

        return devtimer.put(arr) if devtimer.enabled else arr
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    spec = PartitionSpec(_mesh.axis_names, *([None] * extra_dims))
    return jax.device_put(arr, NamedSharding(_mesh, spec))


def pad_rows(n: int) -> int:
    """Rows needed so dim 0 divides the mesh (0 without a mesh)."""
    if _mesh is None:
        return 0
    return (-n) % _mesh.size


# ---------------------------------------------------------------------
# Platform, kernel choice, compile cache

def walk_platform() -> str:
    """Platform of the devices the walks run on."""
    if _mesh is not None:
        return _mesh.devices.flat[0].platform
    import jax

    return jax.devices()[0].platform


def use_kernel() -> bool:
    """Hopper kernels on a GPU (or interpreted, in tests); the plain
    lax references elsewhere."""
    return INTERPRET or walk_platform() == "gpu"


def init_device() -> None:
    """Set up the device engine (`-e tpu`): the persistent compile
    cache, then a device check.  The engine refuses to run on a CPU
    device unless JAX_PLATFORMS names `cpu` on purpose (tests,
    rehearsals); a missing GPU must not pass for a slow success."""
    import jax

    ensure_compile_cache()
    dev = jax.devices()[0]
    asked = os.environ.get("JAX_PLATFORMS", "").lower().split(",")
    if dev.platform == "cpu" and "cpu" not in asked:
        raise ValueError(
            "the device engine (-e tpu) found no GPU: JAX's first device "
            "is a CPU (set JAX_PLATFORMS=cpu to run it there on "
            "purpose)")


def ensure_compile_cache() -> None:
    """JAX's persistent compilation cache: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it; nothing is set here), otherwise the
    git-ignored .jax_cache directory of the checkout."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


@functools.lru_cache(maxsize=None)
def bound(fn, **static):
    """functools.partial, cached: a stable callable per (fn, static
    args) lets row_call's jit cache hit across calls."""
    return functools.partial(fn, **static)


@functools.lru_cache(maxsize=None)
def _row_runner(fn, mesh):
    import jax

    if mesh is None or mesh.size == 1:
        return jax.jit(fn)
    from jax.sharding import PartitionSpec

    spec = PartitionSpec(mesh.axis_names)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=spec, check_vma=False))


def row_call(fn, *args):
    """Run fn over row-leading arrays.  Under a mesh of more than one
    device it runs as a shard_map over the rows: each device walks its
    own streams, with no collective.  Rows must divide the mesh (see
    pad_rows)."""
    return _row_runner(fn, _mesh)(*args)


# ---------------------------------------------------------------------
# Deferred dispatch: the wave engine queues every walk and gather of a
# wave segment and flushes them together, downloading the small
# per-stream results (word counts) of the whole segment in one
# transfer.  Each deferred fn returns (out_tree, small | None).

class Deferred:
    __slots__ = ("fn", "out", "small")

    def __init__(self, fn):
        self.fn = fn
        self.out = None      # device output tree after flush
        self.small = None    # numpy small-download slice after flush


_dq: list[Deferred] = []
_defer_depth = 0


class deferred_walks:
    """Context manager: inside it, walk dispatches queue instead of
    executing.  The queue flushes at the first result access (nwords /
    fetch / out), NOT at context exit — so a caller can create many
    lazy encoders in the context and read sizes after."""

    def __enter__(self):
        global _defer_depth
        _defer_depth += 1
        return self

    def __exit__(self, *exc):
        global _defer_depth
        _defer_depth -= 1
        return False


def defer_active() -> bool:
    return _defer_depth > 0


def defer(fn) -> Deferred:
    d = Deferred(fn)
    _dq.append(d)
    if not defer_active():
        flush_deferred()
    return d


def flush_deferred() -> None:
    """Dispatch every queued fn; download all declared small results
    in ONE transfer."""
    global _dq
    if not _dq:
        return
    import jax.numpy as jnp

    from fqzcomp5_tpu.ops import devtimer

    qs, _dq = _dq, []

    def _all():
        smalls = []
        for q in qs:
            o, s = q.fn()
            q.out = o   # visible immediately: a later fn in this
            # batch may _resolve an earlier entry
            if s is not None and (s.ndim != 1
                                  or s.dtype != jnp.int32):
                s = s.reshape(-1).astype(jnp.int32)
            smalls.append(s)
        cat = (jnp.concatenate([s for s in smalls if s is not None])
               if any(s is not None for s in smalls) else None)
        # outs ride in the return tree so devtimer.compute's single
        # block_until_ready covers every dispatched walk/gather
        return smalls, cat, [q.out for q in qs]

    smalls, cat_d, _outs = devtimer.compute(_all)
    cat = devtimer.get(cat_d) if cat_d is not None else None
    off = 0
    for q, s in zip(qs, smalls):
        if s is not None:
            n = int(s.shape[0])
            q.small = cat[off:off + n]
            off += n


def _resolve(d):
    """Deferred -> its device outputs (flushing if still queued)."""
    if d.out is None:
        flush_deferred()
    return d.out


# ---------------------------------------------------------------------
# rANS encode walk

def build_packed_tables(freqs: np.ndarray, shift: int) -> np.ndarray:
    """(B, S+1) uint32 tables of (f << shift) | start, the encode
    kernel's per-symbol entry.

    freqs: (B, ..., 256) where each trailing 256-row is one context's
    frequency table normalised to sum 1<<shift (order-0: (B, 256);
    order-1: (B, 256, 256) — starts are per-context cumsums).  Index S
    is the identity sentinel (f = 1<<shift, start = 0), which pads
    ragged streams."""
    freqs = np.atleast_2d(freqs).astype(np.int64)
    B = freqs.shape[0]
    start = np.cumsum(freqs, axis=-1) - freqs
    packed = ((freqs << shift) | start).reshape(B, -1)
    out = np.empty((B, packed.shape[1] + 1), np.uint32)
    out[:, :-1] = packed
    out[:, -1] = 1 << (2 * shift)
    return out


def _enc_rows(idx, pt, R0, *, shift: int, interpret: bool):
    """Per-row encode: gather the table plane, walk, count words."""
    import jax.numpy as jnp

    from fqzcomp5_tpu.ops import rans_gpu

    B, T, n = idx.shape
    P = jnp.take_along_axis(pt, idx.reshape(B, -1), axis=1).reshape(
        B, T, n)
    Rf, out = rans_gpu.encode_walk(P, R0, shift=shift,
                                   interpret=interpret)
    nw = ((out >> 16) != 0).sum((1, 2), dtype=jnp.int32)
    return Rf, out, nw


def _enc_rows_u8(small, nopb, pt, R0, *, shift: int, interpret: bool):
    """_enc_rows from u8 symbols + a packed no-op bitmask (order 0)."""
    import jax.numpy as jnp

    B, T, n = small.shape
    bits = (nopb[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    nop = bits.reshape(B, T, -1)[..., :n] != 0
    idx = jnp.where(nop, pt.shape[1] - 1, small.astype(jnp.int32))
    return _enc_rows(idx, pt, R0, shift=shift, interpret=interpret)


def _encode_dev(plane, nopb, pt, shift: int, R0, B: int, T: int):
    """Queue the kernel encode of (B, T, 32) streams.  plane is u8
    symbols with a nop bitmask (nopb) or int32 table indices (nopb
    None, sentinel = last table entry).  Rows and steps are padded to
    power-of-two buckets (pad rows and steps are identity no-ops) so
    waves reuse compiled shapes.  Returns the Deferred ((Rf, out),
    nwords)."""
    S = pt.shape[1] - 1
    Bp = _bucket(B, lo=1)
    Bp += pad_rows(Bp)
    Tb = _bucket(T)
    padw = ((0, Bp - B), (0, Tb - T), (0, 0))
    R0p = np.full((Bp, 32), 1 << 15, np.uint32)
    if R0 is not None:
        R0p[:B] = R0
    ptp = np.empty((Bp, S + 1), np.uint32)
    ptp[:B] = pt
    ptp[B:] = 1 << (2 * shift)
    if nopb is None:
        args = (np.pad(plane.astype(np.int32), padw, constant_values=S),)
        fn = _enc_rows
    else:
        args = (np.pad(plane, padw),
                np.pad(nopb, padw, constant_values=0xFF))
        fn = _enc_rows_u8
    run = bound(fn, shift=shift, interpret=INTERPRET)
    from fqzcomp5_tpu.ops import devtimer

    dev = [devtimer.put(a) for a in args + (ptp, R0p)]

    def _fn():
        Rf, out, nw = row_call(run, *dev)
        return (Rf, out), nw[:B]

    return defer(_fn)


@functools.lru_cache(maxsize=None)
def _gather_compact_jit():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("outcap",))
    def run(out, sel, Rf, *, outcap: int):
        """Gather winner streams from the walk's (B, T, 32) plane and
        squeeze out the no-op word slots on the device: the download is
        2 bytes per emitted word (the compressed payload)."""
        wf = jnp.take(out, sel, axis=0).reshape(sel.shape[0], -1)
        mask = (wf >> 16) != 0
        dst = jnp.where(mask, jnp.cumsum(mask, axis=1) - 1, outcap)
        words = jax.vmap(lambda d, w: jnp.zeros(outcap, jnp.uint16)
                         .at[d].set(w, mode="drop"))(
            dst, (wf & 0xFFFF).astype(jnp.uint16))
        return words, jnp.take(Rf, sel, axis=0)

    return run


class LazyFlat:
    """Deferred encode-walk results.

    The trial waves need every candidate's COMPRESSED SIZE to pick a
    winner, but only the winner's bytes.  A LazyFlat keeps the walk
    results device-resident: nwords() downloads one int32 per stream,
    fetch(idxs) gathers only the chosen rows.  Results of the CPU
    reference walk are held as numpy (fetch is free).  parts:
    (rows, "dev", Deferred) or (rows, "np", (Rf, words, mask))."""

    def __init__(self, B: int, T: int, n: int):
        self.B, self.T, self.n = B, T, n
        self.parts: list[tuple[np.ndarray, str, object]] = []
        self._nw: np.ndarray | None = None
        self._pf: dict = {}   # (part_idx, idx_key) -> Deferred gather

    def _add_np(self, rows, Rf, words, mask) -> None:
        self.parts.append((np.asarray(rows, np.int64), "np",
                           (Rf, words, mask)))

    def _add_dev(self, rows, deferred) -> None:
        """deferred: a Deferred whose out is (Rf_d, out_d) and whose
        small download is the per-stream nwords."""
        self.parts.append((np.asarray(rows, np.int64), "dev",
                           deferred))

    def nwords(self) -> np.ndarray:
        """(B,) emitted-word count per stream (defines payload size:
        tables + 128 state bytes + 2*nwords).  Device parts got their
        counts in the flush's single fused download."""
        if self._nw is not None:
            return self._nw
        nw = np.zeros(self.B, np.int64)
        for rows, kind, pay in self.parts:
            if kind == "np":
                nw[rows] = pay[2].reshape(len(rows), -1).sum(1)
            else:
                if pay.small is None:
                    flush_deferred()
                nw[rows] = pay.small.astype(np.int64)
        self._nw = nw
        return nw

    def _gather_deferred(self, pidx, pay, pos, want, nw_all):
        """Queue the winner gather for one device part; returns the
        Deferred (cached per (part, index-set) so prefetch + fetch
        share one dispatch)."""
        import jax.numpy as jnp

        key = (pidx, tuple(int(i) for i in want))
        if key in self._pf:
            return self._pf[key]
        sel = np.array([pos[int(i)] for i in want], np.int32)
        pad = _bucket(len(sel), lo=1) - len(sel)
        selp = np.concatenate(
            [sel, np.full(pad, sel[-1], sel.dtype)]) if pad else sel
        outcap = _bucket(max(max(int(nw_all[int(i)]) for i in want), 1))
        sel_d = jnp.asarray(selp)

        def _fn():
            Rf_d, out_d = _resolve(pay)
            return _gather_compact_jit()(out_d, sel_d, Rf_d,
                                         outcap=outcap), None

        d = defer(_fn)
        self._pf[key] = d
        return d

    def prefetch(self, idxs) -> None:
        """Queue the gathers for fetch(idxs) WITHOUT flushing: call it
        on several LazyFlats under backend.deferred_walks() and all
        their winner gathers run in one fused device call at the first
        fetch."""
        nw_all = self.nwords()
        for pidx, (rows, kind, pay) in enumerate(self.parts):
            if kind != "dev":
                continue
            pos = {int(r): j for j, r in enumerate(rows)}
            want = [i for i in idxs if int(i) in pos]
            if want:
                self._gather_deferred(pidx, pay, pos, want, nw_all)

    def fetch(self, idxs) -> dict[int, tuple]:
        """idx -> (Rf (32,) u32, words (nwords,) COMPACT) for the
        requested streams only."""
        from fqzcomp5_tpu.ops import devtimer

        out: dict[int, tuple] = {}
        nw_all = self.nwords()
        for pidx, (rows, kind, pay) in enumerate(self.parts):
            pos = {int(r): j for j, r in enumerate(rows)}
            want = [i for i in idxs if int(i) in pos]
            if not want:
                continue
            if kind == "np":
                Rf, words, mask = pay
                for i in want:
                    j = pos[int(i)]
                    cw = words[j].reshape(-1)[mask[j].reshape(-1)]
                    out[i] = (np.asarray(Rf[j], np.uint32),
                              np.asarray(cw, np.uint32))
            else:
                d = self._gather_deferred(pidx, pay, pos, want, nw_all)
                cw_d, Rf_d = _resolve(d)
                cw = devtimer.get(cw_d[:len(want)])
                Rf = devtimer.get(Rf_d[:len(want)])
                for j, i in enumerate(want):
                    out[i] = (Rf[j].astype(np.uint32),
                              cw[j, :int(nw_all[int(i)])]
                              .astype(np.uint32))
        return out

    def fetch_all(self):
        """Materialise every stream (the eager encode_flat contract)."""
        from fqzcomp5_tpu.ops import devtimer

        Rf = np.empty((self.B, self.n), np.uint32)
        words = np.empty((self.B, self.T, self.n), np.uint32)
        mask = np.empty((self.B, self.T, self.n), bool)
        for rows, kind, pay in self.parts:
            if kind == "np":
                r0, w0, m0 = pay
            else:
                Rf_d, out_d = _resolve(pay)
                r0 = devtimer.get(Rf_d)[:len(rows)]
                o = devtimer.get(out_d)[:len(rows), :self.T]
                w0, m0 = o & 0xFFFF, (o >> 16) != 0
            Rf[rows] = r0
            words[rows] = w0.astype(np.uint32)
            mask[rows] = m0
        return Rf, words, mask


def encode_flat(flat: np.ndarray, freqs: np.ndarray, shift: int,
                R0: np.ndarray | None = None):
    """Run the reversed encode walk over (B, T, 32) flat table indices.

    freqs: (B, S) rows normalised to sum 1<<shift (S=256 for order-0,
    65536 for order-1); index S is the no-op sentinel.  Returns numpy
    (Rf (B,32) uint32, words (B,T,32) uint32, mask (B,T,32) bool)."""
    return encode_flat_lazy(flat, freqs, shift, R0).fetch_all()


def encode_u8_lazy(small: np.ndarray, nopb: np.ndarray,
                   freqs: np.ndarray, shift: int,
                   R0: np.ndarray | None = None) -> LazyFlat:
    """encode_flat_lazy for order-0 streams whose (u8 symbols, packed
    nop bitmask) planes are pre-built by the caller: the kernel path
    uploads them as-is (pad slots' CONTENT is never read — the nop
    bits mask them — so callers may leave pad data uninitialised); the
    reference path rebuilds the int32 sentinel plane."""
    B, T, n = small.shape
    if use_kernel():
        lz = LazyFlat(B, T, n)
        lz._add_dev(np.arange(B), _encode_dev(
            small, nopb, build_packed_tables(freqs, shift), shift, R0, B,
            T))
        return lz
    S = int(np.prod(freqs.shape[1:]))
    flat = small.astype(np.int32)
    mask = np.unpackbits(nopb, axis=-1,
                         bitorder="little").astype(bool)[:, :, :n]
    flat[mask] = S
    return encode_flat_lazy(flat, freqs, shift, R0)


def encode_flat_lazy(flat: np.ndarray, freqs: np.ndarray, shift: int,
                     R0: np.ndarray | None = None) -> LazyFlat:
    """encode_flat, but results stay device-resident behind a LazyFlat
    so trial waves can read candidate sizes without downloading loser
    payloads (see LazyFlat)."""
    B, T, n = flat.shape
    lz = LazyFlat(B, T, n)
    allr = np.arange(B)
    if use_kernel():
        lz._add_dev(allr, _encode_dev(
            flat, None, build_packed_tables(freqs, shift), shift, R0, B,
            T))
        return lz

    from fqzcomp5_tpu.ops import rans_jax

    tt = rans_jax.build_enc_tables(freqs, shift)
    app = lambda a, v: np.concatenate(  # noqa: E731
        [a.reshape(B, -1), np.full((B, 1), v, a.dtype)], axis=1)
    x_max = app(tt[0], 0xFFFFFFFF)
    rcp = app(tt[1], 0)
    rsh = app(tt[2], 0)
    bias = app(tt[3], 0)
    cmpl = app(tt[4], 0)
    R0j = None if R0 is None else np.asarray(R0, np.uint32)

    pad = pad_rows(B)
    if pad:
        # sentinel rows (nop index everywhere) so the row count
        # divides the mesh; their walks emit nothing and are dropped
        S = x_max.shape[1] - 1  # nop table row
        flat = np.concatenate(
            [flat, np.full((pad,) + flat.shape[1:], S, flat.dtype)])
        x_max, rcp, rsh, bias, cmpl = (
            np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            for a in (x_max, rcp, rsh, bias, cmpl))
        if R0j is not None:
            R0j = np.concatenate(
                [R0j, np.full((pad,) + R0j.shape[1:],
                              rans_jax.RANS_L, R0j.dtype)])
    flat_d = shard_rows(flat.astype(np.int32), extra_dims=2)
    tabs_d = [shard_rows(a, extra_dims=1)
              for a in (x_max, rcp, rsh, bias, cmpl)]
    R0d = None if R0j is None else shard_rows(R0j, extra_dims=1)
    Rf, words, mask = rans_jax.encode_scan_flat(
        flat_d, *tabs_d, R0d)
    lz._add_np(allr, np.asarray(Rf)[:B],
               np.asarray(words)[:B].astype(np.uint32),
               np.asarray(mask)[:B].astype(bool))
    return lz
