"""Smoke run of the device engine (`-e tpu`) on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--mb 256]
    python chip_smoke.py --chips 4        # the 4-card mesh path only

One JAX process, phases in order; any failure exits non-zero:

1. rebuild the native library from the committed sources;
2. print the card (name, power limit), the JAX version and XLA_FLAGS,
   and require a GPU;
3. compile each Hopper kernel (rANS encode, rANS decode O0/O1, pass-2
   model evolution, pass-3 range coder) at the smoke's real widths,
   print its memory analysis, time it, and require exact equality
   with its plain `lax` reference (on a prefix of T) and a round trip
   at full T;
4. generate an IonTorrent-shaped corpus from --seed (bench.gen_corpus);
5. at -1 and -5: encode with `-e tpu` through cli.main, decode with
   `-e tpu -d` and with the host engine, byte-compare both with the
   input;
6. print each phase's wall time beside the card, and the number of
   compilations inside the timed phases.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


class Phases:
    """Wall time per phase, printed with the card beside it."""

    def __init__(self, card: str):
        self.card = card
        self.rows: list[tuple[str, float]] = []

    def run(self, name: str, fn, *a, **k):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        dt = time.perf_counter() - t0
        self.rows.append((name, dt))
        print(f"   {name}: {dt:.3f} s on {self.card}", flush=True)
        return out


# ---------------------------------------------------------------------
# phase 3: kernels against their references

def _compiled(name, fn, *args):
    import jax

    c = jax.jit(fn).lower(*args).compile()
    print(f"   {name} memory_analysis: {c.memory_analysis()}")
    return c


def _timed(c, *args, reps=3):
    import jax

    jax.block_until_ready(c(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(c(*args))
    return out, (time.perf_counter() - t0) / reps


def _need(cond, what):
    if not cond:
        raise AssertionError(what)


def _rand_freqs(rng, rows, nsym, shift):
    import numpy as np

    tot = 1 << shift
    f = rng.integers(1, 100, (rows, nsym)).astype(np.float64)
    f = np.floor(f / f.sum(1, keepdims=True) * (tot - nsym)).astype(
        np.int64) + 1
    f[:, 0] += tot - f.sum(1)
    out = np.zeros((rows, 256), np.int64)
    out[:, :nsym] = f
    return out


def _enc_planes(freqs, flat, shift):
    """Table plane (f << shift | start) gathered for flat indices."""
    import numpy as np

    B = flat.shape[0]
    start = np.cumsum(freqs, -1) - freqs
    pt = ((freqs << shift) | start).reshape(B, -1)
    pt = np.concatenate([pt, np.full((B, 1), 1 << (2 * shift))], 1)
    return np.take_along_axis(pt.astype(np.uint32), flat.reshape(B, -1),
                              1).reshape(flat.shape)


def _assemble(out):
    """Walk output plane -> per-stream compact word rows (B, W)."""
    import numpy as np

    B = out.shape[0]
    mask = (out >> 16) != 0
    rows = [out[b][mask[b]] & 0xFFFF for b in range(B)]
    W = max(max(len(r) for r in rows), 1)
    words = np.zeros((B, W), np.uint32)
    for b, r in enumerate(rows):
        words[b, :len(r)] = r
    return words


def check_rans(rng, B, T, Tp, order1, report):
    """K1 + K2: encode at (B, T) with the kernel, decode back, compare
    each with rans_jax at the (B, Tp) prefix."""
    import jax.numpy as jnp
    import numpy as np

    from fqzcomp5_tpu.ops import rans_gpu, rans_jax

    shift = 12
    nsym = 4 if order1 else 46
    tag = "o1" if order1 else "o0"
    if order1:
        fr = _rand_freqs(rng, B * 256, nsym, shift).reshape(B, 256, 256)
    else:
        fr = _rand_freqs(rng, B, nsym, shift)
    sym = rng.integers(0, nsym, (B, T, 32))
    if order1:
        ctx = np.concatenate([np.zeros((B, 1, 32), np.int64),
                              sym[:, :-1]], 1)
        flat = ctx * 256 + sym
        s3 = rans_jax.build_s3(fr, shift).reshape(B, -1)
    else:
        flat = sym
        s3 = rans_jax.build_s3(fr, shift)
    R0 = np.full((B, 32), rans_jax.RANS_L, np.uint32)

    def enc(P, R):
        return rans_gpu.encode_walk(P, R, shift=shift)

    def dec(w, R, s, tr, T):
        return rans_gpu.decode_walk(w, R, s, tr, T=T, shift=shift,
                                    order1=order1)

    # full T: kernel encode, kernel decode, round trip
    P = jnp.asarray(_enc_planes(fr, flat, shift))
    ce = _compiled(f"rans_encode_walk_{tag}", enc, P, jnp.asarray(R0))
    (Rf, out), te = _timed(ce, P, jnp.asarray(R0))
    Rf, out = np.asarray(Rf), np.asarray(out)
    words = jnp.asarray(_assemble(out))
    tr = jnp.full((B,), T, jnp.int32)
    cd = _compiled(f"rans_decode_walk_{tag}", lambda w, R, s, t: dec(
        w, R, s, t, T), words, jnp.asarray(Rf), jnp.asarray(s3), tr)
    (syms, _, _), td = _timed(cd, words, jnp.asarray(Rf),
                              jnp.asarray(s3), tr)
    _need(np.array_equal(np.asarray(syms), sym),
          f"rans {tag} round trip at T={T}")
    report[f"rans_encode_{tag}"] = (B, T, te)
    report[f"rans_decode_{tag}"] = (B, T, td)

    # prefix: kernel == plain reference, bit for bit
    fl_p = flat[:, :Tp].astype(np.int32)
    tt = rans_jax.build_enc_tables(fr, shift)
    app = lambda a, v: np.concatenate(  # noqa: E731
        [a.reshape(B, -1), np.full((B, 1), v, a.dtype)], 1)
    tabs = [jnp.asarray(app(a, v)) for a, v in
            zip(tt, (0xFFFFFFFF, 0, 0, 0, 0))]
    ref = jax_ref_time(rans_jax.encode_scan_flat, jnp.asarray(fl_p),
                       *tabs)
    (Rr, wr, mr), tref = ref
    Pp = jnp.asarray(_enc_planes(fr, fl_p, shift))
    Rk, ok_ = (np.asarray(x) for x in enc(Pp, jnp.asarray(R0)))
    Rr, wr, mr = (np.asarray(x) for x in (Rr, wr, mr))
    _need(np.array_equal(Rk, Rr) and np.array_equal((ok_ >> 16) != 0, mr)
          and np.array_equal((ok_ & 0xFFFF)[mr], wr[mr]),
          f"rans encode {tag} kernel != encode_scan_flat")
    wp = jnp.asarray(_assemble(ok_))
    trp = jnp.full((B,), Tp, jnp.int32)
    dref = rans_jax.decode_scan_o1 if order1 else rans_jax.decode_scan
    (sr, Rr2, pr), tdref = jax_ref_time(
        lambda w, R, s: dref(w, R, s, T=Tp, shift=shift, t_real=trp),
        wp, jnp.asarray(Rk), jnp.asarray(s3))
    sk, Rk2, pk = (np.asarray(x) for x in dec(wp, jnp.asarray(Rk),
                                              jnp.asarray(s3), trp, Tp))
    _need(np.array_equal(sk, np.asarray(sr)) and
          np.array_equal(Rk2, np.asarray(Rr2)) and
          np.array_equal(pk, np.asarray(pr)),
          f"rans decode {tag} kernel != reference")
    report[f"rans_encode_{tag}_ref"] = (B, Tp, tref)
    report[f"rans_decode_{tag}_ref"] = (B, Tp, tdref)


def jax_ref_time(fn, *args):
    """Run a plain-XLA reference once to compile, once timed."""
    import jax

    c = jax.jit(fn).lower(*args).compile()
    jax.block_until_ready(c(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(c(*args))
    return out, time.perf_counter() - t0


def check_evolve(rng, C, T, Tp, lanes, report):
    """K3 at (C, T); prefix Tp against fqz_model_jax.evolve."""
    import jax.numpy as jnp
    import numpy as np

    from fqzcomp5_tpu.ops import fqz_model_jax, model_gpu

    ms = 46 if lanes == 128 else 200
    sym = jnp.asarray(rng.integers(0, ms, (C, T)).astype(np.int32))
    cnt = jnp.full((C,), T, jnp.int32)
    msv = jnp.full((C,), ms, jnp.int32)

    def kern(s, c, m):
        return model_gpu.evolve_walk(s, c, m, lanes=lanes)

    ck = _compiled(f"model_evolve_walk_{C}x{T}_l{lanes}", kern, sym, cnt,
                   msv)
    got, tk = _timed(ck, sym, cnt, msv)
    (want), tref = jax_ref_time(
        lambda s, c, m: fqz_model_jax.evolve(s, c, m, jnp.int32(16),
                                             lanes=lanes),
        sym[:, :Tp], jnp.minimum(cnt, Tp), msv)
    for g, w, nm in zip(got, want, ("cum", "freq", "tot")):
        _need(np.array_equal(np.asarray(g)[:, :Tp], np.asarray(w)),
              f"evolve {nm} kernel != reference ({C}x{T})")
    report[f"evolve_{C}x{T}_l{lanes}"] = (C, T, tk)
    report[f"evolve_{C}x{T}_l{lanes}_ref"] = (C, Tp, tref)


def check_rc(rng, B, T, Tp, report):
    """K4 at (B, T) against the native coder (full T) and
    rc_jax.encode_scan (prefix Tp)."""
    import jax.numpy as jnp
    import numpy as np

    from fqzcomp5_tpu.ops import rc_gpu, rc_jax
    from fqzcomp5_tpu.codecs import native

    tot = rng.integers(2, 60000, (B, T)).astype(np.uint32)
    freq = np.minimum((rng.random((B, T)) * tot * 0.9).astype(np.uint32)
                      + 1, tot)
    cum = (rng.random((B, T)) * (tot - freq)).astype(np.uint32)
    P0, P1 = rc_gpu.pack_planes(jnp.asarray(cum), jnp.asarray(freq),
                                jnp.asarray(tot))
    s0 = jnp.asarray(rc_gpu.init_state(B))
    ck = _compiled("rc_encode_walk", rc_gpu.walk_events, P0, P1, s0)
    (ev, st), tk = _timed(ck, P0, P1, s0)
    outcap = 1 << max(int(np.asarray(rc_gpu.event_totals(*ev)).max())
                      - 1, 0).bit_length()

    def on_device():
        tots = np.asarray(rc_gpu.event_totals(*ev))
        by = np.asarray(rc_gpu.compact_events(*ev, outcap=outcap))
        return [by[b, :tots[b]].tobytes() for b in range(B)]

    def on_host():
        ff0, ev0, ff1, ev1 = (np.asarray(e) for e in ev)
        fl = np.stack([(ev0 >> 16) & 1, (ev1 >> 16) & 1], -1) != 0
        ca = np.stack([ev0 & 0xFF, ev1 & 0xFF], -1)
        cy = np.stack([(ev0 >> 8) & 0xFF, (ev1 >> 8) & 0xFF], -1)
        ff = np.stack([ff0, ff1], -1)
        return [rc_jax.assemble_stream(fl[b], ca[b], ff[b], cy[b], b"")
                for b in range(B)]

    on_device()   # compiles
    t0 = time.perf_counter()
    dev_bytes = on_device()
    t1 = time.perf_counter()
    host_bytes = on_host()
    t2 = time.perf_counter()
    print(f"   rc byte assembly of {B}x{T} events: device "
          f"{(t1 - t0) * 1e3:.3f} ms, host {(t2 - t1) * 1e3:.3f} ms")
    _need(dev_bytes == host_bytes, "rc device assembly != host assembly")
    tails = rc_jax.finish_events(tuple(np.asarray(st).T))
    for b in range(B):
        want = native.rc_encode_raw(cum[b], freq[b], tot[b])
        _need(dev_bytes[b] + tails[b] == want,
              f"rc stream {b} != native coder at T={T}")
    (evr, str_), tref = jax_ref_time(rc_jax.walk_events, P0[:, :Tp],
                                     P1[:, :Tp], s0)
    evk, stk = rc_gpu.walk_events(P0[:, :Tp], P1[:, :Tp], s0)
    for a, b_ in zip(list(evk) + [stk], list(evr) + [str_]):
        _need(np.array_equal(np.asarray(a), np.asarray(b_)),
              "rc kernel != rc_jax.walk_events")
    report["rc_walk"] = (B, T, tk)
    report["rc_walk_ref"] = (B, Tp, tref)


def phase_kernels(seed: int, quick: bool = False) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    report: dict = {}
    # -1 trial wave: 14 blocks x (seq, qual, PACK'd seq) candidates of
    # ~4.6 MB -> 42 streams x 2^17 steps after the power-of-two bucket
    B, T = (8, 1024) if quick else (42, 1 << 17)
    Tp = 256 if quick else 4096
    check_rans(rng, B, T, Tp, False, report)
    check_rans(rng, B, T, Tp, True, report)
    # pass 2: a wide bucket of rarely-seen contexts and a hot-context
    # bucket; pass 3: one CHUNK of a -5 wave's adaptive streams
    if quick:
        check_evolve(rng, 64, 64, 64, 128, report)
        check_evolve(rng, 4, 2048, 256, 256, report)
        check_rc(rng, 8, 4096, 512, report)
    else:
        check_evolve(rng, 65536, 64, 64, 128, report)
        check_evolve(rng, 8, 1 << 18, 2048, 128, report)
        check_evolve(rng, 4, 1 << 18, 2048, 256, report)
        check_rc(rng, 16, 1 << 20, 4096, report)
    for k, (rows, steps, dt) in report.items():
        print(f"   kernel {k}: rows={rows} steps={steps} "
              f"{dt * 1e3:.3f} ms ({dt / steps * 1e9:.1f} ns/step)")
    return report


# ---------------------------------------------------------------------
# phases 1, 2, 4, 5

def build_native() -> None:
    """Rebuild the native library for this machine's CPU (the Makefile
    builds with -march=native) before anything loads it."""
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"), "-B",
                    f"-j{os.cpu_count() or 4}"], check=True,
                   stdout=subprocess.DEVNULL)


def require_gpu():
    import jax

    print(f"   jax {jax.__version__}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}")
    devs = jax.devices()
    print(f"   devices: {devs}")
    _need(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform}")
    return devs


class CompileCounter:
    """Counts XLA backend compilations (persistent-cache misses)."""

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, _secs, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1


def _same_file(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def roundtrip(level: int, src: str, work: str, ph: Phases, cc,
              tag: str = "") -> str:
    """-e tpu encode, -e tpu decode, host decode; both decodes must
    give the input back byte for byte.  Returns the archive path."""
    from fqzcomp5_tpu import cli

    arc = os.path.join(work, f"c{level}{tag}.fqz5")
    for name, argv, out in (
            ("encode", ["-e", "tpu", f"-{level}", src, arc], None),
            ("decode", ["-e", "tpu", "-d", arc], "d_tpu"),
            ("host decode", ["-e", "host", "-d", arc], "d_host")):
        path = os.path.join(work, f"{out}{level}{tag}.fq") if out else None
        n0 = cc.n
        rc = ph.run(f"-{level}{tag} {name}", cli.main,
                    ["-V"] + argv + ([path] if path else []))
        print(f"   compilations inside: {cc.n - n0}")
        _need(rc == 0, f"-{level}{tag} {name}: exit {rc}")
        if path:
            _need(_same_file(path, src),
                  f"-{level}{tag} {name}: output differs from input")
            os.unlink(path)
    print(f"   -{level}{tag} archive {os.path.getsize(arc)} B of "
          f"{os.path.getsize(src)} B")
    return arc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mb", type=int, default=256,
                    help="corpus size in MB (default 256)")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-card mesh path")
    a = ap.parse_args(argv)

    build_native()
    card = card_line()
    print(f"   card: {card}")
    devs = require_gpu()
    ph = Phases(card)
    cc = CompileCounter()
    sys.path.insert(0, ROOT)
    from bench import gen_corpus

    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(work, "in.fastq")
        if a.chips == 4:
            from fqzcomp5_tpu.ops import backend
            from fqzcomp5_tpu.parallel import pipeline

            _need(len(devs) >= 4, f"--chips 4 needs 4 GPUs, have "
                  f"{len(devs)}")
            ph.run("corpus", gen_corpus, src, a.mb, a.seed)
            one = roundtrip(1, src, work, ph, cc, "_1card")
            backend.set_mesh(pipeline.make_mesh(devs[:4], dp=4, sp=1))
            try:
                four = roundtrip(1, src, work, ph, cc, "_4card")
            finally:
                backend.set_mesh(None)
            _need(_same_file(one, four),
                  "4-card archive differs from the 1-card archive")
            print("   4-card archive == 1-card archive")
        else:
            ph.run("kernels", phase_kernels, a.seed)
            ph.run("corpus", gen_corpus, src, a.mb, a.seed)
            for level in (1, 5):
                roundtrip(level, src, work, ph, cc)
    print(f"== phase walls on {card}:")
    for name, dt in ph.rows:
        print(f"   {name:28s} {dt:10.3f} s")
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d) if a.chips == 4 else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
