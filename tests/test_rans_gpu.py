"""rANS encode/decode kernels (ops/rans_gpu.py) vs the lax.scan
references, in the Pallas interpreter on the CPU.  The same kernels
compile for the GPU through Triton; chip_smoke.py repeats the
comparison there at the engine's real widths."""

import numpy as np
import pytest

from fqzcomp5_tpu.ops import backend, rans_gpu, rans_jax


def rand_freqs(B, shift, ns_max=60, seed=0):
    rng = np.random.default_rng(seed)
    tot = 1 << shift
    freqs = np.zeros((B, 256), np.uint32)
    for b in range(B):
        ns = rng.integers(2, ns_max)
        f = rng.integers(1, 100, ns).astype(np.float64)
        f = np.floor(f / f.sum() * tot).astype(np.int64)
        f[f == 0] = 1
        f[np.argmax(f)] += tot - f.sum()
        freqs[b, :ns] = f
    return freqs


def scan_reference(flat, freqs, shift, R0=None):
    B = flat.shape[0]
    tt = rans_jax.build_enc_tables(freqs, shift)
    app = lambda a, v: np.concatenate(  # noqa: E731
        [a.reshape(B, -1), np.full((B, 1), v, a.dtype)], axis=1)
    return rans_jax.encode_scan_flat(
        flat, app(tt[0], 0xFFFFFFFF), app(tt[1], 0), app(tt[2], 0),
        app(tt[3], 0), app(tt[4], 0), R0)


def kernel_encode(flat, freqs, shift, R0=None):
    """Table plane gathered on the host, walked by the kernel; T pads
    to the kernel's step multiple with identity entries."""
    B, T, _ = flat.shape
    pt = backend.build_packed_tables(freqs, shift)
    P = np.take_along_axis(pt, flat.reshape(B, -1), 1).reshape(B, T, 32)
    Tp = -(-T // rans_gpu.CH) * rans_gpu.CH
    P = np.pad(P, ((0, 0), (0, Tp - T), (0, 0)),
               constant_values=1 << (2 * shift))
    if R0 is None:
        R0 = np.full((B, 32), rans_jax.RANS_L, np.uint32)
    Rf, out = map(np.asarray, rans_gpu.encode_walk(
        P, R0, shift=shift, interpret=True))
    out = out[:, :T]
    return Rf, out & 0xFFFF, (out >> 16) != 0


@pytest.mark.parametrize("shift", [10, 12])
@pytest.mark.parametrize("B,T", [(4, 32), (6, 50), (1, 7), (9, 96)])
def test_kernel_encode_parity(shift, B, T):
    freqs = rand_freqs(B, shift, seed=B * 100 + T + shift)
    rng = np.random.default_rng(B + T)
    flat = np.stack([rng.choice(np.flatnonzero(freqs[b]), (T, 32))
                     for b in range(B)]).astype(np.int32)
    flat[0, -2:] = 256  # no-op sentinel steps (ragged-batch padding)
    Rf1, w1, m1 = map(np.asarray, scan_reference(flat, freqs, shift))
    Rf2, w2, m2 = kernel_encode(flat, freqs, shift)
    assert np.array_equal(Rf1, Rf2)
    assert np.array_equal(m1, m2)
    assert np.array_equal(w1[m1], w2[m2])


def test_kernel_encode_parity_with_r0():
    shift = 12
    B, T = 5, 40
    freqs = rand_freqs(B, shift, seed=7)
    rng = np.random.default_rng(17)
    flat = np.stack([rng.choice(np.flatnonzero(freqs[b]), (T, 32))
                     for b in range(B)]).astype(np.int32)
    R0 = rng.integers(rans_jax.RANS_L, 1 << 30, (B, 32)).astype(np.uint32)
    Rf1, w1, m1 = map(np.asarray, scan_reference(flat, freqs, shift, R0))
    Rf2, w2, m2 = kernel_encode(flat, freqs, shift, R0)
    assert np.array_equal(Rf1, Rf2)
    assert np.array_equal(m1, m2)
    assert np.array_equal(w1[m1], w2[m2])


def test_packed_tables_o1_context_starts():
    # order-1: starts are per-context cumsums, not global
    shift = 10
    freqs = np.zeros((1, 256, 256), np.uint32)
    freqs[0, 0, :4] = 256
    freqs[0, 3, 1] = 1024
    pt = backend.build_packed_tables(freqs, shift)
    assert pt.shape == (1, 256 * 256 + 1)
    # context 3, symbol 1: f=1024, start=0 within its own context
    assert pt[0, 3 * 256 + 1] == (1024 << shift) | 0
    # context 0, symbol 2: start = 512
    assert pt[0, 2] == (256 << shift) | 512
    # sentinel
    assert pt[0, -1] == 1 << (2 * shift)


def _freqs(rng, B, ns, shift):
    """(B, 256) tables normalised to 1 << shift over exactly ns
    symbols."""
    f = rng.integers(1, 100, (B, ns)).astype(np.float64)
    tot = 1 << shift
    f = np.floor(f / f.sum(1, keepdims=True) * (tot - ns)).astype(
        np.int64) + 1
    f[:, 0] += tot - f.sum(1)
    out = np.zeros((B, 256), np.uint32)
    out[:, :ns] = f
    return out


def _stream(rng, B, T, nsym, order1, shift):
    """Encode random streams with the reference walk; return the
    decoder's inputs and the symbols they must give back."""
    row = _freqs(rng, B, nsym, shift)
    sym = rng.integers(0, nsym, (B, T, 32))
    if order1:
        # every context of a stream shares one table
        fr = np.repeat(row[:, None, :], 256, axis=1)
        ctx = np.concatenate([np.zeros((B, 1, 32), np.int64),
                              sym[:, :-1]], 1)
        flat = (ctx * 256 + sym).astype(np.int32)
        s3 = rans_jax.build_s3(fr, shift).reshape(B, -1)
    else:
        fr = row
        flat = sym.astype(np.int32)
        s3 = rans_jax.build_s3(fr, shift)
    Rf, w, m = map(np.asarray, scan_reference(flat, fr, shift))
    W = max(int(m[b].sum()) for b in range(B)) + 1
    words = np.zeros((B, W), np.uint32)
    for b in range(B):
        words[b, :m[b].sum()] = w[b][m[b]]
    return words, Rf, s3, sym


@pytest.mark.parametrize("order1", [False, True])
@pytest.mark.parametrize("nsym", [4, 46, 120])
def test_kernel_decode_parity(order1, nsym):
    """Decode kernel == decode_scan/_o1 on ragged streams (per-stream
    step counts), alphabets from DNA-sized to wider than 64."""
    shift = 10 if order1 else 12
    rng = np.random.default_rng(nsym + order1)
    B, T = 5, 24
    words, R0, s3, sym = _stream(rng, B, T, nsym, order1, shift)
    t_real = np.array([T, 11, 1, 0, T - 3], np.int32)
    ref = rans_jax.decode_scan_o1 if order1 else rans_jax.decode_scan
    s1, R1, p1 = map(np.asarray, ref(words, R0, s3, T=T, shift=shift,
                                     t_real=t_real))
    s2, R2, p2 = map(np.asarray, rans_gpu.decode_walk(
        words, R0, s3, t_real, T=T, shift=shift, order1=order1,
        interpret=True))
    for b in range(B):
        assert np.array_equal(s1[b, :t_real[b]], s2[b, :t_real[b]]), b
    assert np.array_equal(R1, R2)
    assert np.array_equal(p1, p2)
    # the full-length stream decodes back to its symbols
    assert np.array_equal(s2[0], sym[0])


def test_kernel_decode_o1_alphabet_above_64():
    """Order-1 streams whose byte alphabet exceeds 64 symbols decode
    on the kernel path (no alphabet limit)."""
    rng = np.random.default_rng(3)
    words, R0, s3, sym = _stream(rng, 2, 16, 200, True, 12)
    assert len(np.unique(sym)) > 64
    t_real = np.full(2, 16, np.int32)
    s2, _, _ = rans_gpu.decode_walk(words, R0, s3, t_real, T=16,
                                    shift=12, order1=True,
                                    interpret=True)
    assert np.array_equal(np.asarray(s2), sym)
