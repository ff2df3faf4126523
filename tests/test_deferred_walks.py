"""Deferred device-walk fusion.

backend.deferred_walks() queues every lazy-encoder dispatch of a wave
segment and flushes them in ONE synced device call.  These tests drive
the kernel encode path (backend._encode_dev, ops/rans_gpu.py) in the
Pallas interpreter on the CPU and check:

- payload bytes and advertised sizes stay identical to the host codec
  (the deferral must be invisible to the wire format), and
- a whole segment's walks + nwords land in ONE devtimer compute call,
  and all its winner gathers in ONE more.
"""
import numpy as np
import pytest

from fqzcomp5_tpu import engine_tpu
from fqzcomp5_tpu.codecs import host
from fqzcomp5_tpu.ops import backend, devtimer


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(backend, "INTERPRET", True)
    yield


def _streams():
    rng = np.random.default_rng(11)
    dna = rng.choice(list(b"ACGT"), 6000, p=[.3, .2, .2, .3])
    qual = rng.integers(33, 43, 7000)
    skew = np.concatenate([np.full(3000, 70),
                           rng.integers(64, 80, 400)])
    return [np.asarray(s, np.uint8).tobytes()
            for s in (dna, qual, skew)]


def test_deferred_walks_fuse_and_match(pallas_interpret, monkeypatch):
    monkeypatch.setenv("FQZ5_DEVTIME", "1")
    monkeypatch.setattr(devtimer, "enabled", True)
    datas = _streams()
    devtimer.reset()
    with backend.deferred_walks():
        enc0 = engine_tpu.encode_o0_batch_lazy(datas)
        enc1 = engine_tpu.encode_o1_batch_lazy(datas)
    assert devtimer.compute_calls == 0  # nothing flushed yet
    s0, s1 = enc0.sizes, enc1.sizes
    # one fused call covered both encoders' walks AND nword counts
    assert devtimer.compute_calls == 1
    with backend.deferred_walks():
        enc0.prefetch([0, 2])
        enc1.prefetch([1])
    f0 = enc0.fetch([0, 2])
    f1 = enc1.fetch([1])
    # all winner gathers flushed as one more call
    assert devtimer.compute_calls == 2
    # bytes + sizes identical to the host codec cores
    for i in (0, 2):
        ref = host.rans_compress(datas[i], 0x04)
        body = _strip(ref)
        assert f0[i] == body
        assert s0[i] == len(body)
    ref1 = _strip(host.rans_compress(datas[1], 0x05))
    assert f1[1] == ref1
    assert s1[1] == len(ref1)


def test_deferred_walks_plain_path_unchanged(pallas_interpret):
    # outside the context, lazy encoders still work standalone
    datas = _streams()
    enc0 = engine_tpu.encode_o0_batch_lazy(datas)
    got = enc0.fetch_all()
    for i, d in enumerate(datas):
        assert got[i] == _strip(host.rans_compress(d, 0x04))


def _strip(framed: bytes) -> bytes:
    """Drop the [order u8][varint ulen] dispatcher framing -> core."""
    arr = np.frombuffer(framed, np.uint8)
    off = 1
    while arr[off] & 0x80:
        off += 1
    off += 1
    return arr[off:].tobytes()
