"""Cross-block batched adaptive encode (ops/adaptive_batch.py): many
SEQ/FQZ jobs share one pass-2 batch and one pass-3 walk, and every
payload must stay byte-identical to the host codecs
(native/fqzqual.cpp, native/seq.cpp)."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jax/device-heavy: nightly tier (fast tier: pytest -m 'not slow')

from fqzcomp5_tpu.codecs import host
from fqzcomp5_tpu.ops import adaptive_batch


def _fqz_case(seed, nrec=120, fixed=False, with_seq=False, strat=1):
    rng = np.random.default_rng(seed)
    lens = (np.full(nrec, 100, np.uint32) if fixed
            else rng.integers(40, 160, nrec).astype(np.uint32))
    total = int(lens.sum())
    q = np.clip(np.cumsum(rng.integers(-2, 3, total)) % 40 + 3,
                0, 45).astype(np.uint8)
    flags = np.zeros(nrec, np.uint32)
    seq = (bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), total))
           if with_seq else None)
    return ("fqz", bytes(q), lens, flags, seq, strat)


def _seq_case(seed, nrec=80, both=0, slevel=10):
    rng = np.random.default_rng(seed)
    lens = rng.integers(50, 150, nrec).astype(np.uint32)
    total = int(lens.sum())
    seq = bytes(rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                           total,
                           p=[.24, .24, .24, .22, .02, .01, .01, .01,
                              .01]))
    return ("seq", seq, lens, both, slevel)


def _host_encode(job):
    if job[0] == "fqz":
        _, q, lens, flags, seq, strat = job
        return host.fqz_compress(q, lens, flags, seq, strat)
    _, seq, lens, both, slevel = job
    return host.seq_encode(seq, lens, both, slevel)


def test_batch_matches_host_per_job():
    """A mixed 6-job batch (fqz varied strats, seq both-strands on and
    off) must reproduce every host payload byte-for-byte."""
    jobs = [
        _fqz_case(1),
        _fqz_case(2, fixed=True, strat=0),
        _seq_case(3),
        _fqz_case(4, with_seq=True, strat=3),
        _seq_case(5, both=1, slevel=12),
        _fqz_case(6, strat=2),
    ]
    got = adaptive_batch.encode_adaptive_batch(jobs)
    for i, job in enumerate(jobs):
        assert got[i] == _host_encode(job), f"job {i} ({job[0]})"


def test_batch_equals_single_job_runs():
    """Batching must not perturb any job: results equal the one-job
    path (which the round-1 parity suite already pins to native)."""
    jobs = [_fqz_case(11), _seq_case(12), _fqz_case(13, fixed=True)]
    batched = adaptive_batch.encode_adaptive_batch(jobs)
    singles = [adaptive_batch.encode_adaptive_batch([j])[0]
               for j in jobs]
    assert batched == singles


def test_chunked_walk(monkeypatch):
    """The pass-3 walk carries coder state across CHUNK_T-step device
    calls; force tiny chunks and require identical output."""
    jobs = [_fqz_case(21), _seq_case(22)]
    want = [_host_encode(j) for j in jobs]
    monkeypatch.setattr(adaptive_batch, "CHUNK_T", 256)
    got = adaptive_batch.encode_adaptive_batch(jobs)
    assert got == want


def test_pass3_pallas_path(monkeypatch):
    """The batch's pass-2 and pass-3 walks through the Pallas kernels
    (interpreter) must reproduce the host payloads byte-for-byte,
    including across chunk boundaries."""
    from fqzcomp5_tpu.ops import backend

    monkeypatch.setattr(backend, "INTERPRET", True)
    monkeypatch.setattr(adaptive_batch, "CHUNK_T", 512)
    jobs = [_fqz_case(31), _seq_case(32), _fqz_case(33, with_seq=True,
                                                   strat=3)]
    want = [_host_encode(j) for j in jobs]
    got = adaptive_batch.encode_adaptive_batch(jobs)
    assert got == want


def test_empty_and_tiny_jobs():
    jobs = [
        ("seq", b"", np.zeros(0, np.uint32), 0, 10),
        _fqz_case(31, nrec=1),
    ]
    got = adaptive_batch.encode_adaptive_batch(jobs)
    assert got[0] == _host_encode(jobs[0])
    assert got[1] == _host_encode(jobs[1])


def test_uneven_lengths_bucket_separately():
    """Jobs of very different sizes must not corrupt each other when
    they land in different pow2 buckets of the walk."""
    jobs = [_fqz_case(41, nrec=8), _fqz_case(42, nrec=400),
            _seq_case(43, nrec=4), _seq_case(44, nrec=300)]
    got = adaptive_batch.encode_adaptive_batch(jobs)
    for i, job in enumerate(jobs):
        assert got[i] == _host_encode(job), f"job {i}"


def test_wide_alphabet_declined_like_native():
    """Quality alphabets beyond the 96-symbol models: the native codec
    declines (the reference corrupts its heap there), and the device
    batch must decline identically instead of emitting wrong payloads
    (round-2 review finding)."""
    rng = np.random.default_rng(99)
    lens = np.full(50, 80, np.uint32)
    q = rng.integers(0, 200, int(lens.sum())).astype(np.uint8)
    flags = np.zeros(len(lens), np.uint32)
    with pytest.raises(ValueError):
        host.fqz_compress(bytes(q), lens, flags, None, 1)
    with pytest.raises(ValueError):
        adaptive_batch.encode_adaptive_batch(
            [("fqz", bytes(q), lens, flags, None, 1)])


def test_cli_wide_alphabet_encode_still_succeeds(tmp_path):
    """-5 on >96-symbol qualities: fqz methods are skipped (reference
    NULL-return semantics) and rANS wins — encode/decode round-trips
    instead of heap-corrupting like the reference binary."""
    from fqzcomp5_tpu import cli

    rng = np.random.default_rng(98)
    recs = []
    for i in range(300):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 80)
        qv = (rng.integers(0, 90, 80) + 33).astype(np.uint8)
        qv[::7] = 200  # quality bytes past the 96-symbol envelope
        recs.append(b"@r%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qv.tobytes() + b"\n")
    src = tmp_path / "w.fastq"
    src.write_bytes(b"".join(recs))
    comp = tmp_path / "w.fqz5"
    out = tmp_path / "w.out"
    assert cli.main(["-5", "-V", str(src), str(comp)]) == 0
    assert cli.main(["-d", "-V", str(comp), str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()


def test_memory_budget_chunking(monkeypatch):
    """Waves over the input-byte budget split into independent chunks
    with unchanged payloads (jobs share no state across the batch)."""
    jobs = [_fqz_case(41), _seq_case(42, both=1, slevel=12),
            _fqz_case(43, with_seq=True, strat=3), _seq_case(44)]
    want = [_host_encode(j) for j in jobs]
    monkeypatch.setenv("FQZ5_ADAPTIVE_BATCH_MB", "1")
    # force the chunker itself (budget of 1MB >> these tiny jobs)
    monkeypatch.setattr(adaptive_batch, "_batch_budget_bytes",
                        lambda: max(len(j[1]) for j in jobs) + 1)
    assert adaptive_batch.encode_adaptive_batch(jobs) == want


def test_skewed_context_memory():
    """The CSR pass-2 path must stay O(events): a block whose records
    all reset to one hot context (count >= nrec) next to thousands of
    cold contexts previously inflated dense (C, Tmax) planes to GBs."""
    import resource

    job = _seq_case(45, nrec=1500, both=1, slevel=14)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out = adaptive_batch.encode_adaptive_batch([job])[0]
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert out == _host_encode(job)
    # ~150K events; anything dense in (C, Tmax) would add hundreds of
    # MB here (k=14 -> 4^14 context space, hot init context x 1500)
    assert (after - before) < 1_500_000  # KB
