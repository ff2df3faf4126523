"""Device-engine (`-e tpu`) CLI path (runs on the CPU backend in
tests)."""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jax/device-heavy: nightly tier (fast tier: pytest -m 'not slow')

from fqzcomp5_tpu import cli


def make_fastq(tmp_path, n=3000):
    rng = np.random.default_rng(2)
    recs = []
    for i in range(n):
        nm = f"@T:{i % 3}:X:1:{1000 + i}:{rng.integers(1, 9999)}:42"
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 80)])
        q = (rng.normal(30, 5, 80).clip(0, 40) + 33).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"{nm}\n{seq}\n+\n{q}\n")
    p = tmp_path / "in.fastq"
    p.write_text("".join(recs))
    return p


def test_tpu_engine_roundtrip(tmp_path):
    src = make_fastq(tmp_path)
    comp = tmp_path / "c.fqz5"
    out = tmp_path / "o.fastq"
    assert cli.main(["-e", "tpu", "-V", str(src), str(comp)]) == 0
    # our tpu decode
    assert cli.main(["-e", "tpu", "-d", "-V", str(comp), str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()
    # host decode of the tpu-encoded file (format compatibility)
    out2 = tmp_path / "o2.fastq"
    assert cli.main(["-d", "-V", str(comp), str(out2)]) == 0
    assert out2.read_bytes() == src.read_bytes()
    assert cli.main(["--check", str(comp)]) == 0


def test_tpu_decode_of_host_file(tmp_path):
    src = make_fastq(tmp_path, 1000)
    comp = tmp_path / "c.fqz5"
    out = tmp_path / "o.fastq"
    assert cli.main(["-1", "-V", str(src), str(comp)]) == 0
    assert cli.main(["-e", "tpu", "-d", "-V", str(comp), str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()


def test_tpu_engine_fasta(tmp_path):
    p = tmp_path / "in.fasta"
    rng = np.random.default_rng(4)
    recs = []
    for i in range(500):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 120)])
        recs.append(f">chr{i}\n{seq}\n")
    p.write_text("".join(recs))
    comp = tmp_path / "c.fqz5"
    out = tmp_path / "o.fasta"
    assert cli.main(["-e", "tpu", "-V", str(p), str(comp)]) == 0
    assert cli.main(["-d", "-V", str(comp), str(out)]) == 0
    assert out.read_bytes() == p.read_bytes()


def test_pack_np_roundtrip():
    from fqzcomp5_tpu import tpu_driver

    rng = np.random.default_rng(5)
    for alpha, per in [(b"AB", 8), (b"ACGT", 4), (b"ACGTN", 2),
                       (bytes(range(16)), 2)]:
        for n in (1, 7, 64, 1001):
            data = rng.choice(list(alpha), n).astype(np.uint8).tobytes()
            r = tpu_driver.pack_np(data)
            assert r is not None
            meta, packed, got_per = r
            syms = np.frombuffer(meta[1:], np.uint8)
            assert tpu_driver.unpack_np(packed, n, syms) == data
    # >16 symbols is unpackable
    assert tpu_driver.pack_np(bytes(range(17)) * 3) is None


def test_tpu_engine_pack_path(tmp_path):
    """Correlated DNA makes PACK|O1 win; file must round-trip through
    both the device and host decoders."""
    import io

    from fqzcomp5_tpu import tpu_driver
    from fqzcomp5_tpu.drivers import Timings, decode_file, \
        make_fastq_writer
    from fqzcomp5_tpu.options import Options

    rng = np.random.default_rng(6)
    # markov-ish DNA: repeat motifs -> O1-compressible
    motif = rng.choice(list(b"ACGT"), 64).astype(np.uint8)
    recs = []
    for i in range(600):
        seq = np.tile(motif, 3).copy()
        flips = rng.integers(0, len(seq), 8)
        seq[flips] = rng.choice(list(b"ACGT"), 8)
        q = np.full(len(seq), 40, np.uint8)
        recs.append(b"@r%d\n" % i + seq.tobytes() + b"\n+\n"
                    + (q + 33).tobytes() + b"\n")
    data = b"".join(recs)
    src = tmp_path / "m.fastq"
    src.write_bytes(data)

    arg = Options()
    arg.apply_preset(1)
    arg.blk_size = 1 << 20
    arg.verbose = -1
    out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), out, arg, Timings())
    blob = out.getvalue()

    # the seq section must actually have taken the PACK branch
    from fqzcomp5_tpu import container
    fp = io.BytesIO(blob)
    ver, idx_off = container.read_header(fp)
    orders = []
    for raw in container.iter_raw_blocks(fp, idx_off):
        m = tpu_driver._split_block(raw, ver)
        orders.append(m["seq"][2][0])
    assert any(o & tpu_driver.X_PACK for o in orders), orders

    for dec in (tpu_driver.decode_file_tpu, decode_file):
        res = io.BytesIO()
        dec(io.BytesIO(blob), make_fastq_writer(res, arg), arg, Timings())
        assert res.getvalue() == data


def test_tpu_engine_paired(tmp_path, data_dir=None):
    import pathlib

    data = pathlib.Path(__file__).parent / "data"
    comp = tmp_path / "p.fqz5"
    assert cli.main(["-1", "-V", "-e", "tpu",
                     str(data / "paired_R1_nosuffix.fastq"),
                     str(data / "paired_R2_nosuffix.fastq"),
                     str(comp)]) == 0
    o1, o2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    assert cli.main(["-d", "-V", "-e", "tpu", str(comp),
                     str(o1), str(o2)]) == 0
    assert o1.read_bytes() == \
        (data / "paired_R1_nosuffix.fastq").read_bytes()
    assert o2.read_bytes() == \
        (data / "paired_R2_nosuffix.fastq").read_bytes()


def test_tpu_engine_stripe_path(tmp_path):
    """Fixed-length position-dependent qualities make the STRIPE
    candidate win (the RANSXN1 analog); the file must round-trip
    through both decoders."""
    import io

    from fqzcomp5_tpu import container, tpu_driver
    from fqzcomp5_tpu.drivers import Timings, decode_file, \
        make_fastq_writer
    from fqzcomp5_tpu.options import Options

    rng = np.random.default_rng(8)
    L = 100
    recs = []
    # quality depends strongly on read position -> per-position stripes
    # are near-constant while the interleaved stream looks random
    pos_mean = np.clip(40 - (np.arange(L) // 4), 10, 40)
    for i in range(2000):
        q = np.clip(pos_mean + rng.integers(-1, 2, L), 2, 45) + 33
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8)
        recs.append(b"@r%d\n" % i + seq.tobytes() + b"\n+\n"
                    + q.astype(np.uint8).tobytes() + b"\n")
    data = b"".join(recs)
    src = tmp_path / "s.fastq"
    src.write_bytes(data)

    arg = Options()
    arg.apply_preset(1)
    arg.blk_size = 1 << 20
    arg.verbose = -1
    out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), out, arg, Timings())
    blob = out.getvalue()

    fp = io.BytesIO(blob)
    ver, idx_off = container.read_header(fp)
    qorders = [tpu_driver._split_block(raw, ver)["qual"][2][0]
               for raw in container.iter_raw_blocks(fp, idx_off)]
    assert any(o & tpu_driver.X_STRIPE for o in qorders), qorders

    for dec in (tpu_driver.decode_file_tpu, decode_file):
        res = io.BytesIO()
        dec(io.BytesIO(blob), make_fastq_writer(res, arg), arg,
            Timings())
        assert res.getvalue() == data


@pytest.mark.parametrize("preset", [5, 9])
def test_tpu_engine_high_preset_matches_host(tmp_path, preset):
    """-e tpu -5/-9: SEQ/FQZ sections run through the cross-block
    device batch and must byte-match the host encoder's sections (the
    adaptive payloads are native-identical, and the wave learner locks
    the same methods; -9 widens the trial set to every SEQ/FQZ/rANS
    flavour)."""
    import io

    from fqzcomp5_tpu import container, tpu_driver
    from fqzcomp5_tpu.drivers import Timings, encode_file
    from fqzcomp5_tpu.options import Options

    rng = np.random.default_rng(77)
    recs = []
    # genome-like: sample reads from one synthetic chromosome so the
    # order-k SEQ model beats plain rANS, and Illumina-like qualities
    # (positional decay + strong previous-qual correlation) so fqz
    # beats rANS/STRIPE on the qual section — the regime -5 targets
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20000,
                       p=[0.3, 0.2, 0.2, 0.3])
    base = np.clip(40 - (np.arange(100) // 12) * 2, 22, 40)
    for i in range(1200):
        off = int(rng.integers(0, len(chrom) - 100))
        seq = chrom[off:off + 100].tobytes()
        dips = rng.random(100) < 0.03
        q = np.where(dips, 11, base + rng.choice([-2, 0, 0, 0, 2],
                                                 100))
        q = (q + 33).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n" % i + seq + b"\n+\n" + q + b"\n")
    data = b"".join(recs)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)

    def sections(blob):
        fp = io.BytesIO(blob)
        ver, idx_off = container.read_header(fp)
        out = []
        for raw in container.iter_raw_blocks(fp, idx_off):
            m = tpu_driver._split_block(raw, ver)
            out.append((m["seq"], m["qual"]))
        return out

    arg = Options()
    arg.apply_preset(preset)
    arg.blk_size = 40 << 10  # several blocks -> trial + locked waves
    arg.verbose = -1

    host_out = io.BytesIO()
    arg.nthreads = 1
    encode_file(str(src), host_out, arg, Timings())
    tpu_out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), tpu_out, arg, Timings())

    hsec = sections(host_out.getvalue())
    tsec = sections(tpu_out.getvalue())
    assert len(hsec) == len(tsec) and len(hsec) >= 3
    for b, (h, tt) in enumerate(zip(hsec, tsec)):
        for si, name in ((0, "seq"), (1, "qual")):
            hstrat, hulen, hpay = h[si]
            tstrat, tulen, tpay = tt[si]
            assert (hstrat, hulen) == (tstrat, tulen), (b, name)
            assert hpay == tpay, (b, name, len(hpay), len(tpay))
    # the archive decodes on both engines
    from fqzcomp5_tpu.drivers import decode_file, make_fastq_writer
    for dec in (tpu_driver.decode_file_tpu, decode_file):
        res = io.BytesIO()
        dec(io.BytesIO(tpu_out.getvalue()),
            make_fastq_writer(res, arg), arg, Timings())
        assert res.getvalue() == data
