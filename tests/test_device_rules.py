"""The device engine's rules: it runs on a GPU or, on purpose, on the
CPU; the kernel follows the walk's platform; device errors fail the
CLI instead of falling back to host codecs; kernels run per shard
under a mesh; the compile cache goes where JAX_COMPILATION_CACHE_DIR
says, else to one ignored directory of the checkout."""

import numpy as np
import pytest

from fqzcomp5_tpu import cli
from fqzcomp5_tpu.ops import backend


def _fastq(tmp_path, n=400, L=90, seed=5):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes()
        q = (rng.integers(0, 41, L) + 33).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, q))
    p = tmp_path / "in.fastq"
    p.write_bytes(b"".join(recs))
    return p


def test_cpu_device_refused_unless_asked(tmp_path, monkeypatch, capsys):
    src = _fastq(tmp_path, 20)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    rc = cli.main(["-e", "tpu", str(src), str(tmp_path / "o.fqz5")])
    assert rc == 1
    assert "ERROR:" in capsys.readouterr().err
    assert not (tmp_path / "o.fqz5").exists()
    # host engine is unaffected
    assert cli.main(["-V", str(src), str(tmp_path / "h.fqz5")]) == 0


@pytest.mark.parametrize("env", ["cpu", "cuda,cpu"])
def test_cpu_device_allowed_when_named(monkeypatch, env):
    monkeypatch.setenv("JAX_PLATFORMS", env)
    backend.init_device()


@pytest.mark.parametrize("platform,interpret,want", [
    ("gpu", False, True),
    ("cpu", False, False),
    ("cpu", True, True),
])
def test_kernel_choice_follows_platform(monkeypatch, platform, interpret,
                                        want):
    monkeypatch.setattr(backend, "walk_platform", lambda: platform)
    monkeypatch.setattr(backend, "INTERPRET", interpret)
    assert backend.use_kernel() is want


def test_walk_platform_reads_mesh_devices():
    import jax

    from fqzcomp5_tpu.parallel import pipeline

    backend.set_mesh(pipeline.make_mesh(jax.devices()[:2], dp=2))
    try:
        assert backend.walk_platform() == "cpu"
    finally:
        backend.set_mesh(None)
    assert backend.walk_platform() == jax.devices()[0].platform


def _boom(*a, **k):
    raise RuntimeError("device walk failed")


@pytest.mark.parametrize("walks,preset,decode", [
    (("rans_jax.encode_scan_flat",), "-1", False),
    (("rans_jax.decode_scan", "rans_jax.decode_scan_o1"), "-1", True),
    (("rc_jax.walk_events",), "-5", False),
])
def test_walk_error_fails_cli(tmp_path, monkeypatch, capsys, walks,
                             preset, decode):
    """An exception inside a device walk reaches cli.main's ERROR:
    path (exit 1); no host codec writes the section instead."""
    from fqzcomp5_tpu.ops import rans_jax, rc_jax

    src = _fastq(tmp_path)
    comp = tmp_path / "c.fqz5"
    assert cli.main(["-V", "-e", "tpu", preset, str(src),
                     str(comp)]) == 0
    for where in walks:
        mod, fn = where.split(".")
        monkeypatch.setattr({"rans_jax": rans_jax, "rc_jax": rc_jax}[mod],
                            fn, _boom)
    if decode:
        argv = ["-e", "tpu", "-d", str(comp), str(tmp_path / "o.fq")]
    else:
        argv = ["-e", "tpu", preset, str(src), str(tmp_path / "d.fqz5")]
    assert cli.main(argv) == 1
    assert "ERROR: device walk failed" in capsys.readouterr().err


def test_kernel_engine_roundtrip(tmp_path, monkeypatch):
    """-e tpu encode + decode through cli.main with every walk on the
    kernels (Pallas interpreter): the host engine and the device
    engine both decode the archive back to the input."""
    monkeypatch.setattr(backend, "INTERPRET", True)
    src = _fastq(tmp_path, 300)
    comp = tmp_path / "c.fqz5"
    assert cli.main(["-V", "-e", "tpu", "-1", "-b", "1M", str(src),
                     str(comp)]) == 0
    for eng in ("tpu", "host"):
        out = tmp_path / f"o_{eng}.fq"
        assert cli.main(["-V", "-e", eng, "-d", str(comp), str(out)]) == 0
        assert out.read_bytes() == src.read_bytes()


@pytest.fixture
def kernel_mesh(monkeypatch):
    import jax

    from fqzcomp5_tpu.parallel import pipeline

    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs the virtual multi-device CPU backend")
    monkeypatch.setattr(backend, "INTERPRET", True)
    backend.set_mesh(pipeline.make_mesh(devs[:4], dp=4, sp=1))
    yield
    backend.set_mesh(None)


def test_mesh_kernel_encode_decode(kernel_mesh):
    """Under a 4-device mesh the encode and decode kernels run per
    shard (shard_map over rows) and equal the 1-device CPU reference."""
    from fqzcomp5_tpu import engine_tpu

    rng = np.random.default_rng(8)
    datas = [rng.integers(60, 60 + k, 3000 + 77 * k).astype(
        np.uint8).tobytes() for k in (3, 20, 41)]
    p0 = engine_tpu.encode_o0_batch(datas)
    p1 = engine_tpu.encode_o1_batch(datas)
    d0 = engine_tpu.decode_o0_batch(p0, [len(d) for d in datas])
    d1 = engine_tpu.decode_o1_batch(p1, [len(d) for d in datas])
    backend.set_mesh(None)
    backend.INTERPRET = False
    assert p0 == engine_tpu.encode_o0_batch(datas)
    assert p1 == engine_tpu.encode_o1_batch(datas)
    assert d0 == datas and d1 == datas


def test_mesh_kernel_adaptive(kernel_mesh):
    """Pass 2 and pass 3 kernels under the mesh == the host codecs."""
    from fqzcomp5_tpu import fastq
    from fqzcomp5_tpu.codecs import host
    from fqzcomp5_tpu.ops.adaptive_batch import encode_adaptive_batch
    import tempfile
    import pathlib

    with tempfile.TemporaryDirectory() as td:
        src = _fastq(pathlib.Path(td), 120)
        fq = fastq.Parser(fastq.open_input(str(src))).next_batch(1 << 20)
    got = encode_adaptive_batch([
        ("fqz", fq.qual_buf, fq.lens, fq.flags, fq.seq_buf, 1),
        ("seq", fq.seq_buf, fq.lens, 0, 8),
    ])
    assert got[0] == host.fqz_compress(fq.qual_buf, fq.lens, fq.flags,
                                       fq.seq_buf, 1)
    assert got[1] == host.seq_encode(fq.seq_buf, fq.lens, 0, 8)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, monkeypatch, env_dir):
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(backend, "CACHE_DIR", str(tmp_path / "cache"))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        backend.ensure_compile_cache()
        assert calls == {}
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        backend.ensure_compile_cache()
        assert calls["jax_compilation_cache_dir"] == str(
            tmp_path / "cache")
        assert (tmp_path / "cache").is_dir()
