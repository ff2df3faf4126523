"""Device (JAX) rANS engine: bit-parity with the native codec, plus the
sharded multi-chip pipeline on the virtual CPU mesh."""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jax/device-heavy: nightly tier (fast tier: pytest -m 'not slow')

from fqzcomp5_tpu import engine_tpu
from fqzcomp5_tpu.utils import varint
from fqzcomp5_tpu.codecs import host

RNG = np.random.default_rng(11)


def _core_of(framed: bytes):
    """Strip [order][usize varint] framing; None if not an X32 rANS body."""
    order = framed[0]
    if order & 0x20 or not (order & 0x04):
        return None
    _, nb = varint.get_u32(framed, 1)
    return framed[1 + nb:]


CASES = {
    "qual": np.clip(RNG.normal(30, 5, 40009), 0, 60
                    ).astype(np.uint8).tobytes(),
    "dna": RNG.choice(np.frombuffer(b"ACGT", np.uint8), 20000,
                      p=[.3, .2, .2, .3]).tobytes(),
    "text": (b"\x00".join(b"read_%d extra" % i for i in range(900))
             + b"\x00"),
    "mult32": bytes(RNG.integers(0, 50, 4096).astype(np.uint8)),
    # single-symbol stream: its freq table normalises to one symbol at
    # freq 4096, whose f<<20 wraps to 0 in the u32 s3 LUT (caught live:
    # constant-quality blocks once decoded to the wrong constant
    # through the device path)
    "const": bytes([40]) * 8192,
}


@pytest.mark.parametrize("name", list(CASES))
def test_o0_core_parity(name):
    data = CASES[name]
    ref = _core_of(host.rans_compress(data, 4))
    if ref is None:
        pytest.skip("native fell back to CAT")
    assert engine_tpu.encode_o0_core(data) == ref
    assert engine_tpu.decode_o0_core(ref, len(data)) == data


@pytest.mark.parametrize("name", list(CASES))
def test_o1_core_parity(name):
    data = CASES[name]
    ref = _core_of(host.rans_compress(data, 5))
    if ref is None:
        pytest.skip("native fell back to CAT")
    assert engine_tpu.encode_o1_core(data) == ref
    assert engine_tpu.decode_o1_core(ref, len(data)) == data


def test_multichip_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    Rf, words, mask = jax.jit(fn)(*args)
    assert Rf.shape == (4, 32)


def test_shard_invariance():
    """SURVEY section 4: output must be identical regardless of device
    count — blocks are model-independent, so a 1-device and an 8-device
    mesh walk produce the same streams."""
    import jax
    import numpy as np

    from fqzcomp5_tpu.ops import rans_jax
    from fqzcomp5_tpu.parallel import pipeline

    rng = np.random.default_rng(11)
    B, T = 16, 12
    freqs = np.zeros((B, 256), np.uint32)
    freqs[:, :8] = 512
    tables = rans_jax.build_enc_tables(freqs, rans_jax.TF_SHIFT)
    syms = rng.integers(0, 8, (B, T, 32)).astype(np.int32)

    devs = jax.devices("cpu")
    results = []
    for n in (1, 4, 8):
        mesh = pipeline.make_mesh(devs[:n], dp=n, sp=1)
        Rf, w, m, sizes, total = pipeline.shard_map_encode_step(
            mesh, syms, tables)
        results.append((np.asarray(Rf), np.asarray(w), np.asarray(m),
                        np.asarray(sizes)))
    for r in results[1:]:
        for a, b in zip(results[0], r):
            assert np.array_equal(a, b)
