"""End-to-end wall of the device engine with its Hopper kernels against
the same engine with the plain `lax` walks, through cli.main.

    python tools/walk_compare.py [--seed 1] [--mb1 256] [--mb5 16]
                                 [--profile-mb 0]

For each cell (-1 on an --mb1 corpus, -5 on an --mb5 corpus) it runs
`-e tpu` encode and decode with the kernels, then with the plain walks
(backend.use_kernel forced off), then with the kernels again, and
requires every archive and every decode to be identical.  One JSON line
per run; walls include compilation on the first run of each side.
--profile-mb N adds a cProfile of one warm -5 kernel encode on an N MB
corpus (top functions by cumulative time).  Needs a GPU; prints the
card beside every number.
"""

from __future__ import annotations

import argparse
import cProfile
import filecmp
import json
import os
import pstats
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _run(cli, argv) -> float:
    t0 = time.perf_counter()
    rc = cli.main(["-V"] + argv)
    if rc != 0:
        raise SystemExit(f"{argv}: exit {rc}")
    return time.perf_counter() - t0


def cell(level: int, mb: int, seed: int, work: str, card: str) -> None:
    from bench import gen_corpus
    from fqzcomp5_tpu import cli
    from fqzcomp5_tpu.ops import backend

    src = os.path.join(work, f"in{level}.fq")
    gen_corpus(src, mb, seed)
    kernel_use = backend.use_kernel
    ref_arc = None
    for side in ("kernel", "plain", "plain", "kernel"):
        backend.use_kernel = (kernel_use if side == "kernel"
                              else (lambda: False))
        arc = os.path.join(work, f"c{level}{side}.fqz5")
        out = os.path.join(work, f"d{level}{side}.fq")
        te = _run(cli, ["-e", "tpu", f"-{level}", src, arc])
        td = _run(cli, ["-e", "tpu", "-d", arc, out])
        if not filecmp.cmp(out, src, shallow=False):
            raise SystemExit(f"-{level} {side}: decode differs")
        if ref_arc is None:
            ref_arc = arc
        elif not filecmp.cmp(arc, ref_arc, shallow=False):
            raise SystemExit(f"-{level} {side}: archive differs")
        print(json.dumps({"cell": f"-{level}", "side": side,
                          "input_bytes": os.path.getsize(src),
                          "encode_s": te, "decode_s": td,
                          "card": card}), flush=True)
    backend.use_kernel = kernel_use


def profile_encode(mb: int, seed: int, work: str) -> None:
    from bench import gen_corpus
    from fqzcomp5_tpu import cli

    src = os.path.join(work, "prof.fq")
    gen_corpus(src, mb, seed)
    arc = os.path.join(work, "prof.fqz5")
    _run(cli, ["-e", "tpu", "-5", src, arc])      # compiles
    prof = cProfile.Profile()
    prof.enable()
    _run(cli, ["-e", "tpu", "-5", src, arc])
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(40)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mb1", type=int, default=256)
    ap.add_argument("--mb5", type=int, default=16)
    ap.add_argument("--profile-mb", type=int, default=0)
    a = ap.parse_args()
    import subprocess

    import jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")
    with tempfile.TemporaryDirectory() as work:
        if a.mb1:
            cell(1, a.mb1, a.seed, work, card)
        if a.mb5:
            cell(5, a.mb5, a.seed, work, card)
        if a.profile_mb:
            profile_encode(a.profile_mb, a.seed, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
