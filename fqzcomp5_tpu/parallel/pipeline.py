"""Data-parallel block compression over a device mesh.

The reference scales with a thread pool over independent 10MB-1GB
blocks (thread_pool.c; adaptive models reset per block, so parallelism
is lossless).  The device analog (SURVEY.md section 5):

- "dp" axis: blocks shard across chips/hosts.  Each device runs the
  rANS state-walk for its blocks; per-block compressed payloads and
  index entries are gathered back to the host that writes the file.
- "sp" axis: within a block, the STRIPE transform splits byte-position
  residue classes into independent streams; those sub-streams shard
  across a second mesh axis (the sequence-parallel analog).
- the 32 interleaved rANS states are the intra-device vector axis
  (the lanes of a warp), mirroring the reference's SIMD registers.

Because every stream is independent, N-chip output is byte-identical
to 1-chip output; scaling efficiency is pure throughput.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fqzcomp5_tpu.ops import rans_jax


def make_mesh(devices=None, dp: int | None = None, sp: int = 1) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    dev = np.asarray(devices[:dp * sp]).reshape(dp, sp)
    return Mesh(dev, ("dp", "sp"))


@functools.partial(jax.jit, static_argnames=("shift",))
def _encode_step(syms, x_max, rcp, rcp_shift, bias, cmpl,
                 shift: int = rans_jax.TF_SHIFT):
    """One device step: walk all (B, T, 32) streams, return final
    states, emitted word planes, and per-stream compressed word counts
    (the index-entry payload sizes)."""
    Rf, words, mask = rans_jax.encode_scan(
        syms, x_max, rcp, rcp_shift, bias, cmpl, shift)
    nwords = jnp.sum(mask.astype(jnp.int32), axis=(1, 2))
    return Rf, words, mask, nwords


def sharded_encode_step(mesh: Mesh, syms, tables, shift=rans_jax.TF_SHIFT):
    """Compress a (B, T, 32) batch of streams sharded over the mesh.

    B is laid out over (dp, sp) — blocks over dp, each block's stripe
    sub-streams over sp.  Outputs use the same sharding; the caller
    device_gets per-stream slices to assemble payloads.
    """
    spec = NamedSharding(mesh, P(("dp", "sp")))
    tspec = NamedSharding(mesh, P(("dp", "sp"), None))
    syms = jax.device_put(syms, spec)
    tables = tuple(jax.device_put(t, tspec) for t in tables)
    return _encode_step(syms, *tables, shift=shift)


def training_step(mesh: Mesh, syms, tables, shift=rans_jax.TF_SHIFT):
    """The "full step" used by the multi-chip dry run: sharded encode
    walk + cross-device gather of index entries (sizes) to host 0,
    mirroring the file writer's all-gather of {serial, clen} records."""
    Rf, words, mask, nwords = sharded_encode_step(mesh, syms, tables, shift)
    # index entries ride the ICI: gather the per-stream sizes everywhere
    gathered = jax.jit(lambda x: x)(nwords)  # resharding no-op
    sizes = np.asarray(jax.device_get(gathered))
    return Rf, words, mask, sizes


def shard_map_encode_step(mesh: Mesh, syms, tables,
                          shift=rans_jax.TF_SHIFT):
    """Explicit-SPMD variant: each device walks its block shard
    independently (no cross-device deps in the hot loop — mirroring the
    reference's thread-pool data parallelism), then the per-stream
    compressed sizes all-gather over the mesh (the index-entry
    exchange) and total output bytes psum for the throughput report.

    Returns (Rf, words, mask) sharded over ("dp","sp") plus replicated
    (sizes (B,), total_bytes scalar)."""
    from jax import shard_map

    axes = ("dp", "sp")

    def step(syms, x_max, rcp, rcp_shift, bias, cmpl):
        # seed the carry from the sharded input so it carries the same
        # varying mesh axes as the scanned operands
        R0 = jnp.full_like(syms[:, 0, :], rans_jax.RANS_L).astype(
            jnp.uint32)
        Rf, words, mask = rans_jax.encode_scan(
            syms, x_max, rcp, rcp_shift, bias, cmpl, shift, R0=R0)
        local_sizes = jnp.sum(mask.astype(jnp.int32), axis=(1, 2))
        # index entries ride the ICI to every host (writer picks them up)
        sizes = jax.lax.all_gather(local_sizes, axes, tiled=True)
        total = jax.lax.psum(jnp.sum(local_sizes) * 2 + 128, axes)
        return Rf, words, mask, sizes, total

    shard = P(axes)
    try:
        fn = shard_map(
            step, mesh=mesh,
            in_specs=(shard, shard, shard, shard, shard, shard),
            out_specs=(shard, shard, shard, P(), P()),
            check_rep=False)
    except TypeError:  # newer jax renamed the kwarg
        fn = shard_map(
            step, mesh=mesh,
            in_specs=(shard, shard, shard, shard, shard, shard),
            out_specs=(shard, shard, shard, P(), P()),
            check_vma=False)
    return jax.jit(fn)(syms, *tables)
