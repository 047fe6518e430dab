"""AOT memory analysis of the production Glow-prior BASIS level program.

The Beethoven Glow separation (benchmarks/quality_sdr_beethoven_glow.sh)
dispatches `basis_separate_per_level.run_level` with a level-major
[L=10, K=2, ...] fp32 param stack of the 512-filter L=3/K=40 flow and a
[2, 28, 96, 64, 1] iterate, differentiating the flow w.r.t. its input
every Langevin step. This probe lowers THAT exact program with abstract
arguments on the CPU backend and prints XLA's memory analysis
(argument/output/temp sizes), so the device-memory footprint is known
before the multi-hour training chain hands the device to the separation
stage.
Run: JAX_PLATFORMS=cpu python benchmarks/probe_glow_sep_memory.py \
         [--remat] [--chunk N]

Measured (CPU backend buffer assignment, 2026-08-19): full-batch VJP
temps are 18.1 GiB (args 2.95 GiB stack -> 21.1 GiB peak); per-step
jax.checkpoint changes nothing (18.0 GiB — XLA
schedules the rematerialised forwards eagerly, so the saved residuals
are live anyway); --chunk 8 (the run_basis_sep.py --score_chunk
default) bounds temps at 5.44 GiB -> 8.40 GiB peak.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu.models.flow_builder import build_glow
from audiosourcesep_tpu.separation.basis import (BasisConfig, glow_score_fn,
                                                 make_level_program)

L_SIGMA, K_SRC, N, H, W, C, T = 10, 2, 28, 96, 64, 1, 100
TINY = dict(L_SIGMA=2, K_SRC=2, N=4, H=16, W=16, C=1, T=2,
            L=2, K=2, n_filters=8)


def main(remat: bool, chunk=None, tiny: bool = False):
    global L_SIGMA, K_SRC, N, H, W, C, T
    glow_L, glow_K, n_filters = 3, 40, 512
    if tiny:   # smoke-test scale (tests/test_bench.py)
        L_SIGMA, K_SRC, N, H, W, C, T = (
            TINY["L_SIGMA"], TINY["K_SRC"], TINY["N"], TINY["H"],
            TINY["W"], TINY["C"], TINY["T"])
        glow_L, glow_K, n_filters = TINY["L"], TINY["K"], TINY["n_filters"]
    key = jax.random.PRNGKey(0)
    minibatch = jax.random.normal(key, (2, H, W, C)) * 20.0 - 60.0
    model, template = build_glow(
        key, minibatch, (H, W, C), L=glow_L, K=glow_K, n_filters=n_filters,
        learntop=True, data_type="melspec", use_logit=False,
        minval=-100.0, maxval=20.0, remat=remat)
    score_fn = glow_score_fn(model.log_prob, frame_chunk=chunk)
    cfg = BasisConfig(T=T, delta=0.288, data_type="melspec", scale="dB",
                      score_clip=5.0)
    sigmas = jnp.asarray(np.geomspace(120.0, 1.2, L_SIGMA))
    run_level = make_level_program(score_fn, sigmas, cfg, N)

    abstract = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct((L_SIGMA, K_SRC) + a.shape, a.dtype),
        template)
    n_params = sum(np.prod(a.shape) for a in jax.tree_util.tree_leaves(template))
    print(f"flow params: {n_params/1e6:.1f} M "
          f"(stack {L_SIGMA * K_SRC * n_params * 4 / 2**30:.2f} GiB fp32)")

    lowered = run_level.lower(
        abstract,
        jax.ShapeDtypeStruct((K_SRC, N, H, W, C), jnp.float32),
        jax.ShapeDtypeStruct((N, H, W, C), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    print("lowered; compiling (CPU backend)...", flush=True)
    mem = lowered.compile().memory_analysis()
    gib = 2.0 ** 30
    print(f"remat={remat} chunk={chunk}")
    print(f"  arguments : {mem.argument_size_in_bytes / gib:.2f} GiB")
    print(f"  outputs   : {mem.output_size_in_bytes / gib:.2f} GiB")
    print(f"  temps     : {mem.temp_size_in_bytes / gib:.2f} GiB")
    print(f"  peak(args+temp): "
          f"{(mem.argument_size_in_bytes + mem.temp_size_in_bytes) / gib:.2f}"
          " GiB")


if __name__ == "__main__":
    chunk = None
    if "--chunk" in sys.argv:
        chunk = int(sys.argv[sys.argv.index("--chunk") + 1])
    main(remat="--remat" in sys.argv, chunk=chunk,
         tiny="--tiny" in sys.argv)
