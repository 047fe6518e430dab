#!/usr/bin/env python
"""Piecewise profile of the BASIS hot path on the real accelerator.

Times the pieces of one NCSNv1 (192f) score forward at the benchmark shape
[30, 96, 64, 1] so optimization effort goes where the time is:
  - full per-level Langevin scan (the production program)
  - one bare score forward
  - score forward with all instance norms replaced by identity
  - conv microbenches per hot shape (normal vs dilated vs space-to-batch)
  - 5x5 SAME avg-pool: reduce_window vs separable two-pass

Usage: python benchmarks/profile_basis.py [--quick]
"""

import argparse
import functools
import os
import sys
import time

# repo root on sys.path, so the script runs from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

os.makedirs(os.path.expanduser("~/.cache/jax_comp"), exist_ok=True)
try:
    jax.config.update("jax_compilation_cache_dir",
                      os.path.expanduser("~/.cache/jax_comp"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10)
except Exception:
    pass

from audiosourcesep_tpu import nn
from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           ncsn_score_fn, stack_pytrees)

N_FRAMES = 30
DATA_SHAPE = (96, 64, 1)
N_FILTERS = 192
NUM_CLASSES = 10


def timeit(fn, *args, reps=5, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    return dt, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})")

    model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            compute_dtype=jnp.bfloat16)
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 4)
    p1 = model.init_params(k0)
    p2 = model.init_params(k1)
    stacked = stack_pytrees(p1, p2)
    x = jax.random.uniform(k2, (2, N_FRAMES, *DATA_SHAPE))
    mixed = jax.random.normal(k3, (N_FRAMES, *DATA_SHAPE)) * 0.2 + 0.5
    labels = jnp.zeros((N_FRAMES,), jnp.int32)

    # --- one score forward (both models, sequential mode) ------------------
    score = ncsn_score_fn(model.apply)
    fwd = jax.jit(lambda p, x: score(p, x, labels, jnp.asarray(0)))
    dt, _ = timeit(fwd, stacked, x)
    flops = 267e9 * N_FRAMES * 2  # approx fwd FLOPs for both models
    print(f"score fwd (2 models, batch {N_FRAMES}): {dt*1e3:.2f} ms  "
          f"~{flops/dt/1e12:.1f} TFLOP/s")

    # --- one full T=100 level --------------------------------------------
    if not args.quick:
        sigmas = get_sigmas(1.0, 0.01, NUM_CLASSES, "logarithmic")
        cfg = BasisConfig(T=100, collect_trajectory=False)
        def one_level(p, x_, m, key):
            out, _ = basis_separate_per_level(
                score, p, m, x_, sigmas[:1], key, cfg)
            return out
        dt, _ = timeit(one_level, stacked, x, mixed,
                       jax.random.PRNGKey(1), reps=2, warmup=1)
        print(f"one level (T=100): {dt:.3f} s  -> x10 levels = {dt*10:.1f} s")

    # --- norm share: forward with instance_norm monkeypatched to identity --
    orig_in = nn.instance_norm
    try:
        nn.instance_norm = lambda params, x, eps=1e-3: (
            x * params.get("gamma", jnp.ones(x.shape[-1], x.dtype)).astype(
                x.dtype))
        model_nn = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                                   compute_dtype=jnp.bfloat16)
        score_nn = ncsn_score_fn(model_nn.apply)
        fwd_nn = jax.jit(lambda p, x: score_nn(p, x, labels, jnp.asarray(0)))
        dt_nn, _ = timeit(fwd_nn, stacked, x)
        print(f"score fwd, instance_norm->affine: {dt_nn*1e3:.2f} ms")
    finally:
        nn.instance_norm = orig_in

    # --- conv microbench ----------------------------------------------------
    shapes = [
        ("96x64x192->192", (60, 96, 64, 192), 192, 1),
        ("48x32x384->384", (60, 48, 32, 384), 384, 1),
        ("48x32x384->384 dil2", (60, 48, 32, 384), 384, 2),
        ("48x32x384->384 dil4", (60, 48, 32, 384), 384, 4),
    ]
    for name, xs, co, dil in shapes:
        kx, kk = jax.random.split(jax.random.PRNGKey(hash(name) % 2**31), 2)
        xb = jax.random.normal(kx, xs, jnp.bfloat16)
        kern = jax.random.normal(kk, (3, 3, xs[-1], co), jnp.bfloat16)
        conv = jax.jit(functools.partial(
            lambda x_, k_, d: jax.lax.conv_general_dilated(
                x_, k_, (1, 1), "SAME", rhs_dilation=(d, d),
                dimension_numbers=("NHWC", "HWIO", "NHWC")), d=dil))
        dt, _ = timeit(conv, xb, kern, reps=10, warmup=3)
        fl = 2 * xs[0] * xs[1] * xs[2] * 9 * xs[3] * co
        print(f"conv {name}: {dt*1e3:.3f} ms  {fl/dt/1e12:.1f} TFLOP/s")

        if dil > 1:
            # space-to-batch equivalent: dilated conv == conv on d^2 phases
            def s2b(x_, k_, d=dil):
                n, h, w, c = x_.shape
                x4 = x_.reshape(n, h // d, d, w // d, d, c)
                x4 = x4.transpose(0, 2, 4, 1, 3, 5).reshape(
                    n * d * d, h // d, w // d, c)
                y = jax.lax.conv_general_dilated(
                    x4, k_, (1, 1), "SAME",
                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
                y = y.reshape(n, d, d, h // d, w // d, co)
                return y.transpose(0, 3, 1, 4, 2, 5).reshape(n, h, w, co)
            dt2, _ = timeit(jax.jit(s2b), xb, kern, reps=10, warmup=3)
            print(f"  space-to-batch: {dt2*1e3:.3f} ms  "
                  f"{fl/dt2/1e12:.1f} TFLOP/s")

    # --- 5x5 avg pool -------------------------------------------------------
    xb = jax.random.normal(jax.random.PRNGKey(7), (60, 48, 32, 384),
                           jnp.bfloat16)
    dt, _ = timeit(jax.jit(lambda v: nn.avg_pool_same(v, 5)), xb,
                   reps=10, warmup=3)
    print(f"avg_pool_same 5x5 (reduce_window): {dt*1e3:.3f} ms")

    def sep_pool(v):
        s = jax.lax.reduce_window(v, 0.0, jax.lax.add, (1, 5, 1, 1),
                                  (1, 1, 1, 1), "SAME")
        s = jax.lax.reduce_window(s, 0.0, jax.lax.add, (1, 1, 5, 1),
                                  (1, 1, 1, 1), "SAME")
        ones = jnp.ones(v.shape[1:3], v.dtype)[None, :, :, None]
        n1 = jax.lax.reduce_window(ones, 0.0, jax.lax.add, (1, 5, 1, 1),
                                   (1, 1, 1, 1), "SAME")
        n = jax.lax.reduce_window(n1, 0.0, jax.lax.add, (1, 1, 5, 1),
                                  (1, 1, 1, 1), "SAME")
        return s / n
    dt2, _ = timeit(jax.jit(sep_pool), xb, reps=10, warmup=3)
    print(f"avg_pool separable 5+5: {dt2*1e3:.3f} ms")

    # --- bilinear resize ----------------------------------------------------
    xb = jax.random.normal(jax.random.PRNGKey(8), (60, 48, 32, 384),
                           jnp.bfloat16)
    dt, _ = timeit(jax.jit(lambda v: nn.resize_bilinear(v, (96, 64))), xb,
                   reps=10, warmup=3)
    print(f"resize_bilinear 48x32->96x64: {dt*1e3:.3f} ms")


if __name__ == "__main__":
    main()
