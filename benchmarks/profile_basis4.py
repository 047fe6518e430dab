#!/usr/bin/env python
"""Decomposition profile of the NCSNv1 score forward, scan-timed with
strength-reduction-proof feedback.

A feedback that slices the output (`y[:, :1]`, `y[..., :C]`) lets XLA push
the slice INTO the dot/conv (slice-of-dot => GEMV, channel-slice =>
sliced kernel), so such variants measure a fraction of the op. Here
feedback consumes y through a MAX — a max over the output cannot be folded
into the contraction — and the scan returns a scalar checksum.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


from audiosourcesep_tpu.models.ncsn import get_score_model
from audiosourcesep_tpu.models.ncsn import layers as ncsn_layers
from audiosourcesep_tpu.separation import ncsn_score_fn, stack_pytrees

N_FRAMES = 30
DATA_SHAPE = (96, 64, 1)
N_FILTERS = 192
NUM_CLASSES = 10
FLOPS_1FWD = 7.728e12


def scan_time_max(fn, params, x, iters=10, reps=3):
    """Time fn inside a scan; the carry folds in max(y) (not foldable into
    the contraction) and only a scalar leaves the device. Returns the best
    per-iteration time of ``reps`` runs, dispatch overhead included."""

    @jax.jit
    def loop(p, x0):
        def body(carry, _):
            y = fn(p, carry)
            m = jnp.max(y).astype(carry.dtype)
            return carry * 0.999 + m * 1e-6, None
        out, _ = jax.lax.scan(body, x0, None, length=iters)
        return jnp.sum(out)

    jax.block_until_ready(loop(params, x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(params, x))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def fwd_time(name, x, labels, stub_norm=False, stub_act=False, iters=10):
    orig_norm = ncsn_layers._norm2dplus
    orig_elu = jax.nn.elu
    try:
        if stub_norm:
            # keep ONE elementwise op so downstream shapes/dtypes match
            ncsn_layers._norm2dplus = (
                lambda x_, s, a, b, **kw: x_ * 1.0000001)
        if stub_act:
            # patch BEFORE construction: blocks bind act at __init__
            jax.nn.elu = lambda v: v * 1.0000001
        model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                                compute_dtype=jnp.bfloat16)
        k0, k1 = jax.random.split(jax.random.PRNGKey(0))
        p1, p2 = model.init_params(k0), model.init_params(k1)
        stacked = stack_pytrees(p1, p2)
        score = ncsn_score_fn(model.apply)
        dt = scan_time_max(
            lambda p, v: score(p, v, labels, jnp.asarray(0)), stacked, x,
            iters=iters)
        print(f"fwd [{name}]: {dt*1e3:.2f} ms  "
              f"{2*FLOPS_1FWD/dt/1e12:.1f} TFLOP/s-nominal", flush=True)
        return dt
    finally:
        ncsn_layers._norm2dplus = orig_norm
        jax.nn.elu = orig_elu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mm", action="store_true")
    ap.add_argument("--stubs", action="store_true")
    args = ap.parse_args()
    print(f"device: {jax.devices()[0].device_kind}", flush=True)

    k2 = jax.random.PRNGKey(2)
    x = jax.random.uniform(k2, (2, N_FRAMES, *DATA_SHAPE))
    labels = jnp.zeros((N_FRAMES,), jnp.int32)

    base = fwd_time("baseline", x, labels)
    if args.stubs:
        nn_ = fwd_time("no-norm", x, labels, stub_norm=True)
        na = fwd_time("no-act", x, labels, stub_act=True)
        print(f"  norm in-context: {(base-nn_)*1e3:.2f} ms   "
              f"act in-context: {(base-na)*1e3:.2f} ms", flush=True)

    if args.mm:
        def mm_case(name, M, K, N, dtype=jnp.bfloat16):
            ka, kb = jax.random.split(jax.random.PRNGKey(7))
            a = jax.random.normal(ka, (M, K), dtype)
            b = jax.random.normal(kb, (K, N), dtype)
            fl = 2 * M * K * N
            dt = scan_time_max(
                lambda w, v: jax.lax.dot_general(
                    v, w, (((1,), (0,)), ((), ())),
                    preferred_element_type=dtype),
                b, a, iters=30)
            print(f"matmul {name}: {dt*1e3:.3f} ms  {fl/dt/1e12:.1f} TFLOP/s",
                  flush=True)

        mm_case("fullres-eq [368640x1728]x[...x192]", 60 * 96 * 64,
                9 * 192, 192)
        mm_case("halfres-eq [92160x3456]x[...x384]", 60 * 48 * 32,
                9 * 384, 384)
        mm_case("square-4k", 4096, 4096, 4096)

        def conv_case(name, spatial, ci, co, batch=60, dil=1):
            kx, kk = jax.random.split(jax.random.PRNGKey(11))
            xb = jax.random.normal(kx, (batch, *spatial, ci), jnp.bfloat16)
            kern = jax.random.normal(kk, (3, 3, ci, co), jnp.bfloat16)
            fl = 2 * batch * spatial[0] * spatial[1] * 9 * ci * co
            dt = scan_time_max(
                lambda k, v: jax.lax.conv_general_dilated(
                    v, k, (1, 1), "SAME", rhs_dilation=(dil, dil),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    preferred_element_type=jnp.bfloat16),
                kern, xb, iters=30)
            print(f"conv {name}: {dt*1e3:.3f} ms  {fl/dt/1e12:.1f} TFLOP/s",
                  flush=True)

        conv_case("96x64 192->192", (96, 64), 192, 192)
        conv_case("96x64 256->256", (96, 64), 256, 256)
        conv_case("48x32 384->384", (48, 32), 384, 384)
        conv_case("48x32 384->384 dil2", (48, 32), 384, 384, dil=2)


if __name__ == "__main__":
    main()
