#!/usr/bin/env python
"""XLA's bf16 3x3 stride-1 conv at the score networks' three hot classes.

Classes (batch, H, W, C_in -> C_out):
  * 32x32@128: the image-path NCSNv1 (128 filters), 50 frames;
  * 96x64@192->384 and 48x32@384: the melspec NCSNv1 (192 filters),
    30 frames.

Each conv runs inside a ``lax.scan`` that CARRIES the iterate and folds in
``max(y)`` (a max over the output cannot be pushed into the contraction,
so XLA must compute the whole conv every step). The time per conv is the
SLOPE between two scan lengths, so dispatch and feedback overheads cancel.
FLOP rates are computed from the shapes. Prints one JSON line per class.

Usage: python benchmarks/profile_conv.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.utils.profiling import device_report, nvidia_smi

CLASSES = (("32x32@128", 50, 32, 32, 128, 128),
           ("96x64@192->384", 30, 96, 64, 192, 384),
           ("48x32@384", 30, 48, 32, 384, 384))
SHORT, LONG = 10, 40
REPS = 3


def conv(kernel, x):
    return jax.lax.conv_general_dilated(
        x, kernel, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def scan_time(kernel, x, length):
    """Best-of-REPS wall-clock of ``length`` chained convs."""
    @jax.jit
    def loop(k, x0):
        def body(carry, _):
            m = jnp.max(conv(k, carry)).astype(carry.dtype)
            return carry * 0.999 + m * 1e-6, None
        out, _ = jax.lax.scan(body, x0, None, length=length)
        return jnp.sum(out)

    jax.block_until_ready(loop(kernel, x))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(kernel, x))
        best = min(best, time.perf_counter() - t0)
    return best


def slope_time(kernel, x, short=SHORT, long=LONG):
    """Seconds per conv: ``(t(long) - t(short)) / (long - short)``."""
    return ((scan_time(kernel, x, long) - scan_time(kernel, x, short))
            / (long - short))


def main(classes=CLASSES, short=SHORT, long=LONG):
    device = device_report()
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"jax device: {json.dumps(device)}")
    kx, kk = jax.random.split(jax.random.PRNGKey(0))
    for name, n, h, w, cin, cout in classes:
        x = jax.random.normal(kx, (n, h, w, cin), jnp.bfloat16)
        k = jax.random.normal(kk, (3, 3, cin, cout), jnp.bfloat16) * 0.05
        dt = slope_time(k, x, short, long)
        flops = 2 * n * h * w * 9 * cin * cout
        print(json.dumps({"metric": "xla_conv_bf16", "class": name,
                          "batch": n, "ms": dt * 1e3,
                          "tflop_per_s": flops / dt / 1e12 if dt > 0
                          else None, "device": device}))


if __name__ == "__main__":
    main()
