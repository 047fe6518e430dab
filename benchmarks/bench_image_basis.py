#!/usr/bin/env python
"""End-to-end image-path BASIS timing (thesis Table 3.2 protocol: 32x32
sources, NCSNv1 prior): the FULL anneal — 10 noise levels x T=100
Langevin steps x 2 models — with the same harness rules as bench.py
(``block_until_ready``-completed, best-of-2 steady state, random weights =
identical FLOPs to trained).

Usage: python benchmarks/bench_image_basis.py [--n_mixed 50] [--T 100]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           ncsn_score_fn, stack_pytrees)
from audiosourcesep_tpu.utils.profiling import steady_state

DATA_SHAPE = (32, 32, 1)
N_FILTERS = 128
NUM_CLASSES = 10


def time_variant(n_mixed: int, T: int, dtype):
    """Build + run the full anneal; returns ``(first_s, steady_s)``."""
    sigmas = get_sigmas(1.0, 0.01, NUM_CLASSES, "logarithmic")
    model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            compute_dtype=dtype)
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 5)
    stacked = stack_pytrees(model.init_params(k0), model.init_params(k1))
    mixed = jax.random.uniform(k2, (n_mixed, *DATA_SHAPE))
    x_init = jax.random.uniform(k3, (2, n_mixed, *DATA_SHAPE))
    cfg = BasisConfig(T=T, delta=2e-5, data_type="image",
                      collect_trajectory=False)
    score = ncsn_score_fn(model.apply)

    def run(key):
        out, _ = basis_separate_per_level(score, stacked, mixed, x_init,
                                          sigmas, key, cfg)
        return jax.block_until_ready(out)

    first, best, out = steady_state(run, k4)
    assert bool(jnp.isfinite(out).all())
    return first, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_mixed", type=int, default=50)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    args = ap.parse_args()
    dtype = jnp.bfloat16 if args.dtype == "bf16" else None

    first, best = time_variant(args.n_mixed, args.T, dtype)
    print(f"# first_call={first:.1f}s steady={best:.3f}s", file=sys.stderr)
    print(json.dumps({
        "metric": "basis_image_anneal_wallclock",
        "n_mixed": args.n_mixed,
        "T": args.T,
        "levels": NUM_CLASSES,
        "value": round(best, 3),
        "unit": "s",
    }))


if __name__ == "__main__":
    main()
