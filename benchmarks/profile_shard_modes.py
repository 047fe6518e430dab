#!/usr/bin/env python
"""Score-eval mode A/B at the 8-device per-device shard size.

Round-2 measured `ncsn_score_fn(mode='sequential')` (two plain batch-N
applies) ~7% faster than `mode='vmap'` (one batched-weight batch-2N
apply) at the full 30-frame batch. At the 8-device shard the per-apply
batch is only 4, where per-op overheads and small-matmul tiling may flip
the verdict — this reruns the REAL anneal at the shard size under both
modes. If 'vmap' wins small, the separation driver should pick the mode
by per-device batch.

Usage: python benchmarks/profile_shard_modes.py [n_frames]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.utils.profiling import steady_state
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           ncsn_score_fn, stack_pytrees)

DATA_SHAPE = (96, 64, 1)
N_FILTERS = 192
NUM_CLASSES = 10
T = 100


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    sigmas = get_sigmas(1.0, 0.01, NUM_CLASSES, "logarithmic")
    model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            compute_dtype=jnp.bfloat16)
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 5)
    p1 = model.init_params(k0)
    p2 = model.init_params(k1)
    stacked = stack_pytrees(p1, p2)
    jax.block_until_ready(stacked)

    mixed = jax.random.normal(k2, (n_frames, *DATA_SHAPE)) * 0.2 + 0.5
    x_init = jax.random.uniform(k3, (2, n_frames, *DATA_SHAPE))
    cfg = BasisConfig(T=T, delta=2e-5, data_type="melspec", scale="dB",
                      collect_trajectory=False)

    results = {}
    for mode in ("sequential", "vmap"):
        score = ncsn_score_fn(model.apply, mode=mode)

        def run(key):
            out, _ = basis_separate_per_level(score, stacked, mixed,
                                              x_init, sigmas, key, cfg)
            jax.block_until_ready(out)
            return out

        first, elapsed, out = steady_state(run, k4)
        assert bool(jnp.isfinite(out).all())
        results[mode] = round(elapsed, 3)
        print(f"# mode={mode}: first={first:.1f}s steady={elapsed:.3f}s",
              file=sys.stderr)

    results.update({
        "metric": "shard_score_mode_ab",
        "n_frames": n_frames,
        "vmap_vs_sequential": round(results["sequential"] / results["vmap"],
                                    3),
    })
    print(json.dumps(results))


if __name__ == "__main__":
    main()
