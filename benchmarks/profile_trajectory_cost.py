#!/usr/bin/env python
"""Price the bench <-> production-driver delta (round-3 VERDICT weak #2).

``bench.py`` runs ``collect_trajectory=False``; the production CLI
(run_basis_sep.py:258-296) always collects the per-level trajectory the
reference saves as ``results_convergence.npz`` (run_basis_sep.py:436).
This measures both variants in one process at the CLI's frame count so
the steady-state delta is the trajectory cost alone; the companion
``benchmarks/cli_production_gap.sh`` then runs the real CLI and reports
its "Duration" line next to these numbers.

Usage: python benchmarks/profile_trajectory_cost.py [n_frames]
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
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 28
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
    score = ncsn_score_fn(model.apply)

    results = {}
    for collect in (False, True):
        cfg = BasisConfig(T=T, delta=2e-5, data_type="melspec", scale="dB",
                          collect_trajectory=collect)

        def run(key):
            out, traj = basis_separate_per_level(score, stacked, mixed,
                                                 x_init, sigmas, key, cfg)
            jax.block_until_ready(out)
            if traj is not None:
                jax.block_until_ready(traj)
            return out

        first, elapsed, out = steady_state(run, k4)
        assert bool(jnp.isfinite(out).all())
        results["traj" if collect else "no_traj"] = round(elapsed, 3)
        print(f"# collect_trajectory={collect}: first={first:.1f}s "
              f"steady={elapsed:.3f}s", file=sys.stderr)

    results.update({
        "metric": "trajectory_collection_overhead",
        "n_frames": n_frames,
        "overhead_s": round(results["traj"] - results["no_traj"], 3),
        "overhead_pct": round(100 * (results["traj"] / results["no_traj"]
                                     - 1), 2),
    })
    print(json.dumps(results))


if __name__ == "__main__":
    main()
