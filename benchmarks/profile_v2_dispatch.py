#!/usr/bin/env python
"""NCSNv2-regime anneal timing: 200 noise levels x T=8 (melspec_ncsnv2.yml)
vs the v1 regime's 10 x 100.

The production driver dispatches one jitted T-step program per level
(`basis_separate_per_level`): at L=10 the per-dispatch host latency is
negligible, at L=200 it is 20x the dispatch count on programs 12.5x
shorter — this measures whether per-level dispatch hurts there, against
the fused single-program scan (`basis_separate`, same math,
equivalence-tested) as the alternative the driver would switch to.

Usage: python benchmarks/profile_v2_dispatch.py  (on the accelerator)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.utils.profiling import steady_state
from audiosourcesep_tpu.separation import (BasisConfig, basis_separate,
                                           basis_separate_per_level,
                                           make_stacked_ncsn_score,
                                           ncsn_score_fn, stack_pytrees)

N_FRAMES = 28
DATA_SHAPE = (96, 64, 1)
N_FILTERS = 128          # melspec_ncsnv2.yml
NUM_CLASSES = 200
T = 8


def main():
    sigmas = get_sigmas(30.0, 0.01, NUM_CLASSES, "logarithmic")
    model = get_score_model("v2", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            sigmas=sigmas, compute_dtype=jnp.bfloat16)
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 5)
    p1 = model.init_params(k0)
    p2 = model.init_params(k1)
    stacked = stack_pytrees(p1, p2)
    jax.block_until_ready(stacked)

    mixed = jax.random.normal(k2, (N_FRAMES, *DATA_SHAPE)) * 0.2 + 0.5
    x_init = jax.random.uniform(k3, (2, N_FRAMES, *DATA_SHAPE))
    cfg = BasisConfig(T=T, delta=7e-6, data_type="melspec", scale="dB",
                      collect_trajectory=False)

    score = ncsn_score_fn(model.apply)

    def run_per_level(key):
        out, _ = basis_separate_per_level(score, stacked, mixed, x_init,
                                          sigmas, key, cfg)
        jax.block_until_ready(out)
        return out

    first_pl, t_pl, out = steady_state(run_per_level, k4)
    assert bool(jnp.isfinite(out).all())
    print(f"# per-level: first={first_pl:.1f}s steady={t_pl:.3f}s",
          file=sys.stderr)

    # params enter as a jit ARGUMENT (a closure would bake 2x the model
    # into the HLO as constants)
    def _fused(params, m, x, k):
        score_st = make_stacked_ncsn_score(model.apply, params)
        return basis_separate(score_st, m, x, sigmas, k, cfg)[0]

    fused = jax.jit(_fused)

    def run_fused(key):
        out = fused(stacked, mixed, x_init, key)
        jax.block_until_ready(out)
        return out

    first_f, t_f, out = steady_state(run_fused, k4)
    assert bool(jnp.isfinite(out).all())
    print(f"# fused: first={first_f:.1f}s steady={t_f:.3f}s",
          file=sys.stderr)

    print(json.dumps({
        "metric": "ncsnv2_L200_T8_anneal",
        "per_level_s": round(t_pl, 3),
        "fused_s": round(t_f, 3),
        "dispatch_overhead_s": round(t_pl - t_f, 3),
        "dispatch_overhead_pct": round(100 * (t_pl / t_f - 1), 2),
        "levels": NUM_CLASSES, "T": T, "n_frames": N_FRAMES,
    }))


if __name__ == "__main__":
    main()
