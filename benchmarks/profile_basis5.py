#!/usr/bin/env python
"""Step-overhead profile: full BASIS level vs bare score forward.

bench.py r02 shows 117.6 ms/step end-to-end while the 2-model forward
alone is ~108-111 ms (profile_basis4). This measures one jitted level
(T=100 Langevin steps, one dispatch) and the Langevin update without the
score to locate the difference.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           ncsn_score_fn, stack_pytrees)

N_FRAMES = 30
DATA_SHAPE = (96, 64, 1)
N_FILTERS = 192
NUM_CLASSES = 10
T = 100


def main():
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    sigmas = get_sigmas(1.0, 0.01, NUM_CLASSES, "logarithmic")
    model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            compute_dtype=jnp.bfloat16)
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 5)
    p1, p2 = model.init_params(k0), model.init_params(k1)
    stacked = stack_pytrees(p1, p2)
    mixed = jax.random.normal(k2, (N_FRAMES, *DATA_SHAPE)) * 0.2 + 0.5
    x_init = jax.random.uniform(k3, (2, N_FRAMES, *DATA_SHAPE))
    score = ncsn_score_fn(model.apply)

    # one level (one dispatch, T steps) via the production path
    cfg1 = BasisConfig(T=T, delta=2e-5, data_type="melspec", scale="dB",
                       collect_trajectory=False)

    def one_level(key):
        out, _ = basis_separate_per_level(score, stacked, mixed, x_init,
                                          sigmas[:1], key, cfg1)
        jax.block_until_ready(out)
        return out

    one_level(k4)   # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        one_level(k4)
        best = min(best, time.perf_counter() - t0)
    print(f"one level, T={T}: {best:.3f} s  -> {best/T*1e3:.2f} ms/step "
          f"(incl dispatch)", flush=True)

    # ALL levels (the bench measurement, re-timed best-of-3)
    cfgL = BasisConfig(T=T, delta=2e-5, data_type="melspec", scale="dB",
                       collect_trajectory=False)

    def full(key):
        out, _ = basis_separate_per_level(score, stacked, mixed, x_init,
                                          sigmas, key, cfgL)
        jax.block_until_ready(out)
        return out

    full(k4)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        full(k4)
        best = min(best, time.perf_counter() - t0)
    print(f"all {NUM_CLASSES} levels: {best:.3f} s  "
          f"-> {best/(NUM_CLASSES*T)*1e3:.2f} ms/step", flush=True)


if __name__ == "__main__":
    main()
