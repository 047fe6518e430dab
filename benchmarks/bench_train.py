#!/usr/bin/env python
"""Training-step throughput at the reference configurations.

Reference context (BASELINE.md): NCSNv1 piano training ran 400 epochs over
4,863 patches at global batch 32 on a 4-GPU host. This measures jitted
train-step wall-clock on the local accelerator for:

* NCSNv1 192 filters, batch 32, (96, 64, 1) — DSM loss + adam
* Glow L=3 K=40 512 filters, batch 32 — NLL + adamax

Prints one JSON line per benchmark.
"""

import json
import os
import sys
import time

# repo root on sys.path, so the script runs from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.models import build_glow
from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.training import (init_train_state,
                                         make_flow_train_step,
                                         make_ncsn_train_step,
                                         setup_optimizer)


def timeit(step, state, batch, n=20):
    rng = jax.random.PRNGKey(1)
    state, loss = step(state, batch, rng)      # compile
    jax.block_until_ready(loss)
    t0 = time.time()
    for i in range(n):
        rng, k = jax.random.split(rng)
        state, loss = step(state, batch, k)
    jax.block_until_ready(loss)
    return (time.time() - t0) / n


def main():
    results = {}

    # NCSN v1
    sigmas = get_sigmas(1.0, 0.01, 10, "logarithmic")
    model = get_score_model("v1", (96, 64, 1), 192, 10)
    params = model.init_params(jax.random.PRNGKey(0))
    opt = setup_optimizer("adam", 1e-3)
    state = init_train_state(params, opt)
    step, _ = make_ncsn_train_step(model.apply, sigmas, opt)
    batch = jax.random.normal(jax.random.PRNGKey(2), (32, 96, 64, 1))
    dt = timeit(step, state, batch)
    print(json.dumps({"metric": "ncsn_v1_192_train_step", "value":
                      round(dt * 1000, 2), "unit": "ms",
                      "steps_per_sec": round(1 / dt, 2)}))
    del state, params

    # Glow
    minibatch = jax.random.normal(jax.random.PRNGKey(3),
                                  (32, 96, 64, 1)) * 10 - 40
    gmodel, gparams = build_glow(jax.random.PRNGKey(4), minibatch,
                                 (96, 64, 1), L=3, K=40, n_filters=512,
                                 learntop=True, data_type="melspec",
                                 minval=-100.0, maxval=20.0)
    gopt = setup_optimizer("adamax", 1e-3)
    gstate = init_train_state(gparams, gopt)
    gstep, _ = make_flow_train_step(gmodel, gopt)
    dt = timeit(gstep, gstate, minibatch)
    print(json.dumps({"metric": "glow_L3_K40_512_train_step", "value":
                      round(dt * 1000, 2), "unit": "ms",
                      "steps_per_sec": round(1 / dt, 2)}))


if __name__ == "__main__":
    main()
