#!/usr/bin/env python
"""Flow++ bits/dim quality run on the offline digits cache.

Closes the last L1a quality cell: the reference declares its Flow++ path
untested (reference README.md:127, flow_flowpp.py:10-187) and ships no
number for it; this repo's Flow++ is correctness-fixed (sigmoid-squashed
variational dequant, proper coupling composition — docs/DESIGN.md
deviations table) and train-smoked (tests/test_flowpp.py). This script
records an actual bits/dim from the real model at reference scale
(flow_builder.py:149-189 defaults: 32 mixture components, 10 flow blocks,
96 filters) on the 32x32 digits stand-in cache.

Caveat (same as quality_glow_mnist.sh): with the sklearn-digits stand-in
the number is NOT comparable to published MNIST results; drop a real
mnist.npz into the cache and only the data swap remains. The variational
dequantization bound makes bits/dim an upper bound on the discrete NLL of
the quantized [0,256) variable.

Usage: python benchmarks/quality_flowpp_digits.py [n_epochs]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu.data import load_toydata
from audiosourcesep_tpu.models import build_flowpp
from audiosourcesep_tpu.training import (init_train_state,
                                         make_flow_train_step,
                                         setup_optimizer)

N_EPOCHS = 100
BATCH = 64
# reference flow_builder.py:149-151 defaults
N_COMPONENTS = 32
N_BLOCKS_FLOW = 10
N_BLOCKS_DEQUANT = 2
FILTERS = 96
HEADS = 4
# adam 1e-3 + clipnorm 1.0: the measured stable recipe (unclipped adam
# NaNs after ~50 steps — setup_optimizer docstring, tests/test_flowpp.py)
LR = 1e-3
CLIPNORM = 1.0
EVAL_DRAWS = 4  # dequant bound is stochastic; average a few draws


def main(n_epochs=None):
    n_epochs = n_epochs or N_EPOCHS
    ds_train, ds_test, minibatch = load_toydata("mnist", BATCH)
    data_shape = tuple(minibatch.shape[1:])

    t0 = time.time()
    model, params = build_flowpp(jax.random.PRNGKey(0),
                                 jnp.asarray(minibatch), data_shape,
                                 n_components=N_COMPONENTS,
                                 n_blocks_flow=N_BLOCKS_FLOW,
                                 n_blocks_dequant=N_BLOCKS_DEQUANT,
                                 filters=FILTERS, heads=HEADS)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"flowpp params: {n_params:,} ({time.time() - t0:.1f}s init)")

    opt = setup_optimizer("adam", LR, clipnorm=CLIPNORM)
    state = init_train_state(params, opt)
    step, _ = make_flow_train_step(model, opt)
    bpd_fn = jax.jit(lambda p, b, k: jnp.mean(model.bits_per_dim(p, b, k)))

    def val_bits(state, key):
        vals = []
        for i in range(EVAL_DRAWS):
            kd = jax.random.fold_in(key, i)
            vals.append(np.mean([float(bpd_fn(state["params"],
                                              jnp.asarray(b), kd))
                                 for b in ds_test]))
        return float(np.mean(vals))

    rng = jax.random.PRNGKey(1)
    t0, last_loss = time.time(), float("nan")
    for epoch in range(1, n_epochs + 1):
        for batch in ds_train:
            rng, k = jax.random.split(rng)
            state, loss = step(state, jnp.asarray(batch), k)
        last_loss = float(loss)
        if not np.isfinite(last_loss):
            print(f"ABORT: non-finite loss at epoch {epoch}")
            break
        if epoch % max(1, n_epochs // 10) == 0 or epoch == 1:
            vb = val_bits(state, jax.random.PRNGKey(100 + epoch))
            print(f"epoch {epoch}: train nll {last_loss:.1f} "
                  f"val bits/dim {vb:.4f} ({time.time() - t0:.0f}s)")

    final_bits = val_bits(state, jax.random.PRNGKey(999))
    print(json.dumps({
        "metric": "flowpp_bits_dim_digits_cache",
        "value": round(final_bits, 4),
        "unit": "bits/dim",
        "n_params": n_params,
        "epochs": n_epochs,
        "train_s": round(time.time() - t0, 1),
        "note": "digits stand-in cache, not MNIST; variational-dequant "
                "upper bound on discrete NLL",
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else None)
