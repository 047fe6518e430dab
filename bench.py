#!/usr/bin/env python
"""Headline benchmark: BASIS separation of a 1-minute piano+violin mix.

Reference baseline (BASELINE.md): 1411.5 s on a 4-GPU host for the exact
same computation — NCSNv1 (192 filters), 30 mel-spectrogram frames
[30, 96, 64, 1], 10 noise levels x T=100 Langevin steps x 2 score models
(2,000 score-network forwards), run_basis_sep.py driver.

Here each noise level is one jitted T-step scan with both models evaluated
per step. Model weights are random — identical FLOPs/memory traffic to
trained weights, so wall-clock is representative without shipping
checkpoints.

Prints the device it ran on (``nvidia-smi`` name and power limit, JAX
platform, kind and count), then one JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.parallel import (make_mesh, make_source_mesh,
                                         pad_to_multiple, params_by_source,
                                         replicate, shard_batch,
                                         source_sharding)
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           ncsn_score_fn,
                                           source_sharded_ncsn_score,
                                           stack_pytrees)
from audiosourcesep_tpu.utils.profiling import (device_report, nvidia_smi,
                                                steady_state)

BASELINE_SECONDS = 1411.5  # basis_sep_results/beethoven_sonata_1_sep_1min

# benchmark shape: the reference's 1-minute separation workload
N_FRAMES = 30
DATA_SHAPE = (96, 64, 1)
N_FILTERS = 192
NUM_CLASSES = 10
T = 100


def main():
    t_start = time.time()
    device = device_report()
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"jax device: {json.dumps(device)}")

    sigmas = get_sigmas(1.0, 0.01, NUM_CLASSES, "logarithmic")
    # bf16 convs (norm stats and the Langevin update stay f32)
    model = get_score_model("v1", DATA_SHAPE, N_FILTERS, NUM_CLASSES,
                            compute_dtype=jnp.bfloat16)

    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 5)
    jax.block_until_ready(k0)
    t_backend = time.time() - t_start   # device init + first tiny compile
    p1 = model.init_params(k0)
    p2 = model.init_params(k1)
    stacked = jax.block_until_ready(stack_pytrees(p1, p2))
    t_params = time.time() - t_start - t_backend

    mixed = jax.random.normal(k2, (N_FRAMES, *DATA_SHAPE)) * 0.2 + 0.5
    x_init = jax.random.uniform(k3, (2, N_FRAMES, *DATA_SHAPE))

    # several devices: the 2-D (source, frame) mesh — each device holds ONE
    # model's params and runs a plain conv stack on its frame shard. Falls
    # back to frame-only sharding on odd device counts.
    n_dev_total = jax.device_count()
    shard_sources = n_dev_total > 1 and n_dev_total % 2 == 0
    mesh = (make_source_mesh(2) if shard_sources
            else make_mesh() if n_dev_total > 1 else None)
    if mesh is not None:
        n_frame_dev = (mesh.devices.shape[1] if shard_sources
                       else mesh.devices.size)
        padded = pad_to_multiple(N_FRAMES, n_frame_dev)
        if padded != N_FRAMES:
            pad = padded - N_FRAMES
            mixed = jnp.pad(mixed, [(0, pad), (0, 0), (0, 0), (0, 0)],
                            mode="wrap")
            x_init = jnp.pad(x_init,
                             [(0, 0), (0, pad), (0, 0), (0, 0), (0, 0)],
                             mode="wrap")
        mixed = shard_batch(mixed, mesh, batch_axis=0)
        if shard_sources:
            x_init = jax.device_put(x_init, source_sharding(mesh))
            stacked = params_by_source(stacked, mesh)
        else:
            x_init = shard_batch(x_init, mesh, batch_axis=1)
            stacked = replicate(stacked, mesh)

    cfg = BasisConfig(T=T, delta=2e-5, data_type="melspec", scale="dB",
                      collect_trajectory=False)
    score = (source_sharded_ncsn_score(model.apply, mesh) if shard_sources
             else ncsn_score_fn(model.apply))

    def run(key):
        out, _ = basis_separate_per_level(score, stacked, mixed, x_init,
                                          sigmas, key, cfg)
        return jax.block_until_ready(out)

    # compile excluded (one-time cost); steady state: best of 2
    compile_and_first, elapsed, out = steady_state(run, k4)

    assert bool(jnp.isfinite(out).all()), "non-finite separation output"

    # XLA cost analysis: 7.728 TFLOP per 1-model forward at batch 30; the
    # anneal is NUM_CLASSES*T steps x 2 models
    total_flops = 2 * NUM_CLASSES * T * 7.728e12
    print(json.dumps({
        "metric": "basis_separation_1min_mix_wallclock",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / elapsed, 2),
        "score_evals_per_s": round(2 * NUM_CLASSES * T * N_FRAMES / elapsed),
        "device": device,
    }))
    print(f"# first_call={compile_and_first:.1f}s  "
          f"steady_state={elapsed:.3f}s  "
          f"sustained={total_flops / elapsed / 1e12:.1f} TFLOP/s",
          file=sys.stderr)
    print(f"# cold-start phases: backend+first-compile={t_backend:.1f}s  "
          f"param-init={t_params:.1f}s  "
          f"first-run-minus-steady={compile_and_first - elapsed:.1f}s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
