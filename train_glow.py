#!/usr/bin/env python
"""Train a Glow normalizing flow on mel-spectrogram patches (or toy images).

CLI contract follows /root/reference/train_glow.py:349-399; the training
loop runs as jitted SPMD data-parallel steps over the device mesh.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu import cli
from audiosourcesep_tpu.models import build_glow
from audiosourcesep_tpu.parallel import (make_mesh_for_batch,
                                         put_global_batch, replicate)
from audiosourcesep_tpu.training import (CheckpointManager, LoopConfig,
                                         add_figure, image_grid,
                                         init_train_state,
                                         make_flow_train_step,
                                         run_training, setup_optimizer,
                                         setup_tensorboard)
from audiosourcesep_tpu.utils import total_trainable_variables


def main(args):
    cli.maybe_init_multihost(args)
    args = cli.apply_config_override(args)
    data = cli.resolve_dataset(args)

    if args.output == "trained_flow":
        args.output = (f"glow_{args.dataset.replace('/', '_')}"
                       f"_L{args.L}_K{args.K}_{args.n_filters}"
                       f"_{getattr(args, 'scale', 'img')}")
    log_file = cli.setup_output_dir(args.output, args.debug)
    os.makedirs("generated_samples", exist_ok=True)
    train_writer, test_writer = setup_tensorboard()

    rng = jax.random.PRNGKey(args.seed)
    rng, init_key = jax.random.split(rng)
    model, params = build_glow(
        init_key, jnp.asarray(data["minibatch"], jnp.float32),
        data["data_shape"], L=args.L, K=args.K, n_filters=args.n_filters,
        learntop=args.learntop, data_type=data["data_type"],
        use_logit=args.use_logit, alpha=args.alpha or 1e-6,
        minval=data["minval"], maxval=data["maxval"])
    print(f"Total Trainable Variables: "
          f"{total_trainable_variables(params):,}")

    optimizer = setup_optimizer(args.optimizer, args.learning_rate,
                                clipnorm=getattr(args, "clipnorm", None))
    state = init_train_state(params, optimizer)

    mesh = make_mesh_for_batch(args.batch_size)
    if mesh is not None:
        state = replicate(state, mesh)
    step, eval_loss = make_flow_train_step(model, optimizer, mesh=mesh)

    if args.restore is not None:
        mgr = CheckpointManager(os.path.join(args.restore, "ckpts"))
        state, restored_step = mgr.restore_latest(state)
        assert restored_step > 0
        print(f"Model restored from {args.restore} at step {restored_step}")

    sample_jit = jax.jit(lambda p, k: model.sample(p, k, 32))

    def sample_fn(state, epoch, rng):
        samples = sample_jit(state["params"], rng)
        samples = np.asarray(samples).reshape(32, *data["data_shape"])
        samples = np.clip(samples, data["minval"], data["maxval"])
        np.save(os.path.join("generated_samples",
                             f"generated_samples_{epoch}"), samples)
        add_figure(train_writer, "32 generated samples",
                   image_grid(samples, data["data_shape"], data["data_type"]),
                   epoch)

    cli.print_params(args, train_writer)
    cfg = LoopConfig(
        n_epochs=args.n_epochs, batch_size=args.batch_size,
        val_every_epochs=max(args.n_epochs // 100, 1),
        sample_every_epochs=max(args.n_epochs // 10, 1))
    result = run_training(state, step, eval_loss, data["ds_train"],
                          data["ds_test"], cfg, rng, sample_fn=sample_fn,
                          train_writer=train_writer, test_writer=test_writer,
                          mesh=mesh)
    print(f"Training time: {result.training_time:.1f}s; "
          f"saved at {result.save_path}")
    # bits/dim (image) / bits-per-pixel (melspec) on the test set — the
    # thesis's parity metric (Tables 3.1/3.4)
    bpd_fn = jax.jit(lambda p, b, k: jnp.mean(model.bits_per_dim(p, b, k)))
    bpds = []
    rng_eval = jax.random.PRNGKey(123)
    for batch in data["ds_test"]:
        rng_eval, k = jax.random.split(rng_eval)
        # route through put_global_batch: under --multihost the params are
        # global (cross-process) arrays — a raw process-local batch inside
        # the same jit errors/hangs before the end-of-training barrier
        batch_dev = put_global_batch(np.asarray(batch, np.float32), mesh)
        bpds.append(float(bpd_fn(result.state["params"], batch_dev, k)))
    if bpds and jax.process_index() == 0:
        bits_raw = float(np.mean(bpds))
        print(f"Validation bits/dim: {bits_raw:.4f}")
        if data["data_type"] == "melspec":
            # Thesis Table 3.4 convention (reference flow_builder.py:85-90
            # applies SpecPreprocessing before the flow): bits of the
            # [0,1]-RESCALED variable y = (x - minval)/span. Change of
            # variables p_x(x) = p_y(y)/span, so per dim
            # bits_y = bits_x - log2(span); span = maxval - minval dB.
            span = float(data["maxval"]) - float(data["minval"])
            bits_rescaled = bits_raw - float(np.log2(span))
            print(f"Validation bits/px ([0,1]-rescale convention, "
                  f"span={span:g} dB, = raw - log2(span)): "
                  f"{bits_rescaled:.4f}")
    if getattr(args, "multihost", False):
        # orderly multi-process teardown: a process exiting while peers are
        # still running trips the coordination-service heartbeat
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("end_of_training")
        jax.distributed.shutdown()
    log_file.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Train Glow")
    parser.add_argument("--dataset", type=str, default="mnist",
                        help="mnist | cifar10 | melspec dataset dirpath")
    parser.add_argument("--output", type=str, default="trained_flow")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--restore", type=str, default=None,
                        help="directory of a saved model to restore")
    parser.add_argument("--config", type=str,
                        help="YAML config overriding all hyperparameters")
    parser.add_argument("--seed", type=int, default=0)
    # spectrogram parameters
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    # model
    parser.add_argument("--L", type=int, default=3)
    parser.add_argument("--K", type=int, default=32)
    parser.add_argument("--n_filters", type=int, default=512)
    parser.add_argument("--learntop", action="store_true")
    parser.add_argument("--l2_reg", type=float, default=None)
    # optimization
    parser.add_argument("--n_epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--optimizer", type=str, default="adamax")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--clipnorm", type=float, default=None,
                        help="optional global-norm gradient clip "
                             "(extension; the reference has none — "
                             "guards the loss-jump excursions its "
                             "detector only snapshots)")
    # preprocessing
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=None)
    cli.add_multihost_flags(parser)
    main(parser.parse_args())
