#!/usr/bin/env python
"""Train an NCSN (v1/v2) score network with denoising score matching.

CLI contract follows /root/reference/train_ncsn.py:182-371: same flags,
sigma schedules, EMA option, periodic Langevin sampling; compute runs as
jitted SPMD data-parallel steps.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu import cli
from audiosourcesep_tpu.models.ncsn import (anneal_langevin_dynamics,
                                            get_score_model, get_sigmas)
from audiosourcesep_tpu.parallel import make_mesh_for_batch, replicate
from audiosourcesep_tpu.training import (CheckpointManager, LoopConfig,
                                         add_figure, image_grid,
                                         init_train_state,
                                         make_ncsn_train_step, run_training,
                                         setup_optimizer, setup_tensorboard)
from audiosourcesep_tpu.utils import total_trainable_variables
from audiosourcesep_tpu.utils.profiling import peak_bytes_in_use


def preprocess(X, minval, maxval, use_logit, alpha):
    """Rescale to [0,1] (+ optional logit) — train_ncsn.py:287-292."""
    X = (X - minval) / (maxval - minval)
    if use_logit:
        X = X * (1.0 - 2 * alpha) + alpha
        X = np.log(X) - np.log1p(-X)
    return X.astype(np.float32)


def main(args):
    cli.maybe_init_multihost(args)
    args = cli.apply_config_override(args)
    data = cli.resolve_dataset(args)

    sigmas = get_sigmas(args.sigma1, args.sigmaL, args.num_classes,
                        args.progression)

    if args.output == "trained_ncsn":
        args.output = (f"ncsn{args.version}_{args.dataset.replace('/', '_')}"
                       f"_{args.n_filters}_{args.batch_size}"
                       f"_{getattr(args, 'scale', 'img')}")
    log_file = cli.setup_output_dir(args.output, args.debug)
    os.makedirs("generated_samples", exist_ok=True)
    train_writer, test_writer = setup_tensorboard()

    alpha = args.alpha or 1e-6
    for split in ("ds_train", "ds_test"):
        data[split].data = preprocess(data[split].data, data["minval"],
                                      data["maxval"], args.use_logit, alpha)

    model = get_score_model(args.version, data["data_shape"],
                            args.n_filters, args.num_classes, sigmas=sigmas,
                            logit_transform=args.use_logit)
    rng = jax.random.PRNGKey(args.seed)
    rng, init_key = jax.random.split(rng)
    params = model.init_params(init_key)
    print(f"Total Trainable Variables: "
          f"{total_trainable_variables(params):,}")

    optimizer = setup_optimizer(args.optimizer, args.learning_rate,
                                clipnorm=getattr(args, "clipnorm", None))
    state = init_train_state(params, optimizer, ema=args.ema)
    mesh = make_mesh_for_batch(args.batch_size)
    if mesh is not None:
        state = replicate(state, mesh)
    step, eval_loss = make_ncsn_train_step(
        model.apply, sigmas, optimizer,
        ema_decay=0.999 if args.ema else None, mesh=mesh)

    if args.restore is not None:
        mgr = CheckpointManager(os.path.join(args.restore, "ckpts"))
        state, restored_step = mgr.restore_latest(state)
        print(f"Model restored from {args.restore} at step {restored_step}")

    def sample_fn(state, epoch, rng):
        k_init, k_langevin = jax.random.split(rng)
        x_mod = jax.random.uniform(k_init, (32, *data["data_shape"]))
        if args.use_logit:
            x_mod = (1.0 - 2 * alpha) * x_mod + alpha
            x_mod = jnp.log(x_mod) - jnp.log1p(-x_mod)
        p = state.get("ema_params", state["params"])
        samples = anneal_langevin_dynamics(
            model.apply, p, x_mod, sigmas, k_langevin,
            n_steps_each=args.T, step_lr=args.step_lr, return_arr=True)
        samples = np.asarray(samples)
        np.save(os.path.join("generated_samples",
                             f"generated_samples_{epoch}"), samples)
        if np.isfinite(samples[-1]).all():
            add_figure(train_writer, "32 generated samples",
                       image_grid(samples[-1], data["data_shape"],
                                  data["data_type"]), epoch)
        else:
            train_writer.add_text(
                "display error",
                "Impossible to display spectrograms because of NaN values",
                epoch)

    cli.print_params(args, train_writer)
    cfg = LoopConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                     losses_per_epoch=5, val_every_epochs=10,
                     sample_every_epochs=args.sample_every)
    result = run_training(state, step, eval_loss, data["ds_train"],
                          data["ds_test"], cfg, rng, sample_fn=sample_fn,
                          train_writer=train_writer,
                          test_writer=test_writer, mesh=mesh)
    print(f"Training time: {result.training_time:.1f}s; "
          f"saved at {result.save_path}")
    print(f"peak_bytes_in_use: {peak_bytes_in_use()}")
    if getattr(args, "multihost", False):
        # orderly multi-process teardown: a process exiting while peers are
        # still running trips the coordination-service heartbeat
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("end_of_training")
        jax.distributed.shutdown()
    log_file.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Train NCSN")
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--output", type=str, default="trained_ncsn")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--restore", type=str, default=None)
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    # model
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--ema", action="store_true")
    parser.add_argument("--n_filters", type=int, default=192)
    # spectrograms
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    # sigma schedule
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--progression", type=str, default="logarithmic")
    # langevin
    parser.add_argument("--T", type=int, default=100)
    parser.add_argument("--sample_every", type=int, default=50,
                        help="epochs between Langevin sampling snapshots "
                             "(reference: every 50, train_ncsn.py:150)")
    parser.add_argument("--step_lr", type=float, default=2e-5)
    # optimization
    parser.add_argument("--n_epochs", type=int, default=400)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--clipnorm", type=float, default=None,
                        help="optional global-norm gradient clip")
    # preprocessing
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=None)
    cli.add_multihost_flags(parser)
    main(parser.parse_args())
