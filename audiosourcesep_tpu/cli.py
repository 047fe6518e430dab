"""Shared CLI plumbing for the top-level scripts.

Mirrors the reference scripts' operational behavior: output directory
creation + chdir, stdout redirection to ``out.log`` unless ``--debug``
(train_glow.py:237-239), config-file override that wholesale replaces the
namespace while keeping dataset/output/debug/restore
(train_glow.py:186-192), and dataset resolution for melspec vs toy data.
"""

from __future__ import annotations

import argparse
import os
import sys

from .data import load_melspec_ds, load_toydata
from .training import get_config


def apply_config_override(args: argparse.Namespace,
                          keep=("dataset", "output", "debug", "restore",
                                "RESTORE", "song_dir", "inverse",
                                "model_type", "n_mixed")):
    """--config replaces all hyperparameters, preserving run-level flags."""
    if getattr(args, "config", None) is None:
        return args
    new_args = get_config(args.config)
    for k in keep:
        if hasattr(args, k):
            setattr(new_args, k, getattr(args, k))
    return new_args


def maybe_init_multihost(args) -> None:
    """Initialise multi-host JAX when ``--multihost`` is set.

    Must run before any other JAX API call in the process. Extends the
    reference (single-host ``MirroredStrategy`` only, SURVEY.md §2) to
    several hosts, one process each. The coordinator address, process count
    and process index are passed explicitly: nothing in the environment
    supplies them.
    """
    if not getattr(args, "multihost", False):
        return
    from .parallel import init_distributed

    init_distributed(getattr(args, "coordinator_address", None),
                     getattr(args, "num_processes", None),
                     getattr(args, "process_id", None))
    import jax

    print(f"Multi-host initialised: process {jax.process_index()} of "
          f"{jax.process_count()}, {jax.device_count()} global devices")


def add_multihost_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--multihost", action="store_true",
                        help="initialise jax.distributed, one process per "
                             "host; needs the three flags below")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0's coordinator")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def setup_output_dir(output: str, debug: bool):
    """mkdir + chdir + redirect stdout to out.log unless debug."""
    os.makedirs(output, exist_ok=True)
    os.chdir(output)
    log_file = open("out.log", "w")
    if not debug:
        sys.stdout = log_file
    return log_file


def resolve_dataset(args) -> dict:
    """Load data + data-scale metadata for a training run.

    melspec: ``args.dataset`` is a directory with train/ and test/ TFRecord
    subdirs (reference layout). mnist/cifar10: toy data.
    Returns dict with ds_train, ds_test, minibatch, n_train, n_test,
    data_shape, data_type, minval, maxval.
    """
    if args.dataset in ("mnist", "cifar10"):
        # multi-host: shard like the melspec branch below — each process
        # iterates a distinct slice at the local batch size; without this
        # every host would load the full set with the same shuffle seed and
        # put_global_batch would assemble batches of duplicated samples
        import jax
        n_proc, proc_id = jax.process_count(), jax.process_index()
        ds_train, ds_test, minibatch = load_toydata(
            args.dataset, max(args.batch_size // n_proc, 1),
            num_hosts=n_proc, host_id=proc_id)
        shape = tuple(minibatch.shape[1:])
        return dict(ds_train=ds_train, ds_test=ds_test, minibatch=minibatch,
                    # GLOBAL counts, matching the melspec branch's contract
                    n_train=ds_train.n_global, n_test=ds_test.n_global,
                    data_shape=shape, data_type="image",
                    minval=0.0, maxval=256.0)

    train_dir = os.path.join(args.dataset, "train")
    test_dir = os.path.join(args.dataset, "test")
    # multi-host: each process loads its own shard and iterates the local
    # slice of the global batch (reassembled at transfer time by
    # put_global_batch); args.batch_size stays the GLOBAL batch, matching
    # the reference's global/local split (out.log: "local_batch_size 8 of
    # global 32" on 4 replicas)
    import jax
    n_proc, proc_id = jax.process_count(), jax.process_index()
    local_bs = max(args.batch_size // n_proc, 1)
    ds_train, ds_test, minibatch, n_train, n_test = load_melspec_ds(
        train_dir, test_dir, batch_size=local_bs,
        num_hosts=n_proc, host_id=proc_id)
    shape = tuple(minibatch.shape[1:])
    scale = getattr(args, "scale", "dB")
    if scale == "power":
        minval, maxval = 1e-10, 100.0
    else:
        minval, maxval = -100.0, 20.0
    return dict(ds_train=ds_train, ds_test=ds_test, minibatch=minibatch,
                n_train=n_train, n_test=n_test, data_shape=shape,
                data_type="melspec", minval=minval, maxval=maxval)


def print_params(args, writer=None) -> str:
    template = "Parameters \n\t "
    for k, v in vars(args).items():
        template += f"{k} = {v} \n\t "
    print(template)
    if writer is not None:
        writer.add_text("Parameters", template, 0)
    return template


def melspec_display_meta(args) -> dict:
    return dict(sampling_rate=16000, fmin=125, fmax=7600)
