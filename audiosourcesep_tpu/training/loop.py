"""Generic distributed training loop shared by the flow and NCSN trainers.

Re-designs the reference's custom loops (train_glow.py:23-181,
train_ncsn.py:21-180): same operational behavior — NaN/Inf abort after
saving state, loss-jump snapshots, periodic validation with best-checkpoint,
periodic sampling — with the per-step compute as one jitted, donated,
DP-sharded function instead of ``strategy.run`` + NCCL reduce.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel import put_global_batch
from .checkpoint import CheckpointManager
from .train_utils import is_bad


@dataclass
class LoopConfig:
    n_epochs: int = 10
    batch_size: int = 32
    losses_per_epoch: int = 10        # TB points per epoch (reference: 10)
    val_every_epochs: int = 1
    sample_every_epochs: Optional[int] = None
    loss_jump_threshold: Optional[float] = 1e6
    ckpt_dir: str = "./ckpts"
    issues_ckpt_dir: str = "./ckpts_issues"
    max_to_keep: int = 5
    output_dir: str = "."
    # best-val snapshots are taken as cheap DEVICE-side copies on every
    # improvement, but written to disk at most this often (plus once at
    # the end). A full train-state write is a large device->host transfer
    # (~1 GB for the 67M-param NCSN); each write prints its duration. 0
    # restores the reference's write-every-improvement behavior.
    ckpt_min_interval_s: float = 600.0


@dataclass
class LoopResult:
    state: Any
    training_time: float
    save_path: Optional[str]
    aborted_nan: bool = False
    history: list = field(default_factory=list)


def _timed_save(manager: CheckpointManager, state: Any, step: int) -> str:
    t0 = time.time()
    path = manager.save(state, step)
    print(f"Model Saved at {path} in {time.time() - t0:.3f} s")
    return path


def run_training(state: Any,
                 train_step: Callable,     # (state, batch, rng) -> (state, loss)
                 eval_loss: Callable,      # (state, batch, rng) -> loss
                 ds_train, ds_test,
                 config: LoopConfig,
                 rng: jax.Array,
                 sample_fn: Optional[Callable] = None,  # (state, epoch, rng)
                 train_writer=None, test_writer=None,
                 mesh=None) -> LoopResult:
    manager = CheckpointManager(
        os.path.join(config.output_dir, config.ckpt_dir),
        config.max_to_keep)
    manager_issues = (CheckpointManager(
        os.path.join(config.output_dir, config.issues_ckpt_dir), 3)
        if config.loss_jump_threshold else None)

    def put(batch):
        return put_global_batch(batch, mesh)

    # multi-host: every process runs the same control flow on replicated
    # losses, but only process 0 writes checkpoints
    is_main = jax.process_index() == 0

    # TB step axis follows the reference's GLOBAL convention (global batch
    # over global example count); per-host shards would advance the axis
    # num_hosts-times too fast
    n_train = max(getattr(ds_train, "n_global", ds_train.n_examples), 1)
    steps_per_epoch = max(len(ds_train), 1)
    log_every = max(steps_per_epoch // config.losses_per_epoch, 1)

    count_step = int(np.asarray(state["step"]))
    min_val_loss = np.inf
    best_state = None
    best_step = written_best_step = -1
    last_ckpt_write = -np.inf
    prev_history_avg = None
    is_nan_loss = False
    history = []
    save_path = None
    t0 = time.time()

    for epoch in range(1, config.n_epochs + 1):
        if is_nan_loss:
            break
        epoch_losses = []
        window_losses = []
        for batch in ds_train:
            rng, step_rng = jax.random.split(rng)
            state, loss = train_step(state, put(batch), step_rng)
            window_losses.append(loss)
            count_step += 1

            if count_step % log_every == 0:
                loss_val = float(jax.device_get(loss))
                epoch_losses.extend(
                    float(jax.device_get(l)) for l in window_losses)
                if is_bad(loss_val):
                    print(f"Nan or Inf Loss: {loss_val}")
                    is_nan_loss = True
                    break
                curr_avg = float(np.mean(
                    [float(jax.device_get(l)) for l in window_losses]))
                window_losses = []
                if train_writer is not None:
                    step_int = int(10 * count_step * config.batch_size
                                   / n_train)
                    train_writer.add_scalar("loss", curr_avg, step_int)
                if (manager_issues is not None
                        and prev_history_avg is not None
                        and curr_avg - prev_history_avg
                        > config.loss_jump_threshold):
                    print("Huge gap in the loss")
                    if is_main:
                        path = manager_issues.save(state, count_step)
                        print(f"Model weights saved at {path}")
                prev_history_avg = curr_avg
        epoch_losses.extend(float(jax.device_get(l)) for l in window_losses)

        # respect val_every_epochs regardless of run length (reference
        # cadence: every val_every epochs, /root/reference/train_ncsn.py:130);
        # always validate the final epoch so short runs still select a best
        run_val = (epoch % max(config.val_every_epochs, 1) == 0
                   or epoch == config.n_epochs)
        if run_val and not is_nan_loss:
            val_losses = []
            for batch in ds_test:
                rng, eval_rng = jax.random.split(rng)
                val_losses.append(float(jax.device_get(
                    eval_loss(state, put(batch), eval_rng))))
            val_loss = float(np.mean(val_losses)) if val_losses else np.nan
            if test_writer is not None:
                step_int = int(10 * count_step * config.batch_size / n_train)
                test_writer.add_scalar("loss", val_loss, step_int)
            train_loss = float(np.mean(epoch_losses)) if epoch_losses \
                else np.nan
            print(f"Epoch {epoch:03d}: Train Loss: {train_loss:.3f} "
                  f"Val Loss: {val_loss:3f}")
            history.append({"epoch": epoch, "train": train_loss,
                            "val": val_loss})
            if val_loss < min_val_loss:
                min_val_loss = val_loss
                state["step"] = jnp.asarray(count_step)
                # device-side copy (HBM->HBM, ~ms): the next train step
                # DONATES the current state's buffers, so a by-reference
                # snapshot would be reading deleted arrays
                best_state = jax.tree_util.tree_map(jnp.copy, state)
                best_step = count_step
                if is_main and (time.time() - last_ckpt_write
                                >= config.ckpt_min_interval_s):
                    save_path = _timed_save(manager, best_state, best_step)
                    written_best_step = best_step
                    last_ckpt_write = time.time()

        if (sample_fn is not None and config.sample_every_epochs
                and (epoch % config.sample_every_epochs == 0
                     or epoch == config.n_epochs)):
            rng, sample_rng = jax.random.split(rng)
            sample_fn(state, epoch, sample_rng)

    state["step"] = jnp.asarray(count_step)
    if is_main:
        if best_state is not None and written_best_step != best_step:
            _timed_save(manager, best_state, best_step)
        save_path = _timed_save(manager, state, count_step)
    return LoopResult(state=state, training_time=time.time() - t0,
                      save_path=save_path, aborted_nan=is_nan_loss,
                      history=history)
