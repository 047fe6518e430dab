"""Jitted DP train steps for flows and NCSN + the noisy-Glow fine-tune chain.

Equivalents of train_glow.py / train_ncsn.py / train_noisy_glow.py training
math. Each step is one jitted function with donated state; with a mesh, the
batch axis is sharded and XLA emits the gradient all-reduce, which it hands
to NCCL on GPUs (replacing ``strategy.run`` + ``ReduceOp.SUM``,
train_glow.py:50-60).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..bijectors import FlowModel
from ..models.ncsn.utils import dsm_loss
from ..parallel import batch_sharding, replicated
from .checkpoint import CheckpointManager
from .train_utils import ema_update, setup_optimizer


def init_train_state(params: Any, optimizer: optax.GradientTransformation,
                     ema: bool = False) -> dict:
    state = {"params": params, "opt_state": optimizer.init(params),
             "step": jnp.asarray(0)}
    if ema:
        state["ema_params"] = jax.tree_util.tree_map(jnp.copy, params)
    return state


# ---------------------------------------------------------------------------
# flows (train_glow.py:29-44; train_noisy_glow.py:30-38)
# ---------------------------------------------------------------------------

def make_flow_train_step(model: FlowModel,
                         optimizer: optax.GradientTransformation,
                         noise_sigma: Optional[float] = None,
                         mesh=None) -> Callable:
    """Returns ``step(state, batch, rng) -> (state, loss)``.

    ``noise_sigma`` set -> noisy-Glow fine-tuning on ``X + sigma * eps``
    (train_noisy_glow.py:30-38). Loss is mean NLL over the global batch.
    """

    def loss_fn(params, batch, rng):
        k_noise, k_deq = jax.random.split(rng)
        if noise_sigma is not None:
            batch = batch + noise_sigma * jax.random.normal(
                k_noise, batch.shape, batch.dtype)
        return -jnp.mean(model.log_prob(params, batch, k_deq))

    def step(state, batch, rng):
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch,
                                                  rng)
        updates, opt_state = optimizer.update(grads, state["opt_state"],
                                              state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = dict(state, params=params, opt_state=opt_state,
                         step=state["step"] + 1)
        return new_state, loss

    def eval_loss(state, batch, rng):
        return loss_fn(state["params"], batch, rng)

    return _jit_with_mesh(step, eval_loss, mesh)


# ---------------------------------------------------------------------------
# NCSN (train_ncsn.py:26-75)
# ---------------------------------------------------------------------------

def make_ncsn_train_step(model_apply: Callable, sigmas,
                         optimizer: optax.GradientTransformation,
                         ema_decay: Optional[float] = None,
                         per_sample_sigma: bool = True,
                         mesh=None) -> Callable:
    sigmas = jnp.asarray(sigmas)

    def loss_fn(params, batch, rng):
        return dsm_loss(model_apply, params, batch, sigmas, rng,
                        per_sample_sigma=per_sample_sigma)

    def step(state, batch, rng):
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch,
                                                  rng)
        updates, opt_state = optimizer.update(grads, state["opt_state"],
                                              state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = dict(state, params=params, opt_state=opt_state,
                         step=state["step"] + 1)
        if ema_decay is not None and "ema_params" in state:
            new_state["ema_params"] = ema_update(state["ema_params"], params,
                                                 ema_decay)
        return new_state, loss

    def eval_loss(state, batch, rng):
        params = state.get("ema_params", state["params"]) \
            if ema_decay is not None else state["params"]
        return loss_fn(params, batch, rng)

    return _jit_with_mesh(step, eval_loss, mesh)


def _jit_with_mesh(step, eval_loss, mesh):
    if mesh is None:
        return jax.jit(step, donate_argnums=0), jax.jit(eval_loss)
    repl = replicated(mesh)
    data = batch_sharding(mesh)
    jstep = jax.jit(step, donate_argnums=0,
                    in_shardings=(repl, data, repl),
                    out_shardings=(repl, repl))
    # eval infers the batch sharding from the committed input: the final
    # partial eval batch (drop_remainder=False) may not divide the mesh,
    # in which case put_global_batch replicates it and forcing a
    # batch-sharded in_sharding here would raise
    jeval = jax.jit(eval_loss, out_shardings=repl)
    return jstep, jeval


# ---------------------------------------------------------------------------
# noisy-Glow chain (train_noisy_glow.py:187-360)
# ---------------------------------------------------------------------------

def train_noisy_glow_chain(model: FlowModel, init_params, sigmas,
                           ds_train, ds_test, *,
                           optimizer_name: str = "adamax",
                           learning_rate: float = 1e-3,
                           clipnorm=None,
                           n_epochs_per_sigma: int = 20,
                           batch_size: int = 32,
                           output_dir: str = ".",
                           restore_path: Optional[str] = None,
                           rng: Optional[jax.Array] = None,
                           mesh=None,
                           reinit_actnorm: bool = False,
                           reinit_minibatch=None):
    """Serially fine-tune a Glow model at each noise level.

    For each sigma (descending): restore the previous level's weights,
    train on ``X + sigma * eps``, save under ``sigma_{round(sigma,2)}/ckpts``
    — the directory contract run_basis_sep consumes
    (run_basis_sep.py:284-285).

    ``reinit_actnorm``: before each level's fine-tune, re-anchor the
    ActNorm data-dependent stats on a sigma-noised minibatch
    (FlowModel.reinit_data_dependent). Extension beyond the reference
    (whose chain only fine-tunes): at large sigma the inherited
    activations sit far outside the couplings' fitted range, coupling
    log-scales saturate, and scores come out ~1e8 x the smoothed-score
    scale; one re-anchor pass restores calibration (measured: log p
    -2.5e13 -> -7.3e3, the ideal Gaussian value, on the digits corpus)
    that fine-tuning alone needs thousands of steps to recover.
    """
    from .loop import LoopConfig, run_training

    rng = rng if rng is not None else jax.random.PRNGKey(0)
    optimizer = setup_optimizer(optimizer_name, learning_rate,
                                clipnorm=clipnorm)
    params = init_params
    prev_ckpt_dir = restore_path
    save_dirs = {}

    # one jitted step shared by every noise level: the perturbation
    # ``X + sigma * eps`` is applied to the batch outside the step, so
    # changing sigma never recompiles (10 levels x a multi-minute Glow
    # compile otherwise)
    step, eval_loss = make_flow_train_step(model, optimizer, mesh=mesh)

    class _NoisyView:
        def __init__(self, ds, sigma, seed):
            self.ds, self.sigma = ds, float(sigma)
            self._rng = np.random.RandomState(seed)
            self.batch_size = ds.batch_size

        def __len__(self):
            return len(self.ds)

        @property
        def n_examples(self):
            return self.ds.n_examples

        @property
        def n_global(self):
            return getattr(self.ds, "n_global", self.ds.n_examples)

        def __iter__(self):
            for batch in self.ds:
                yield (batch + self.sigma * self._rng.randn(*batch.shape)
                       ).astype(batch.dtype)

    for li, sigma in enumerate(np.asarray(sigmas)):
        sigma_dir = os.path.join(output_dir, f"sigma_{round(float(sigma), 2)}")
        os.makedirs(sigma_dir, exist_ok=True)
        state = init_train_state(params, optimizer)
        if prev_ckpt_dir is not None:
            mgr = CheckpointManager(prev_ckpt_dir)
            state, _ = mgr.restore_latest(state, strict=False)
            print(f"Restored previous level weights from {prev_ckpt_dir}")
        if reinit_actnorm:
            # the re-anchor stats must be identical on every process: under
            # --multihost ds_train is the per-host shard with a per-host
            # shuffle, so drawing from it would give each host different
            # ActNorm params inside an SPMD step that declares them
            # replicated. Prefer the caller-supplied host-consistent
            # minibatch (resolve_dataset's `minibatch` is sliced from the
            # full set before host sharding); the noise is seeded per level
            # and therefore host-consistent either way.
            if reinit_minibatch is not None:
                clean = np.asarray(reinit_minibatch)
                noise = np.random.RandomState(3000 + li).randn(*clean.shape)
                nb = jnp.asarray(clean + float(sigma) * noise, jnp.float32)
            else:
                nb = jnp.asarray(next(iter(_NoisyView(ds_train, sigma,
                                                      3000 + li))))
            state = dict(state,
                         params=model.reinit_data_dependent(state["params"],
                                                            nb))
            print(f"Re-anchored ActNorm stats on a sigma={float(sigma):.4f} "
                  f"minibatch")

        cfg = LoopConfig(n_epochs=n_epochs_per_sigma, batch_size=batch_size,
                         output_dir=sigma_dir, ckpt_dir="ckpts")
        rng, loop_rng = jax.random.split(rng)
        result = run_training(
            state, step, eval_loss,
            _NoisyView(ds_train, sigma, 1000 + li),
            _NoisyView(ds_test, sigma, 2000 + li),
            cfg, loop_rng, mesh=mesh)
        params = result.state["params"]
        prev_ckpt_dir = os.path.join(sigma_dir, "ckpts")
        save_dirs[float(sigma)] = prev_ckpt_dir
        print(f"sigma={float(sigma):.4f} done -> {prev_ckpt_dir}")
    return save_dirs
