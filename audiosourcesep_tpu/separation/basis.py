"""BASIS: Bayesian Annealed SIgnal Separation as a single jitted scan.

Re-design of /root/reference/run_basis_sep.py:152-260. The reference runs an
eager Python loop with two sequential score-model calls per step and (for
Glow priors) checkpoint restores from disk between noise levels
(run_basis_sep.py:228-234). Here:

* both sources (and both models) are *stacked*: one score evaluation per
  step covers model1(x1) and model2(x2) inside one compiled program;
* the (noise level x step) loops are a double ``lax.scan`` compiled once;
* per-level Glow parameters are pre-stacked pytrees indexed on-device, so no
  host I/O ever interrupts the loop (SURVEY.md §7 stage 6);
* the frame batch axis shards across the device mesh for multi-chip runs.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .mixing import mixing_process

Array = jax.Array


class BasisConfig(NamedTuple):
    T: int = 100
    delta: float = 2e-5
    data_type: str = "melspec"
    scale: str = "dB"
    collect_trajectory: bool = True
    # Optional per-pixel score clip at +-score_clip/sigma. The ideal
    # sigma-smoothed score is O(|x - mu|/sigma^2) ~ a few/sigma, but
    # grad-through-flow scores (Glow priors) can blow past that scale
    # off-manifold and explode the Langevin at large eta (measured: the
    # K8/128f image Glow NaN'd within the first noise level). None = off
    # (NCSN scores are architecturally tame; the reference has no analog
    # because its glow branch never ran, run_basis_sep.py:386-390).
    score_clip: Optional[float] = None


def _clip_scores(scores: Array, sigma: Array, clip: Optional[float]):
    if clip is None:
        return scores
    bound = jnp.asarray(clip, scores.dtype) / sigma.astype(scores.dtype)
    return jnp.clip(scores, -bound, bound)


def stack_pytrees(*trees):
    """Stack identically-structured pytrees along a new leading axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def make_stacked_ncsn_score(model_apply: Callable, stacked_params
                            ) -> Callable:
    """Score fn over stacked sources from per-source stacked NCSN params.

    ``stacked_params`` has a leading source axis on every leaf (from
    :func:`stack_pytrees`); the returned function maps
    ``(x [K, N, ...], sigma_idx) -> scores [K, N, ...]`` with a single
    vmapped evaluation.
    """
    vapply = jax.vmap(model_apply, in_axes=(0, 0, None))

    def score(x: Array, sigma_idx: Array, level: Array) -> Array:
        del level
        return vapply(stacked_params, x, sigma_idx)

    return score


def ncsn_score_fn(model_apply: Callable, n_sources: int = 2,
                  mode: str = "sequential") -> Callable:
    """Parameter-explicit stacked NCSN score:
    ``score(params, x [K,N,...], sigma_idx, level) -> [K,N,...]``.

    ``mode='sequential'`` unrolls the K per-source applies as K plain conv
    stacks; ``'vmap'`` evaluates them as one batched-weight program. Both
    fuse into the same per-level program; the default is the plain-conv
    form.
    """
    if mode == "vmap":
        vapply = jax.vmap(model_apply, in_axes=(0, 0, None))

        def score(params, x: Array, sigma_idx: Array, level: Array) -> Array:
            del level
            return vapply(params, x, sigma_idx)
    else:
        def score(params, x: Array, sigma_idx: Array, level: Array) -> Array:
            del level
            outs = [
                model_apply(
                    jax.tree_util.tree_map(lambda p, _k=k: p[_k], params),
                    x[k], sigma_idx)
                for k in range(n_sources)]
            return jnp.stack(outs)

    return score


def source_sharded_ncsn_score(model_apply: Callable, mesh) -> Callable:
    """NCSN score over a 2-D ``(source, data)`` mesh: each device holds
    ONE model's params and evaluates it on its frame shard as a PLAIN conv
    stack at the full local batch.

    Frame-only sharding shrinks the per-apply conv batch as devices are
    added; with the source axis also sharded, each device runs 1 model at
    twice the frames, and the only cross-device traffic left in the anneal
    is the mixing softmax/logsumexp over the K=2 source axis (a KB-scale
    all-reduce per Langevin step, inserted by XLA from the global
    ``mixing_process`` math).

    ``shard_map`` (not GSPMD hints) so the per-device lowering is
    guaranteed: the local eval is an ordinary un-grouped conv program —
    the partitioner cannot fall back to a grouped/batched-weight conv
    lowering.

    Use with params device_put by :func:`parallel.params_by_source` and
    ``x`` by :func:`parallel.source_sharding`.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel import DATA_AXIS, SOURCE_AXIS

    n_mesh_sources = mesh.shape[SOURCE_AXIS]

    def local_eval(params, x, sigma_idx):
        # local views: params [1, ...] (one model), x [1, n_local, ...]
        p = jax.tree_util.tree_map(lambda a: a[0], params)
        return model_apply(p, x[0], sigma_idx)[None]

    smap = shard_map(local_eval, mesh=mesh,
                     in_specs=(P(SOURCE_AXIS), P(SOURCE_AXIS, DATA_AXIS),
                               P(DATA_AXIS)),
                     out_specs=P(SOURCE_AXIS, DATA_AXIS))

    def score(params, x: Array, sigma_idx: Array, level: Array) -> Array:
        del level
        # local_eval indexes p[0]/x[0]: only valid when the mesh source
        # axis exactly matches the stacked leading dim (local shard = 1);
        # any mismatch would silently evaluate the wrong model/source.
        lead = {leaf.shape[0] for leaf in jax.tree_util.tree_leaves(params)}
        if lead != {n_mesh_sources} or x.shape[0] != n_mesh_sources:
            raise ValueError(
                f"source-sharded score: mesh '{SOURCE_AXIS}' axis has size "
                f"{n_mesh_sources} but the stacked params lead with "
                f"{sorted(lead)} and x with {x.shape[0]}; these must all "
                "match so each chip holds exactly one model/source")
        return smap(params, x, sigma_idx)

    return score


def source_sharded_glow_score(log_prob_fn: Callable, mesh) -> Callable:
    """Glow score over a 2-D ``(source, data)`` mesh: each device holds
    ONE source's per-noise-level param stack and differentiates its own
    flow on its frame shard.

    Takes the SOURCE-major stack ``[K, L_sigma, ...]`` (vs
    :func:`glow_score_fn`'s level-major ``[L_sigma, K, ...]``) so each
    source's whole sigma chain is one contiguous leading-axis slice on its
    device row: sharding it halves per-device prior memory (the
    sigma-stacked 512-filter production flow is ~2.1 GB replicated) and
    the local eval lowers as one flow's PLAIN grad program — no
    batched-weight fallbacks, same rationale as
    :func:`source_sharded_ncsn_score`. The only cross-device traffic left
    in the anneal is the mixing logsumexp/softmax all-reduce XLA inserts
    from the global mixing math.

    Use with params device_put by :func:`parallel.params_by_source` and
    ``x`` by :func:`parallel.source_sharding`.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel import DATA_AXIS, SOURCE_AXIS

    n_mesh_sources = mesh.shape[SOURCE_AXIS]

    def local_eval(params, x, level):
        # local views: params [1, L_sigma, ...] (one source's sigma chain),
        # x [1, n_local, ...]
        p = jax.tree_util.tree_map(lambda a: a[0][level], params)
        score = jax.grad(lambda v: jnp.sum(log_prob_fn(p, v)))(x[0])
        return score[None]

    smap = shard_map(local_eval, mesh=mesh,
                     in_specs=(P(SOURCE_AXIS), P(SOURCE_AXIS, DATA_AXIS),
                               P()),
                     out_specs=P(SOURCE_AXIS, DATA_AXIS))

    def score(params, x: Array, sigma_idx: Array, level: Array) -> Array:
        del sigma_idx
        # same invariant as source_sharded_ncsn_score: local_eval indexes
        # p[0]/x[0], valid only when every device row holds exactly one
        # source
        lead = {leaf.shape[0] for leaf in jax.tree_util.tree_leaves(params)}
        if lead != {n_mesh_sources} or x.shape[0] != n_mesh_sources:
            raise ValueError(
                f"source-sharded glow score: mesh '{SOURCE_AXIS}' axis has "
                f"size {n_mesh_sources} but the stacked params lead with "
                f"{sorted(lead)} and x with {x.shape[0]}; these must all "
                "match so each chip holds exactly one source's sigma chain")
        return smap(params, x, jnp.asarray(level))

    return score


def glow_score_fn(log_prob_fn: Callable,
                  frame_chunk: Optional[int] = None) -> Callable:
    """Parameter-explicit Glow score with per-level param stacks
    ``[L, K, ...]``: ``score(params, x, sigma_idx, level)``.

    ``frame_chunk`` bounds the VJP working set: ``grad_x log_prob``
    through the flow stores every coupling-net activation, which at the
    production separation scale (512 filters, L=3/K=40, 28 frames x 2
    sources) is ~18 GiB of fp32 residuals (XLA's CPU memory analysis,
    benchmarks/probe_glow_sep_memory.py). Chunking evaluates the grad over
    ``frame_chunk`` frames at a time under ``lax.map`` — sequential by
    construction, so peak residency scales with the chunk, while the
    params stay resident across chunks. Frames are
    independent in BASIS, so the result is exact.
    """
    def single_score(params, x):
        return jax.grad(lambda v: jnp.sum(log_prob_fn(params, v)))(x)

    vscore = jax.vmap(single_score, in_axes=(0, 0))

    def score(params, x: Array, sigma_idx: Array, level: Array) -> Array:
        params_l = jax.tree_util.tree_map(lambda p: p[level], params)
        n = x.shape[1]
        if not frame_chunk or n <= frame_chunk:
            return vscore(params_l, x)
        pad = (-n) % frame_chunk
        xp = jnp.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2))
        xc = xp.reshape(x.shape[0], -1, frame_chunk, *x.shape[2:])
        out = jax.lax.map(lambda xi: vscore(params_l, xi),
                          jnp.moveaxis(xc, 1, 0))
        out = jnp.moveaxis(out, 0, 1).reshape(x.shape[0], -1, *x.shape[2:])
        return out[:, :n]

    return score


def make_level_program(score_fn: Callable, sigmas, config: BasisConfig,
                       n_frames: int) -> Callable:
    """One noise level of :func:`basis_separate_per_level` as a jitted
    program ``(params, x, mixed, level, key) -> x`` running ``config.T``
    Langevin steps over ``n_frames`` frames; ``x`` is donated. Exposed so
    callers can ``.lower(...).compile()`` it for a memory analysis."""
    g, grad_g = mixing_process(config.data_type, config.scale)
    sigmas_arr = jnp.asarray(sigmas)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def run_level(params, x, mixed, level, key):
        sigma = sigmas_arr[level]
        eta = config.delta * jnp.square(sigma / sigmas_arr[-1])
        lam = 1.0 / jnp.square(sigma)
        labels = jnp.full((n_frames,), level, jnp.int32)

        def step_body(x, k):
            noise = (jax.random.normal(k, x.shape, x.dtype)
                     * jnp.sqrt(2.0 * eta).astype(x.dtype))
            scores = _clip_scores(score_fn(params, x, labels, level), sigma,
                                  config.score_clip)
            recon = (lam.astype(x.dtype) * grad_g(x) * (mixed - g(x)))
            return x + eta.astype(x.dtype) * (scores + recon) + noise, None

        x, _ = jax.lax.scan(step_body, x, jax.random.split(key, config.T))
        return x

    return run_level


def basis_separate_per_level(score_fn: Callable, params, mixed: Array,
                             x_init: Array, sigmas, rng: Array,
                             config: BasisConfig = BasisConfig(),
                             callback: Optional[Callable] = None):
    """BASIS with one jitted XLA program dispatched per noise level.

    Identical math to :func:`basis_separate`, but the outer (noise-level)
    loop runs on the host: ``L`` dispatches of a T-step scan instead of one
    L*T program. Preferred for production runs — per-level host control
    gives progress reporting/snapshots (the reference logs per level,
    run_basis_sep.py:227), avoids very long single device executions, and
    compiles an order of magnitude faster. ``score_fn`` takes params
    explicitly (``(params, x, sigma_idx, level) -> scores``) so model
    weights are jit arguments, not baked-in constants.
    """
    L = len(sigmas)
    run_level = make_level_program(score_fn, sigmas, config, x_init.shape[1])
    keys = jax.random.split(rng, L)
    # x is always donated into run_level (the scan reuses the iterate
    # buffers). Trajectory snapshots are cheap device-side copies
    # (~MBs) taken BEFORE the next dispatch consumes x, so collecting the
    # trajectory no longer disables donation (round-2 VERDICT item 3i).
    x = jnp.copy(x_init)   # never donate the caller's buffer
    traj = [x_init] if config.collect_trajectory else None
    for level in range(L):
        x = run_level(params, x, mixed, jnp.asarray(level), keys[level])
        if callback is not None:
            callback(level, x)
        if config.collect_trajectory:
            traj.append(x)
            if level < L - 1:
                x = jnp.copy(x)   # keep the snapshot; donate the copy
    return x, (jnp.stack(traj) if config.collect_trajectory else None)


def basis_separate(score_fn: Callable, mixed: Array, x_init: Array,
                   sigmas: Array, rng: Array,
                   config: BasisConfig = BasisConfig()):
    """Run the full annealed BASIS separation.

    Args:
        score_fn: ``(x [K, N, ...], sigma_idx [K*? batch], level) -> scores``.
        mixed: ``[N, ...]`` preprocessed mixture.
        x_init: ``[K, N, ...]`` initial sources.
        sigmas: ``[L]`` noise schedule.
        rng: PRNG key.
    Returns:
        ``(x_final [K, N, ...], trajectory [L+1, K, N, ...] or None)``.

    Inner update (run_basis_sep.py:180-181), vectorised over sources:
    ``x <- x + eta * (score + lambda * grad_g * (mixed - g(x))) + sqrt(2
    eta) * eps`` with ``eta = delta * (sigma/sigma_L)^2``,
    ``lambda = 1/sigma^2``.
    """
    g, grad_g = mixing_process(config.data_type, config.scale)
    sigmas = jnp.asarray(sigmas)
    L = sigmas.shape[0]
    K, N = x_init.shape[0], x_init.shape[1]

    def level_body(x, level_in):
        level, key = level_in
        sigma = sigmas[level]
        eta = config.delta * jnp.square(sigma / sigmas[-1])
        lam = 1.0 / jnp.square(sigma)
        labels = jnp.full((N,), level, jnp.int32)

        def step_body(x, k):
            noise = (jax.random.normal(k, x.shape, x.dtype)
                     * jnp.sqrt(2.0 * eta).astype(x.dtype))
            scores = _clip_scores(score_fn(x, labels, level), sigma,
                                  config.score_clip)
            mixing = g(x)
            grads_mix = grad_g(x)
            recon = lam.astype(x.dtype) * grads_mix * (mixed - mixing)
            return x + eta.astype(x.dtype) * (scores + recon) + noise, None

        x, _ = jax.lax.scan(step_body, x, jax.random.split(key, config.T))
        return x, (x if config.collect_trajectory else None)

    levels = (jnp.arange(L), jax.random.split(rng, L))
    x_final, traj = jax.lax.scan(level_body, x_init, levels)
    if config.collect_trajectory:
        traj = jnp.concatenate([x_init[None], traj], axis=0)
    return x_final, traj


def preprocess_mixture(mixed: Array, minval: float, maxval: float,
                       use_logit: bool = False,
                       alpha: float = 1e-6) -> Array:
    """Rescale the mixture to [0,1] (+ optional logit)
    (run_basis_sep.py:355-358)."""
    x = (mixed - minval) / (maxval - minval)
    if use_logit:
        x = x * (1.0 - 2 * alpha) + alpha
        x = jnp.log(x) - jnp.log1p(-x)
    return x


def postprocess(x: Array, minval: float, maxval: float,
                use_logit: bool = False, alpha: float = 1e-6,
                data_type: str = "melspec", rescale: bool = True) -> Array:
    """Map separated sources back to data scale (run_basis_sep.py:82-96).

    ``rescale=False`` is the Glow-prior path: the separation already ran in
    data scale (Glow priors are trained on raw data — the model's
    preprocessing bijector rescales internally), so only the final
    clip/quantise applies.
    """
    if rescale:
        if use_logit:
            x = jax.nn.sigmoid(x)
            x = (x - alpha) / (1.0 - 2.0 * alpha)
        x = x * (maxval - minval) + minval
    if data_type == "image":
        x = jnp.round(jnp.clip(x, 0.0, 255.0))
    else:
        x = jnp.clip(x, minval, maxval)
    return x
