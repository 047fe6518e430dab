#!/usr/bin/env python
"""BASIS source separation with pre-trained NCSN or Glow priors.

CLI contract follows /root/reference/run_basis_sep.py:453-525 (positional
RESTORE1/RESTORE2, same flags, same ``results.npz`` keys). The whole
annealed separation runs as ONE jitted scan: both sources/models stacked
into a single vmapped score evaluation, frames sharded over the device
mesh, per-noise-level Glow parameter stacks resident on device (no
checkpoint I/O inside the loop — the reference restores checkpoints between
every noise level, run_basis_sep.py:228-234).
"""

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu import cli
from audiosourcesep_tpu.data import get_mixture_toydata, get_song_extract, write_wav
from audiosourcesep_tpu.models import build_glow
from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu.ops import db_to_power, mel_to_audio
from audiosourcesep_tpu.parallel import (make_mesh, make_source_mesh,
                                         pad_to_multiple, params_by_source,
                                         replicate, shard_batch,
                                         source_sharding)
from audiosourcesep_tpu.separation import (BasisConfig,
                                           basis_separate_per_level,
                                           glow_score_fn, ncsn_score_fn,
                                           postprocess, preprocess_mixture,
                                           source_sharded_glow_score,
                                           source_sharded_ncsn_score,
                                           stack_pytrees)
from audiosourcesep_tpu.training import (CheckpointManager, add_figure,
                                         pyplot, restore_pytree,
                                         setup_tensorboard)

SPEC_PARAMS = {"length_sec": 2.04, "dbmin": -100.0, "dbmax": 20.0,
               "fmin": 125.0, "fmax": 7600.0, "n_fft": 2048,
               "hop_length": 512, "n_mels": 96, "sr": 16000}


def restore_ncsn_params(path, template, ema=False):
    """Restore prior weights from a checkpoint file or a directory of ckpts.

    ``ema=True`` restores the exponential-moving-average subtree
    (``ema_params``) instead of the raw weights — the reference's ``--ema``
    MovingAverage restore (ncsn_generate_samples.py:88-89,142); raises if
    the checkpoint has no EMA state. The restore is strict — every template
    leaf must exist in the checkpoint with a matching shape (the analog of
    ``status.assert_existing_objects_matched()``, reference
    run_basis_sep.py:28-38) — so a model/checkpoint hyperparameter mismatch
    fails fast instead of separating with partially-random priors.
    """
    subtree = "ema_params" if ema else "params"

    def _restore(ckpt_path):
        try:
            state, _ = restore_pytree(ckpt_path, {subtree: template},
                                      strict=True)
        except KeyError as e:
            if ema:
                raise KeyError(
                    f"--ema requested but checkpoint {ckpt_path} has no "
                    f"EMA state (train with --ema): {e}") from e
            raise
        return state[subtree]

    path = os.path.abspath(path)
    if os.path.isdir(path):
        for cand in (path, os.path.join(path, "ckpts")):
            if os.path.isdir(cand):
                latest = CheckpointManager(cand).latest()
                if latest is not None:
                    return _restore(latest)
        raise FileNotFoundError(f"no checkpoint under {path}")
    return _restore(path)


def main(args):
    abs_restore_1 = os.path.abspath(args.RESTORE1)
    abs_restore_2 = os.path.abspath(args.RESTORE2)
    args = cli.apply_config_override(args)

    sigmas = get_sigmas(args.sigma1, args.sigmaL, int(args.num_classes),
                        args.progression)

    if args.dataset in ("mnist", "cifar10"):
        args.data_shape = [32, 32, 1] if args.dataset == "mnist" \
            else [32, 32, 3]
        data_type = "image"
        minval, maxval = 0.0, 256.0
    else:
        if args.song_dir is None:
            raise ValueError("song_dir is None")
        song_dir = os.path.abspath(args.song_dir)
        args.data_shape = [args.height, args.width, 1]
        data_type = "melspec"
        if args.scale == "power":
            minval, maxval = 1e-10, 100.0
        elif args.scale == "dB":
            minval, maxval = -100.0, 20.0
        else:
            raise ValueError("scale should be 'power' or 'dB'")

    log_file = cli.setup_output_dir(args.output, args.debug)
    train_writer, _ = setup_tensorboard()
    alpha = args.alpha or 1e-6

    # Glow priors are trained on RAW-scale data (their preprocessing
    # bijector rescales internally: SpecPreprocessing / ImgPreprocessing,
    # reference flow_builder.py:85-90), so the Glow separation runs in data
    # scale — no [0,1] rescale on the mixture, uniform init over
    # [minval, maxval], clip-only postprocessing. NCSN priors are trained
    # on [0,1]-rescaled data (train_ncsn.py preprocess), so that path keeps
    # the reference's rescale. (The reference preprocesses to [0,1] for
    # both, which feeds its Glow priors inputs ~100 dB off their training
    # distribution; its committed glow-melspec branch never runs as written
    # — `minibatch` NameError, run_basis_sep.py:386-390.)
    model_scale = (args.model_type == "glow")

    # ---------------- data -------------------------------------------------
    t0 = time.time()
    stft_mixture = None
    raw_audio = None
    rng = jax.random.PRNGKey(args.seed)
    rng, k_data, k1, k2 = jax.random.split(rng, 4)
    if data_type == "image":
        mixed, gt1, gt2, minibatch = get_mixture_toydata(
            dataset=args.dataset, n_mixed=args.n_mixed, seed=args.seed)
        if model_scale:
            x1 = jax.random.uniform(k1, mixed.shape, minval=minval,
                                    maxval=maxval)
            x2 = jax.random.uniform(k2, mixed.shape, minval=minval,
                                    maxval=maxval)
        else:
            mixed = preprocess_mixture(mixed, minval, maxval,
                                       args.use_logit, alpha)
            x1 = jax.random.uniform(k1, mixed.shape)
            x2 = jax.random.uniform(k2, mixed.shape)
    else:
        spec = dict(SPEC_PARAMS, use_dB=(args.scale == "dB"),
                    n_mels=args.height)
        duration = spec["length_sec"] * args.n_mixed
        mel_spec, raw_audio, stft_mixture = get_song_extract(
            os.path.join(song_dir, "mix.wav"),
            os.path.join(song_dir, "piano.wav"),
            os.path.join(song_dir, "violin.wav"), duration, **spec)
        mixed = jnp.asarray(mel_spec[0])
        gt1, gt2 = jnp.asarray(mel_spec[1]), jnp.asarray(mel_spec[2])
        minibatch = gt1
        if model_scale:
            x1 = jax.random.uniform(k1, mixed.shape, minval=minval,
                                    maxval=maxval)
            x2 = jax.random.uniform(k2, mixed.shape, minval=minval,
                                    maxval=maxval)
        else:
            mixed = preprocess_mixture(mixed, minval, maxval,
                                       args.use_logit, alpha)
            x1 = jax.random.uniform(k1, mixed.shape)
            x2 = jax.random.uniform(k2, mixed.shape)
        write_wav("ground_truth1.wav", raw_audio[1], spec["sr"])
        write_wav("ground_truth2.wav", raw_audio[2], spec["sr"])
        write_wav("mix.wav", raw_audio[0], spec["sr"])
        # audio summaries (reference run_basis_sep.py:380)
        for name, audio in zip(("mix", "gt1", "gt2"), raw_audio):
            try:
                train_writer.add_audio(f"Original Audio/{name}",
                                       np.asarray(audio)[None, :],
                                       0, sample_rate=spec["sr"])
            except Exception:
                pass
    print(f"Data Loaded in {round(time.time() - t0, 3)} seconds")

    # ---------------- models ----------------------------------------------
    # --shard_sources: 2-D (source, frame) mesh — each device holds ONE
    # model and 2x the frames, so the per-apply conv batch does not shrink
    # as fast with the device count as under frame-only sharding. For Glow
    # priors it also halves per-device prior memory: each device row holds
    # one source's sigma-stacked param chain instead of a replica of both.
    shard_sources = (args.shard_sources and jax.device_count() > 1
                     and jax.device_count() % 2 == 0)
    if args.shard_sources and not shard_sources:
        print("--shard_sources ignored (needs an even device count > 1)")
    mesh = None
    if shard_sources:
        mesh = make_source_mesh(2)
    elif jax.device_count() > 1:
        mesh = make_mesh()
    if args.model_type == "glow":
        rng, k_init = jax.random.split(rng)
        model, template = build_glow(
            k_init, jnp.asarray(minibatch, jnp.float32),
            args.data_shape, L=args.L, K=args.K, n_filters=args.n_filters,
            learntop=args.learntop, data_type=data_type,
            use_logit=args.use_logit, alpha=alpha,
            minval=minval, maxval=maxval)
        # restore the per-noise-level params for both models
        raw_levels = []   # [(p_source1, p_source2), ...] per sigma
        for sigma in sigmas:
            level_params = []
            for root in (abs_restore_1, abs_restore_2):
                d = os.path.join(root, f"sigma_{round(float(sigma), 2)}",
                                 "ckpts")
                p = restore_ncsn_params(d, template)
                level_params.append(p)
                print(f"Model at noise level {sigma} restored from {d}")
            raw_levels.append(level_params)
        if shard_sources:
            # source-major stack [2, L_sigma, ...]: each device row holds
            # one source's whole sigma chain (half the replicated memory)
            stacked = stack_pytrees(*[
                stack_pytrees(*[lvl[k] for lvl in raw_levels])
                for k in range(2)])
            stacked = params_by_source(stacked, mesh)
            score_fn = source_sharded_glow_score(model.log_prob, mesh)
        else:
            # level-major stack [L_sigma, 2, ...], indexed on-device
            stacked = stack_pytrees(*[stack_pytrees(*lvl)
                                      for lvl in raw_levels])
            if mesh is not None:
                stacked = replicate(stacked, mesh)
            score_fn = glow_score_fn(model.log_prob,
                                     frame_chunk=args.score_chunk or None)
    else:
        compute_dtype = jnp.bfloat16 if args.compute_dtype == "bf16" \
            else None
        model = get_score_model(args.version, args.data_shape,
                                args.n_filters, int(args.num_classes),
                                sigmas=sigmas,
                                logit_transform=args.use_logit,
                                compute_dtype=compute_dtype)
        rng, k_init = jax.random.split(rng)
        template = model.init_params(k_init)
        p1 = restore_ncsn_params(abs_restore_1, template, ema=args.ema)
        print(f"Model 1 restored from {abs_restore_1}"
              + (" (EMA weights)" if args.ema else ""))
        p2 = restore_ncsn_params(abs_restore_2, template, ema=args.ema)
        print(f"Model 2 restored from {abs_restore_2}"
              + (" (EMA weights)" if args.ema else ""))
        stacked = stack_pytrees(p1, p2)
        if shard_sources:
            stacked = params_by_source(stacked, mesh)
            score_fn = source_sharded_ncsn_score(model.apply, mesh)
        else:
            if mesh is not None:
                stacked = replicate(stacked, mesh)
            score_fn = ncsn_score_fn(model.apply)

    cli.print_params(args, train_writer)

    # ---------------- separation ------------------------------------------
    x_init = jnp.stack([x1, x2])
    mixed_dev = jnp.asarray(mixed)
    n_frames = x_init.shape[1]
    if mesh is not None:
        # pad the frame batch to a multiple of the mesh's frame axis
        # (separation is frame-independent; padding frames are dropped
        # afterwards). Source-sharded mesh: frame axis = devices/2.
        n_frame_dev = (mesh.devices.shape[1] if shard_sources
                       else mesh.devices.size)
        padded = pad_to_multiple(n_frames, n_frame_dev)
        if padded != n_frames:
            extra = padded - n_frames
            x_init = jnp.pad(
                x_init, [(0, 0), (0, extra)] + [(0, 0)] * (x_init.ndim - 2),
                mode="wrap")
            mixed_dev = jnp.pad(
                mixed_dev, [(0, extra)] + [(0, 0)] * (mixed_dev.ndim - 1),
                mode="wrap")
        if shard_sources:
            x_init = jax.device_put(x_init, source_sharding(mesh))
        else:
            x_init = shard_batch(x_init, mesh, batch_axis=1)
        mixed_dev = shard_batch(mixed_dev, mesh, batch_axis=0)

    # reference hardcodes delta=2e-5 even when the config carries step_lr
    # (run_basis_sep.py:239); here the flag/config value is honored
    cfg = BasisConfig(T=args.T, delta=getattr(args, "step_lr", 2e-5),
                      data_type=data_type,
                      scale=args.scale, collect_trajectory=True,
                      score_clip=getattr(args, "score_clip", None))

    # At the reference's L=10 every level renders a TB snapshot (reference
    # run_basis_sep.py:247-255, snap_every=1 below). At NCSNv2's L=200 the
    # per-level matplotlib render would burn minutes of host time between
    # dispatches, so snapshots keep ~10-per-run density; the per-level
    # "Sigma = ..." out.log line is unchanged at any L.
    snap_every = max(1, len(sigmas) // 10)

    def progress(level, x):
        print(f"Sigma = {sigmas[level]} ({level + 1} / {len(sigmas)}) done")
        if (level + 1) % snap_every and (level + 1) != len(sigmas):
            return
        plt = pyplot()
        if plt is None:
            return
        try:
            n_show = min(5, x.shape[1])
            f, axes = plt.subplots(n_show, 3, figsize=(6, 8), squeeze=False)
            for i in range(n_show):
                for j, img in enumerate((np.asarray(mixed)[i],
                                         np.asarray(x[0, i]),
                                         np.asarray(x[1, i]))):
                    axes[i][j].imshow(img.squeeze(), origin="lower",
                                      aspect="auto", cmap="magma")
                    axes[i][j].set_axis_off()
            f.suptitle("Separation: Mixture = Component 1 + Component 2")
            add_figure(train_writer, "Components", f, (level + 1) * args.T)
        except Exception:
            pass

    t0 = time.time()
    rng, k_sep = jax.random.split(rng)
    x_final, traj = basis_separate_per_level(
        score_fn, stacked, mixed_dev, x_init, sigmas, k_sep, cfg,
        callback=progress)
    jax.block_until_ready(x_final)
    x_final = x_final[:, :n_frames]
    if traj is not None:
        traj = traj[:, :, :n_frames]
    print(f"Duration: {round(time.time() - t0, 3)} seconds")

    # ---------------- save results ----------------------------------------
    def post(x):
        return np.asarray(postprocess(jnp.asarray(x), minval, maxval,
                                      args.use_logit, alpha, data_type,
                                      rescale=not model_scale))

    def squeeze_ch(a):
        # drop only the trailing channel axis (plain .squeeze() would also
        # collapse a singleton frame axis when n_mixed == 1)
        a = np.asarray(a)
        return a[..., 0] if a.shape[-1] == 1 else a

    x1_out = post(squeeze_ch(x_final[0]))
    x2_out = post(squeeze_ch(x_final[1]))
    mixed_out = post(squeeze_ch(mixed))
    np.savez("results", x1=x1_out, x2=x2_out,
             gt1=squeeze_ch(gt1), gt2=squeeze_ch(gt2),
             mixed=mixed_out, stft_mixture=stft_mixture)
    np.savez("results_convergence", x1=post(np.asarray(traj[:, 0])),
             x2=post(np.asarray(traj[:, 1])))

    if data_type == "melspec" and args.inverse:
        sr = SPEC_PARAMS["sr"]
        x1_concat = np.concatenate(list(x1_out), axis=-1)
        x2_concat = np.concatenate(list(x2_out), axis=-1)
        rng, k_inv = jax.random.split(rng)
        mels = jnp.asarray(np.stack([x1_concat, x2_concat]))
        if args.scale == "dB":
            mels = db_to_power(mels)
        audio = np.asarray(mel_to_audio(
            mels, k_inv, sr=sr, n_fft=SPEC_PARAMS["n_fft"],
            hop_length=SPEC_PARAMS["hop_length"],
            fmin=SPEC_PARAMS["fmin"], fmax=SPEC_PARAMS["fmax"]))
        write_wav("sep1.wav", audio[0], sr)
        write_wav("sep2.wav", audio[1], sr)
        for i in range(2):
            try:
                train_writer.add_audio(f"Separated Audio/sep{i+1}",
                                       audio[i][None, :], 1000,
                                       sample_rate=sr)
            except Exception:
                pass

    log_file.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="BASIS Separation")
    parser.add_argument("RESTORE1", type=str,
                        help="directory of saved model1")
    parser.add_argument("RESTORE2", type=str,
                        help="directory of saved model2")
    parser.add_argument("--output", type=str, default="basis_sep")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--dataset", type=str, default="melspec",
                        help="mnist | cifar10 | melspec")
    parser.add_argument("--song_dir", type=str, default=None,
                        help="dir with mix.wav, piano.wav, violin.wav")
    parser.add_argument("--inverse", action="store_true")
    parser.add_argument("--model_type", type=str, default="ncsn")
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--ema", action="store_true",
                        help="restore the EMA weights of NCSN priors "
                             "(reference ncsn_generate_samples.py:88-89)")
    parser.add_argument("--compute_dtype", type=str, default="f32",
                        help="score-network compute dtype: f32 "
                             "(reference numerics; TF32 convs on GPUs "
                             "unless matmul precision is pinned) or bf16 "
                             "(norm statistics and the Langevin update "
                             "stay f32)")
    parser.add_argument("--shard_sources", action="store_true",
                        help="2-D (source, frame) mesh: each device holds "
                             "ONE prior and 2x the frames, instead of "
                             "both priors on a frame shard; for Glow "
                             "priors also halves per-device prior memory "
                             "(one source's sigma chain per device row). "
                             "Even device counts only")
    parser.add_argument("--score_chunk", type=int, default=8,
                        help="Glow priors only: evaluate grad-through-flow "
                             "scores over this many frames at a time "
                             "(lax.map). The full-batch VJP stores ~18 GiB "
                             "of coupling-net activations at the "
                             "512-filter/28-frame production scale "
                             "(benchmarks/probe_glow_sep_memory.py). 0 = "
                             "whole batch at once. No-op for NCSN priors "
                             "(direct score nets, no input-grad residuals)")
    parser.add_argument("--n_mixed", type=int, default=30)
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    # spectrograms
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    # BASIS
    parser.add_argument("--T", type=int, default=100)
    parser.add_argument("--step_lr", type=float, default=2e-5,
                        help="Langevin step size delta (eta = delta * "
                             "(sigma/sigmaL)^2). The reference hardcodes "
                             "2e-5 (run_basis_sep.py:153,239) for data "
                             "rescaled to [0,1]; Glow priors separate in "
                             "DATA scale here, where the scale-equivalent "
                             "value is 2e-5 * span^2 (and sigmas scale by "
                             "span) — e.g. span 256 for images")
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--score_clip", type=float, default=None,
                        help="clip per-pixel scores to +-score_clip/sigma "
                             "(the ideal smoothed-score scale). Stability "
                             "guard for grad-through-flow (Glow) priors, "
                             "whose off-manifold gradients can explode "
                             "the Langevin; off by default, no-op for the "
                             "reference-parity NCSN paths")
    parser.add_argument("--num_classes", type=float, default=10)
    parser.add_argument("--progression", type=str, default="geometric")
    # model hyperparameters
    parser.add_argument("--n_filters", type=int, default=192)
    parser.add_argument("--L", type=int, default=3)
    parser.add_argument("--K", type=int, default=32)
    parser.add_argument("--l2_reg", type=float, default=None)
    parser.add_argument("--learntop", action="store_true")
    # optimization (unused at separation time; kept for config compat)
    parser.add_argument("--optimizer", type=str, default="adamax")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    # preprocessing
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=1e-6)
    main(parser.parse_args())
