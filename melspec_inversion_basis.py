#!/usr/bin/env python
"""Invert estimated mel-spectrograms from BASIS results back to audio.

CLI contract follows /root/reference/melspec_inversion_basis.py:236-254:
reads ``results.npz``, inverts sources / ground truths / mix with
Griffin-Lim or phase-reuse (optionally single-channel Wiener), writes wavs.
All frames invert in ONE batched jitted computation (the reference inverts
frame-by-frame on the host).
"""

import argparse
import datetime
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from audiosourcesep_tpu.data import write_wav
from audiosourcesep_tpu.ops import (db_to_power, invert_melspec_reuse_phase,
                                    mel_to_audio)

SR = 16000
FMIN, FMAX = 125.0, 7600.0
N_FFT, HOP = 2048, 512


def concat_frames(audio_frames: np.ndarray) -> np.ndarray:
    """[n_frames, T] per-frame audio -> concatenated track."""
    return np.concatenate(list(audio_frames), axis=-1)


def main(args):
    os.chdir(args.basis_results)
    basis_results = np.load("results.npz")

    if args.output is None:
        args.output = f"inverse_{args.algorithm}_{args.method}"
        if args.wiener_filter:
            args.output += "_wiener_filter"
    os.makedirs(args.output, exist_ok=True)
    os.chdir(args.output)
    log_file = open("out.log", "w")
    if not args.debug:
        sys.stdout = log_file

    x1, x2 = basis_results["x1"], basis_results["x2"]
    gt1, gt2 = basis_results["gt1"], basis_results["gt2"]
    mix = basis_results["mixed"]
    stft_mixture = basis_results["stft_mixture"]
    assert x1.ndim == x2.ndim == stft_mixture.ndim == 3

    if args.scale not in ("dB", "power"):
        raise ValueError("scale should be dB or power")

    template = "Spectrograms \n\t " + "".join(
        f"{k} = {v} \n\t " for k, v in vars(args).items())
    print(template)

    if args.method == "whole":
        # concatenate frames into one long spectrogram before inversion
        def cat(a):
            return np.concatenate(list(a), axis=-1)[None]
        x1, x2, gt1, gt2, mix = map(cat, (x1, x2, gt1, gt2, mix))
        stft_mixture = np.concatenate(list(stft_mixture), axis=-1)[None]

    t_init = time.time()
    rng = jax.random.PRNGKey(args.seed)
    if args.algorithm == "griffin":
        def invert(mels, _key):
            mels = jnp.asarray(mels)
            if args.scale == "dB":
                mels = db_to_power(mels)
            return np.asarray(mel_to_audio(
                mels, _key, sr=SR, n_fft=N_FFT, hop_length=HOP,
                fmin=FMIN, fmax=FMAX))

        keys = jax.random.split(rng, 5)
        x1_inv = concat_frames(invert(x1, keys[0]))
        x2_inv = concat_frames(invert(x2, keys[1]))
        gt1_inv = concat_frames(invert(gt1, keys[2]))
        gt2_inv = concat_frames(invert(gt2, keys[3]))
        mix_inv = concat_frames(invert(mix, keys[4]))
    elif args.algorithm == "reuse_phase":
        def invert_pair(a, b):
            mels = jnp.asarray(np.stack([a, b]))       # [2, n, mel, F]
            out = invert_melspec_reuse_phase(
                mels, jnp.asarray(stft_mixture), scale=args.scale,
                wiener_filter=args.wiener_filter, sr=SR, n_fft=N_FFT,
                hop_length=HOP, fmin=FMIN, fmax=FMAX)
            return (concat_frames(np.asarray(out[0])),
                    concat_frames(np.asarray(out[1])))

        x1_inv, x2_inv = invert_pair(x1, x2)
        gt1_inv, gt2_inv = invert_pair(gt1, gt2)
        mix_single = invert_melspec_reuse_phase(
            jnp.asarray(mix)[None], jnp.asarray(stft_mixture),
            scale=args.scale, wiener_filter=False, sr=SR, n_fft=N_FFT,
            hop_length=HOP, fmin=FMIN, fmax=FMAX)
        mix_inv = concat_frames(np.asarray(mix_single[0]))
    else:
        raise ValueError("algorithm should be griffin or reuse_phase")

    print(f"Inversion duration: {round(time.time() - t_init, 4)} seconds")

    write_wav("sep1.wav", x1_inv, SR)
    write_wav("sep2.wav", x2_inv, SR)
    write_wav("gt1.wav", gt1_inv, SR)
    write_wav("gt2.wav", gt2_inv, SR)
    write_wav("mix.wav", mix_inv, SR)
    np.savez("inverse_spectrograms", x1_audio=x1_inv, x2_audio=x2_inv,
             gt1_audio=gt1_inv, gt2_audio=gt2_inv, mix_audio=mix_inv)
    log_file.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Spectrograms Inversion")
    parser.add_argument("basis_results", type=str,
                        help="directory of basis_results")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--algorithm", type=str, default="reuse_phase",
                        help="griffin or reuse_phase")
    parser.add_argument("--method", type=str, default="frame",
                        help="frame or whole")
    parser.add_argument("--scale", type=str, default="dB")
    parser.add_argument("--wiener_filter", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    main(parser.parse_args())
