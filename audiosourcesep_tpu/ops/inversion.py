"""Spectrogram inversion: NNLS mel->STFT, Griffin-Lim, phase reuse, Wiener.

The reference inverts on the host with librosa (melspec_inversion_basis.py:
21-119, run_basis_sep.py:99-103); here every step is a jitted, batched XLA
computation: NNLS is an accelerated projected-gradient solve (batched
matmuls), Griffin-Lim a ``lax.scan`` over STFT/iSTFT round trips.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .mel import db_to_power, mel_filterbank
from .stft import istft, stft

Array = jax.Array
_HIGH = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("sr", "n_fft", "fmin", "fmax",
                                             "power", "n_iter"))
def mel_to_stft(melspec: Array, sr: int = 16000, n_fft: int = 2048,
                fmin: float = 125.0, fmax: float = 7600.0,
                power: float = 2.0, n_iter: int = 300) -> Array:
    """Approximate-inverse of a mel power spectrogram -> STFT magnitude.

    librosa.feature.inverse.mel_to_stft solves a non-negative least-squares
    ``argmin_{x>=0} ||mel @ x - M||^2`` per frame; here it is a FISTA
    (accelerated projected-gradient) iteration with a fixed step
    ``1/||A^T A||_2`` — pure matmuls, batched over all frames at once.

    Args:
        melspec: ``[..., n_mels, F]`` mel *power* spectrogram.
    Returns:
        ``[..., n_bins, F]`` STFT magnitude (``** (1/power)``).
    """
    A_np = mel_filterbank(sr, n_fft, melspec.shape[-2], fmin, fmax)
    A = jnp.asarray(A_np)
    # Lipschitz constant of grad: largest eigenvalue of A^T A
    lip = float(np.linalg.norm(A_np, 2) ** 2)
    AtA = jnp.einsum("mb,mc->bc", A, A, precision=_HIGH)
    Atb = jnp.einsum("mb,...mf->...bf", A, melspec, precision=_HIGH)

    x0 = jnp.zeros((*melspec.shape[:-2], A.shape[1], melspec.shape[-1]),
                   melspec.dtype)

    def step(carry, _):
        x, y, t = carry
        grad = jnp.einsum("bc,...cf->...bf", AtA, y, precision=_HIGH) - Atb
        x_new = jnp.maximum(y - grad / lip, 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return (x_new, y_new, t_new), None

    (x, _, _), _ = jax.lax.scan(step, (x0, x0, jnp.asarray(1.0)), None,
                                length=n_iter)
    return jnp.power(x, 1.0 / power)


@functools.partial(jax.jit, static_argnames=("n_fft", "hop_length", "n_iter",
                                             "length"))
def griffin_lim(magnitude: Array, key: Array, n_fft: int = 2048,
                hop_length: int = 512, n_iter: int = 32,
                momentum: float = 0.99,
                length: Optional[int] = None) -> Array:
    """Griffin-Lim phase reconstruction with momentum (librosa defaults).

    Args:
        magnitude: ``[..., n_bins, F]`` STFT magnitude.
    Returns:
        ``[..., T]`` audio.
    """
    angles = jnp.exp(2j * jnp.pi * jax.random.uniform(
        key, magnitude.shape)).astype(jnp.complex64)
    S = magnitude.astype(jnp.complex64)
    eps = 1e-16
    mcoef = momentum / (1.0 + momentum)

    def step(carry, _):
        angles, tprev = carry
        inv = istft(S * angles, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(inv, n_fft=n_fft, hop_length=hop_length)
        new_angles = rebuilt - mcoef * tprev
        new_angles = new_angles / (jnp.abs(new_angles) + eps)
        return (new_angles, rebuilt), None

    (angles, _), _ = jax.lax.scan(
        step, (angles, jnp.zeros_like(S)), None, length=n_iter)
    return istft(S * angles, n_fft=n_fft, hop_length=hop_length,
                 length=length)


def mel_to_audio(melspec: Array, key: Array, sr: int = 16000,
                 n_fft: int = 2048, hop_length: int = 512,
                 fmin: float = 125.0, fmax: float = 7600.0,
                 n_iter: int = 32, length: Optional[int] = None) -> Array:
    """Mel power spectrogram -> audio via NNLS + Griffin-Lim
    (librosa.feature.inverse.mel_to_audio; reference run_basis_sep.py:99-103).
    """
    mag = mel_to_stft(melspec, sr=sr, n_fft=n_fft, fmin=fmin, fmax=fmax)
    return griffin_lim(mag, key, n_fft=n_fft, hop_length=hop_length,
                       n_iter=n_iter, length=length)


def single_channel_wiener_filter(psd_sources: Array,
                                 stft_mixture: Array) -> Array:
    """``(PSD_i / sum_j PSD_j) * stft_mix`` (melspec_inversion_basis.py:96-119).

    Args:
        psd_sources: ``[n_src, ..., n_bins, F]`` power spectrograms.
        stft_mixture: complex ``[..., n_bins, F]``.
    """
    return (psd_sources / (jnp.sum(psd_sources, axis=0) + 1e-10)
            ) * stft_mixture


def phase_reuse(magnitudes: Array, stft_mixture: Array) -> Array:
    """``|S_i| * exp(i * angle(stft_mix))`` (melspec_inversion_basis.py:86)."""
    phase = stft_mixture / (jnp.abs(stft_mixture) + 1e-16)
    return magnitudes.astype(jnp.complex64) * phase


def invert_melspec_reuse_phase(melspecs: Array, stft_mixture: Array,
                               scale: str = "dB", wiener_filter: bool = False,
                               sr: int = 16000, n_fft: int = 2048,
                               hop_length: int = 512, fmin: float = 125.0,
                               fmax: float = 7600.0,
                               length: Optional[int] = None) -> Array:
    """Batched phase-reuse inversion of separated mel spectrograms.

    Equivalent of the reference's ``stft_inversion_fn``
    (melspec_inversion_basis.py:42-93): mel -> STFT magnitude via NNLS, then
    mixture-phase reuse or single-channel Wiener filtering, then iSTFT.

    Args:
        melspecs: ``[n_src, ..., n_mels, F]`` in dB or power scale.
        stft_mixture: complex ``[..., n_bins, F]``.
    Returns:
        ``[n_src, ..., T]`` audio.
    """
    if scale == "dB":
        melspecs = db_to_power(melspecs)
    mags = mel_to_stft(melspecs, sr=sr, n_fft=n_fft, fmin=fmin, fmax=fmax)
    if wiener_filter and melspecs.shape[0] > 1:
        stft_est = single_channel_wiener_filter(
            jnp.square(mags), stft_mixture)
    else:
        stft_est = phase_reuse(mags, stft_mixture)
    return istft(stft_est, n_fft=n_fft, hop_length=hop_length, length=length)
