"""Mel filterbanks and dB conversions with librosa / tf.signal parity.

The reference uses two mel paths: librosa's (slaney scale + slaney norm,
datasets/preprocessing.py:82-92) and ``tf.signal.linear_to_mel_weight_matrix``
(HTK scale, no norm, :110-125). Both are reproduced here as constant numpy
matrices applied with a single matmul.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


# ---------------------------------------------------------------------------
# mel scales
# ---------------------------------------------------------------------------

def hz_to_mel_slaney(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


# ---------------------------------------------------------------------------
# filterbanks
# ---------------------------------------------------------------------------

def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney",
                   dtype=np.float32) -> np.ndarray:
    """librosa.filters.mel equivalent: ``[n_mels, 1 + n_fft//2]``."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)

    to_mel = hz_to_mel_htk if htk else hz_to_mel_slaney
    to_hz = mel_to_hz_htk if htk else mel_to_hz_slaney
    mel_f = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(dtype)


def linear_to_mel_weight_matrix(num_mel_bins: int, num_spectrogram_bins: int,
                                sample_rate: float,
                                lower_edge_hertz: float = 125.0,
                                upper_edge_hertz: float = 3800.0,
                                dtype=np.float32) -> np.ndarray:
    """``tf.signal.linear_to_mel_weight_matrix`` equivalent:
    ``[num_spectrogram_bins, num_mel_bins]`` (HTK scale, unnormalised,
    DC bin dropped)."""
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spec_mel = hz_to_mel_htk(freqs)[:, None]

    edges = np.linspace(hz_to_mel_htk(lower_edge_hertz),
                        hz_to_mel_htk(upper_edge_hertz), num_mel_bins + 2)
    lower, center, upper = (edges[:-2][None, :], edges[1:-1][None, :],
                            edges[2:][None, :])
    lower_slope = (spec_mel - lower) / (center - lower)
    upper_slope = (upper - spec_mel) / (upper - center)
    w = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    return np.pad(w, [[bands_to_zero, 0], [0, 0]]).astype(dtype)


# ---------------------------------------------------------------------------
# dB conversion (librosa.power_to_db / db_to_power)
# ---------------------------------------------------------------------------

def power_to_db(S: Array, ref: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0,
                window_ndim: Optional[int] = None) -> Array:
    """``10*log10(max(S, amin)) - 10*log10(ref)`` with optional ``top_db``
    floor (librosa semantics, used by the reference's data_loader.py:162).

    ``window_ndim=None`` floors against the whole-array max (librosa on a
    single array). For *batched* windows pass the number of trailing
    per-window axes (e.g. 2 for ``[..., n_mels, F]``) so the floor is
    per-window — the reference calls ``librosa.power_to_db`` once per
    ``[n_mels, F]`` window (data_loader.py:161-164)."""
    log_spec = 10.0 * jnp.log10(jnp.maximum(S, amin))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(jnp.asarray(ref), amin))
    if top_db is not None:
        if window_ndim is None:
            peak = jnp.max(log_spec)
        else:
            peak = jnp.max(log_spec, axis=tuple(range(-window_ndim, 0)),
                           keepdims=True)
        log_spec = jnp.maximum(log_spec, peak - top_db)
    return log_spec


def db_to_power(S_db: Array, ref: float = 1.0) -> Array:
    return ref * jnp.power(10.0, 0.1 * S_db)
