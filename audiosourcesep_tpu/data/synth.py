"""Seeded synthetic stems: a piano-like and a violin-like tone and their mix.

The reference's corpora are not shipped, so the tests and ``chip_smoke.py``
drive the wav -> spectrogram -> train -> separate -> invert path on these.
The two stems occupy disjoint frequency bands, so a working separation and
inversion chain scores a clearly positive SDR on them.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .wav import write_wav


def synth_stems(seconds: float, sr: int = 16000,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """``{"piano", "violin", "mix"}`` float32 signals of ``seconds`` length.

    piano: a 220 Hz partial under a 2 Hz tremolo; violin: a 554.4 Hz partial
    under a 5 Hz vibrato; mix: their mean. ``seed`` draws the four phases.
    """
    phase = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, 4)
    t = np.arange(int(sr * seconds)) / sr
    piano = 0.4 * np.sin(2 * np.pi * 220.0 * t + phase[0]) * (
        1 + 0.3 * np.sin(2 * np.pi * 2.0 * t + phase[1]))
    violin = 0.4 * np.sin(2 * np.pi * 554.4 * t + phase[2]
                          + 3 * np.sin(2 * np.pi * 5.0 * t + phase[3]))
    stems = {"piano": piano, "violin": violin, "mix": 0.5 * (piano + violin)}
    return {k: v.astype(np.float32) for k, v in stems.items()}


def write_song(dirpath: str, seconds: float, sr: int = 16000,
               seed: int = 0) -> str:
    """Write ``piano.wav``, ``violin.wav`` and ``mix.wav`` (the song layout
    ``run_basis_sep.py --song_dir`` reads) into ``dirpath``."""
    os.makedirs(dirpath, exist_ok=True)
    for name, audio in synth_stems(seconds, sr, seed).items():
        write_wav(os.path.join(dirpath, f"{name}.wav"), audio, sr)
    return dirpath
