"""Dataset loading: wav windowing, melspec TFRecord datasets, toy data,
song extracts for separation.

Re-designs of /root/reference/datasets/preprocessing.py:9-57 and
data_loader.py. Host-side data lives in plain numpy arrays (these datasets
are small — thousands of 96x64 patches); batching is a light iterator with
optional per-host sharding, and the device transfer happens once per step
with the batch axis sharded over the mesh (see ``parallel``).
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import melspectrogram, power_to_db, stft
from .tfrecord import load_tf_records
from .wav import load_audio


# ---------------------------------------------------------------------------
# wav -> windows
# ---------------------------------------------------------------------------

def load_wav(path: str, length_sec: float, sr: Optional[int] = None,
             hop_sec: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Load a wav mono (optionally resampled) and window it into
    ``int(rate * length_sec)``-sample chunks, dropping the remainder
    (preprocessing.py:9-26). ``hop_sec`` < ``length_sec`` yields
    overlapping windows (data augmentation; default non-overlapping,
    matching the reference). Returns ``([n_windows, L], rate)``."""
    song, rate = load_audio(path, sr=sr, mono=True)
    L = int(rate * length_sec)
    hop = L if hop_sec is None else max(int(rate * hop_sec), 1)
    if hop == L:
        n = len(song) // L
        return song[:n * L].reshape(n, L), rate
    starts = np.arange(0, len(song) - L + 1, hop)
    return np.stack([song[s:s + L] for s in starts]), rate


def load_multiple_wav(path: str, length_sec: float) -> np.ndarray:
    """Walk ``path`` for .wav files and concatenate their windows
    (preprocessing.py:29-57)."""
    wav_files = []
    for root, _, files in os.walk(os.path.abspath(path)):
        wav_files += [os.path.join(root, f) for f in files
                      if re.match(r".*\.wav$", f)]
    windows = [load_wav(f, length_sec)[0] for f in sorted(wav_files)]
    print(f"{len(wav_files)} wav files loaded")
    return np.concatenate(windows, axis=0) if windows else np.zeros((0, 0))


# ---------------------------------------------------------------------------
# in-memory dataset with reference-compatible batching
# ---------------------------------------------------------------------------

class ArrayDataset:
    """Shuffled, batched iteration over a numpy array (drop_remainder by
    default, like the reference's training batches; ``drop_remainder=False``
    keeps the final partial batch — the reference's eval batching), with
    optional per-host sharding for multi-host runs."""

    def __init__(self, data: np.ndarray, batch_size: Optional[int],
                 shuffle: bool = True, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 drop_remainder: bool = True):
        self.n_global = len(data)   # pre-shard count (all hosts)
        if num_hosts > 1:
            # truncate every host's shard to the global minimum so all
            # processes run the SAME number of batches per epoch — shards
            # differing by one example can give hosts different batch
            # counts (len(local)//bs), and then one host enters the SPMD
            # step's collective while its peers have finished the epoch:
            # a distributed deadlock
            data = data[host_id::num_hosts][:len(data) // num_hosts]
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.batch_size is None:
            return len(self.data)
        if self.drop_remainder:
            return len(self.data) // self.batch_size
        return -(-len(self.data) // self.batch_size)

    @property
    def n_examples(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.data))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        if bs is None:
            yield self.data[idx]
            return
        for i in range(len(self)):
            yield self.data[idx[i * bs:(i + 1) * bs]]


# ---------------------------------------------------------------------------
# melspec TFRecord datasets (data_loader.py:69-110)
# ---------------------------------------------------------------------------

def _find_tfrecords(dirpath: str) -> List[str]:
    files = []
    for root, _, names in os.walk(os.path.abspath(dirpath)):
        files += [os.path.join(root, f) for f in names
                  if re.match(r".*\.tfrecord$", f)]
    return sorted(files)


def load_melspec_ds(train_dirpath: str, test_dirpath: str,
                    batch_size: Optional[int] = 256, shuffle: bool = True,
                    seed: int = 0, num_hosts: int = 1, host_id: int = 0):
    """Load train/test melspec TFRecords.

    Returns ``(ds_train, ds_test, minibatch, n_train, n_test)`` mirroring
    the reference contract (data_loader.py:69-110): arrays get a trailing
    channel dim, batches drop remainders, ``minibatch`` is one training
    batch for data-dependent init.
    """
    train = np.stack(load_tf_records(_find_tfrecords(train_dirpath)))
    test = np.stack(load_tf_records(_find_tfrecords(test_dirpath)))
    train = train[..., None].astype(np.float32)
    test = test[..., None].astype(np.float32)
    n_train, n_test = len(train), len(test)

    ds_train = ArrayDataset(train, batch_size, shuffle, seed,
                            num_hosts, host_id)
    # keep the eval remainder on single host (a test split smaller than the
    # batch otherwise yields ZERO validation batches -> NaN val loss); with
    # multiple hosts remainders could give hosts different batch counts
    # (collective deadlock), so there the reference's drop-remainder stands
    ds_test = ArrayDataset(test, batch_size, shuffle, seed + 1,
                           num_hosts, host_id,
                           drop_remainder=num_hosts > 1)
    if num_hosts > 1:
        # data-dependent init (Glow ActNorm) must see the SAME minibatch on
        # every host or the replicated initial params diverge across
        # processes; draw it deterministically from the pre-shard data
        minibatch = train[:max(batch_size, 1)]
    else:
        minibatch = next(iter(ds_train))
    return ds_train, ds_test, minibatch, n_train, n_test


# ---------------------------------------------------------------------------
# toy data (MNIST / CIFAR-10; data_loader.py:10-66)
# ---------------------------------------------------------------------------

def load_toydata(dataset: str = "mnist", batch_size: int = 256,
                 seed: int = 0, data_dir: Optional[str] = None,
                 num_hosts: int = 1, host_id: int = 0):
    """MNIST (zero-padded 28->32) or CIFAR-10 as float arrays in [0, 256).

    Tries the Keras dataset cache (no network in this environment; a
    pre-populated ``~/.keras/datasets`` or ``data_dir`` with ``mnist.npz`` /
    cifar batches works). ``scripts/build_mnist_cache.py`` builds the cache
    from raw IDX files — or, offline, a clearly-labeled digits stand-in.
    The ``ASR_MNIST_NPZ`` env var overrides the cache path (used by tests).
    Returns ``(ds_train, ds_test, minibatch)``.
    """
    if dataset == "mnist":
        path = (data_dir or os.environ.get("ASR_MNIST_NPZ")
                or os.path.expanduser("~/.keras/datasets/mnist.npz"))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"MNIST cache not found at {path}; build it with "
                "scripts/build_mnist_cache.py (no network access in this "
                "environment)")
        with np.load(path) as d:
            x_train, x_test = d["x_train"], d["x_test"]
        x_train = np.pad(x_train, ((0, 0), (2, 2), (2, 2)))[..., None]
        x_test = np.pad(x_test, ((0, 0), (2, 2), (2, 2)))[..., None]
    elif dataset == "cifar10":
        npz = (data_dir or os.environ.get("ASR_CIFAR10_NPZ")
               or os.path.expanduser("~/.keras/datasets/cifar10.npz"))
        if not os.path.exists(npz):
            raise FileNotFoundError(
                f"CIFAR-10 cache not found at {npz}; build it from the "
                "standard python-pickle batches with "
                "scripts/build_cifar10_cache.py (no network access, and "
                "this repo is TF-free — no Keras fallback)")
        with np.load(npz) as d:
            x_train, x_test = d["x_train"], d["x_test"]
    else:
        raise ValueError("dataset should be mnist or cifar10")

    x_train = x_train.astype(np.float32)
    x_test = x_test.astype(np.float32)
    ds_train = ArrayDataset(x_train, batch_size, True, seed,
                            num_hosts, host_id)
    # multi-host: remainder batches could give hosts different batch
    # counts -> collective deadlock, so only there the remainder drops.
    # The eval batch is per-HOST and bounded by the shard size (a
    # 5000-global batch would exceed a 2500-example shard and the
    # dropped remainder would then leave zero eval batches)
    eval_bs = max(min(5000, len(x_test)) // num_hosts, 1)
    ds_test = ArrayDataset(x_test, eval_bs, False, seed,
                           num_hosts, host_id,
                           drop_remainder=num_hosts > 1)
    if num_hosts > 1:
        # data-dependent init must see the SAME minibatch on every host
        minibatch = x_train[:max(batch_size, 1)]
    else:
        minibatch = next(iter(ds_train))
    return ds_train, ds_test, minibatch


def get_mixture_toydata(dataset: str = "mnist", n_mixed: int = 10,
                        seed: int = 0, data_dir: Optional[str] = None):
    """Two dequantised toy batches and their mean mixture
    (data_loader.py:41-66). Returns (mixed, gt1, gt2, minibatch).

    Deliberate deviation from the reference: sources are dequantised in the
    RAW [0, 256) scale (``x + U[0,1)``) rather than the reference's
    ``x/256 - 0.5`` — the committed reference image path never runs (its
    ``load_toydata`` call passes a kwarg that doesn't exist,
    data_loader.py:50 vs :10) and its scale matches neither of its trained
    priors. The separation driver rescales per model type: NCSN priors see
    [0,1] (their training scale), Glow priors see raw [0,256) (their
    ``ImgPreprocessing`` bijector rescales internally).
    """
    ds, _, minibatch = load_toydata(dataset, n_mixed, seed, data_dir)
    rng = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(rng)
    it = iter(ds)
    gt1 = jnp.asarray(next(it))
    gt2 = jnp.asarray(next(it))
    shape = gt1.shape
    gt1 = gt1 + jax.random.uniform(k1, shape)
    gt2 = gt2 + jax.random.uniform(k2, shape)
    mixed = (gt1 + gt2) / 2.0
    return mixed, gt1, gt2, minibatch


# ---------------------------------------------------------------------------
# song extract for separation (data_loader.py:113-180)
# ---------------------------------------------------------------------------

def get_song_extract(mix_path: str, piano_path: str, violin_path: str,
                     duration: float, length_sec: float = 2.04,
                     sr: int = 16000, n_fft: int = 2048,
                     hop_length: int = 512, n_mels: int = 96,
                     fmin: float = 125.0, fmax: float = 7600.0,
                     dbmin: float = -100.0, dbmax: float = 20.0,
                     use_dB: bool = True, skip_frames: int = 2):
    """Load mixture + sources, window, and compute (batched, on-device) the
    mel spectrograms and the complex mixture STFT kept for phase-reuse
    inversion.

    Returns ``(mel_spec [3][n, n_mels, F, 1], raw_audio [3][T],
    stft_mixture [n, bins, F] complex)``.
    """
    n_extract = int(round(duration / length_sec))
    windows = []
    for path in (mix_path, piano_path, violin_path):
        w, _ = load_wav(path, length_sec, sr=sr)
        windows.append(w[skip_frames: skip_frames + n_extract])
    mix_w, piano_w, violin_w = windows
    raw_audio = [w.reshape(-1) for w in windows]

    all_w = jnp.asarray(np.stack(windows))          # [3, n, L]
    stft_mixture = np.asarray(stft(all_w[0], n_fft=n_fft,
                                   hop_length=hop_length))  # [n, bins, F]

    if use_dB:
        # match the reference exactly (data_loader.py:161-164): UNCLIPPED
        # mel power -> librosa.power_to_db (amin=1e-10, per-window
        # top_db=80 floor at window_max - 80 dB) -> clip [dbmin, dbmax].
        # The floor must see the unclipped per-window max, so the power
        # clip is skipped here (clip=False).
        mels = melspectrogram(all_w, sr=sr, n_fft=n_fft,
                              hop_length=hop_length, n_mels=n_mels,
                              fmin=fmin, fmax=fmax, use_dB=False,
                              clip=False)
        mels = jnp.clip(power_to_db(mels, top_db=80.0, window_ndim=2),
                        dbmin, dbmax)
    else:
        mels = melspectrogram(all_w, sr=sr, n_fft=n_fft,
                              hop_length=hop_length, n_mels=n_mels,
                              fmin=fmin, fmax=fmax, dbmin=dbmin,
                              dbmax=dbmax, use_dB=False)
    mel_spec = [np.asarray(mels[i])[..., None] for i in range(3)]
    return mel_spec, raw_audio, stft_mixture


# ---------------------------------------------------------------------------
# npy spectrogram storage (preprocessing.py:128-184)
# ---------------------------------------------------------------------------

def save_mel_spectrograms(spectrograms, filename: str) -> int:
    """Save each spectrogram as ``{filename}_{i}.npy``
    (preprocessing.py:128-143)."""
    count = 0
    for i, spect in enumerate(spectrograms):
        np.save(f"{filename}_{i}", np.asarray(spect))
        count += 1
    return count


def load_spec(directory: str) -> List[np.ndarray]:
    """Load all .npy spectrograms from one directory
    (preprocessing.py:146-164)."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npy"))
    return [np.load(os.path.join(directory, f)) for f in files]


def load_spec_tf(directory: str) -> List[np.ndarray]:
    """Walk a directory tree and load every .npy spectrogram
    (preprocessing.py:167-184)."""
    out: List[np.ndarray] = []
    for root, _, files in os.walk(os.path.abspath(directory)):
        if any(f.endswith(".npy") for f in files):
            out.extend(load_spec(root))
    return out
