#!/usr/bin/env python
"""Build the Keras-format ``mnist.npz`` cache the image/toy data path needs.

The reference loads MNIST through tfds (datasets/data_loader.py:10-38); this
environment has no network, so the loader
(``audiosourcesep_tpu.data.load_toydata``) reads a local npz cache instead.
Two ways to build it:

1. From the real MNIST IDX files (http://yann.lecun.com/exdb/mnist/), if you
   have them::

       python scripts/build_mnist_cache.py --idx-dir /path/with/idx/files

   Expects ``train-images-idx3-ubyte``, ``train-labels-idx1-ubyte``,
   ``t10k-images-idx3-ubyte``, ``t10k-labels-idx1-ubyte`` (``.gz`` ok).

2. Offline stand-in from scikit-learn's bundled 8x8 digits, bicubic-upsampled
   to 28x28::

       python scripts/build_mnist_cache.py --synthetic-digits

   This is NOT MNIST — bits/dim and PSNR numbers measured on it are not
   comparable to the thesis's MNIST baselines (Tables 3.1/3.2). It exists so
   the image pipeline (train_realnvp.py, train_glow.py --dataset mnist,
   run_basis_sep.py --dataset mnist) can run end-to-end in this offline
   container. The npz is stamped with a ``provenance`` key so downstream
   reports can tell which one they used.

The cache lands at ``~/.keras/datasets/mnist.npz`` (override with --out).
"""

import argparse
import gzip
import os
import struct
import sys

import numpy as np

# repo root on sys.path, so the script runs from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import audiosourcesep_tpu  # noqa: F401,E402


def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad IDX image magic {magic} in {path}"
        return np.frombuffer(f.read(n * rows * cols),
                             np.uint8).reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad IDX label magic {magic} in {path}"
        return np.frombuffer(f.read(n), np.uint8)


def from_idx(idx_dir: str):
    j = lambda name: os.path.join(idx_dir, name)
    return dict(
        x_train=read_idx_images(j("train-images-idx3-ubyte")),
        y_train=read_idx_labels(j("train-labels-idx1-ubyte")),
        x_test=read_idx_images(j("t10k-images-idx3-ubyte")),
        y_test=read_idx_labels(j("t10k-labels-idx1-ubyte")),
        provenance=np.str_("mnist-idx"),
    )


def _upsample_28(images8: np.ndarray) -> np.ndarray:
    """Bicubic 8x8 -> 28x28 via jax.image."""
    import jax.image
    import jax.numpy as jnp

    x = jnp.asarray(images8, jnp.float32)
    up = jax.image.resize(x, (x.shape[0], 28, 28), method="bicubic")
    up = jnp.clip(up * (255.0 / 16.0), 0, 255)
    return np.asarray(jnp.round(up), np.uint8)


def from_sklearn_digits(seed: int = 0):
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = _upsample_28(d.images)          # [1797, 28, 28] uint8
    labels = d.target.astype(np.uint8)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(imgs))
    n_test = len(imgs) // 6                # ~300 test, ~1500 train
    test_idx, train_idx = idx[:n_test], idx[n_test:]
    return dict(
        x_train=imgs[train_idx], y_train=labels[train_idx],
        x_test=imgs[test_idx], y_test=labels[test_idx],
        provenance=np.str_("sklearn-digits-upsampled-NOT-MNIST"),
    )


def main():
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--idx-dir", type=str,
                   help="directory with the 4 raw MNIST IDX files")
    g.add_argument("--synthetic-digits", action="store_true",
                   help="offline stand-in from sklearn's 8x8 digits "
                        "(NOT MNIST; see module docstring)")
    ap.add_argument("--out", type=str,
                    default=os.path.expanduser("~/.keras/datasets/mnist.npz"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    data = (from_idx(args.idx_dir) if args.idx_dir
            else from_sklearn_digits(args.seed))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **data)
    print(f"wrote {args.out}: x_train {data['x_train'].shape}, "
          f"x_test {data['x_test'].shape}, provenance={data['provenance']}")


if __name__ == "__main__":
    main()
