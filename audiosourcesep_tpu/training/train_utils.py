"""Shared run infrastructure: optimizers, EMA, TensorBoard, config, figures.

Equivalent of /root/reference/train_utils.py, re-based on optax /
tensorboardX. MirroredStrategy scope plumbing disappears — sharding is
decided at jit time (see ``parallel``).
"""

from __future__ import annotations

import argparse
import datetime
import io
import os
import re
import shutil
from typing import Any, Optional, Tuple

import jax
import numpy as np
import optax


# ---------------------------------------------------------------------------
# optimizer (train_utils.py:23-41)
# ---------------------------------------------------------------------------

def setup_optimizer(optimizer: str = "adam",
                    learning_rate: float = 1e-3,
                    clipnorm: Optional[float] = None
                    ) -> optax.GradientTransformation:
    """adam/adamax (reference train_utils.py:23-41) with an optional
    global-norm gradient clip prepended — the reference has no clipping,
    but Flow++-style models diverge without it (measured: a tiny Flow++
    NLL descent NaNs after ~50 adam steps at lr 1e-3; clipnorm=1
    stabilises it, tests/test_flowpp.py)."""
    if optimizer == "adam":
        opt = optax.adam(learning_rate)
    elif optimizer == "adamax":
        opt = optax.adamax(learning_rate)
    else:
        raise ValueError("optimizer argument should be adam or adamax")
    if clipnorm is not None:
        opt = optax.chain(optax.clip_by_global_norm(clipnorm), opt)
    return opt


def ema_update(ema_params: Any, params: Any, decay: float = 0.99) -> Any:
    """tfa.optimizers.MovingAverage equivalent (train_ncsn.py:328-329)."""
    return jax.tree_util.tree_map(
        lambda e, p: decay * e + (1.0 - decay) * p, ema_params, params)


# ---------------------------------------------------------------------------
# tensorboard (train_utils.py:44-59)
# ---------------------------------------------------------------------------

class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def add_audio(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def setup_tensorboard(log_root: str = "tensorboard_logs",
                      clear: bool = True) -> Tuple[Any, Any]:
    """Create train/test writers; clears prior logs like the reference."""
    if clear:
        shutil.rmtree(log_root, ignore_errors=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    try:
        from tensorboardX import SummaryWriter
        train_w = SummaryWriter(os.path.join(log_root, "gradient_tape",
                                             stamp, "train"))
        test_w = SummaryWriter(os.path.join(log_root, "gradient_tape",
                                            stamp, "test"))
        return train_w, test_w
    except Exception as e:  # pragma: no cover - depends on install
        print(f"WARNING: tensorboardX unavailable ({e!r}); "
              "summaries disabled (NullWriter)", flush=True)
        return _NullWriter(), _NullWriter()


# ---------------------------------------------------------------------------
# figures (train_utils.py:78-111); matplotlib and PIL are optional — without
# them figure summaries are skipped, as all summaries are without tensorboardX
# ---------------------------------------------------------------------------

def pyplot():
    """``matplotlib.pyplot``, or ``None`` where matplotlib is not installed."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_to_image(figure) -> Optional[np.ndarray]:
    """matplotlib figure -> HWC uint8 array (for add_image); ``None`` for
    no figure or where PIL is not installed."""
    if figure is None:
        return None
    try:
        from PIL import Image
    except ImportError:
        pyplot().close(figure)
        return None
    buf = io.BytesIO()
    figure.savefig(buf, format="png")
    pyplot().close(figure)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGBA"))


def image_grid(sample: np.ndarray, data_shape, data_type: str = "image",
               **kwargs):
    """4x8 grid of images or mel spectrograms (specshow-style origin);
    ``None`` where matplotlib is not installed."""
    plt = pyplot()
    if plt is None:
        return None
    f, axes = plt.subplots(4, 8, figsize=(12, 6))
    axes = axes.flatten()
    sample = np.asarray(sample)
    if sample.shape[-1] == 1:
        sample = np.squeeze(sample, axis=-1)
    for i, ax in enumerate(axes):
        ax.set_axis_off()
        if i > len(sample) - 1:
            continue
        if data_type == "image":
            ax.imshow(sample[i])
        else:
            ax.imshow(sample[i], origin="lower", aspect="auto",
                      cmap="magma")
    return f


def add_figure(writer, tag: str, figure, step: int) -> None:
    """Write a figure summary; a no-op when the figure cannot be rendered."""
    img = plot_to_image(figure)
    if img is not None:
        writer.add_image(tag, img, step, dataformats="HWC")


# ---------------------------------------------------------------------------
# config (train_utils.py:114-131): the configs are flat ``key: value``
# scalars, read without a YAML library
# ---------------------------------------------------------------------------

_INT = re.compile(r"[-+]?[0-9]+\Z")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?\Z")
_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}


def _scalar(text: str):
    """One YAML 1.1 plain or quoted scalar, typed as ``yaml.safe_load``
    types it."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text.lower() in _BOOLS:
        return _BOOLS[text.lower()]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and text not in ("+.", "-.", "."):
        return float(text.replace("_", ""))
    return text


def read_flat_config(config_path: str) -> dict:
    """Parse a flat ``key: value`` config (the format of ``configs/*.yml``).

    Blank lines and ``#`` comments are skipped. Nested mappings, lists and
    multi-line values are rejected: no config of this repo has them.
    """
    config = {}
    with open(config_path) as f:
        for n, line in enumerate(f, 1):
            body = line.split(" #")[0].rstrip()
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            key, sep, value = body.partition(":")
            if not sep or body[0].isspace() or not key.strip() \
                    or key.strip().startswith("-"):
                raise ValueError(f"{config_path}:{n}: expected a flat "
                                 f"'key: value' line, got {line!r}")
            config[key.strip()] = _scalar(value.strip())
    return config


def get_config(config_path: str) -> argparse.Namespace:
    return dict2namespace(read_flat_config(config_path))


def dict2namespace(config: dict) -> argparse.Namespace:
    ns = argparse.Namespace()
    for key, value in config.items():
        setattr(ns, key,
                dict2namespace(value) if isinstance(value, dict) else value)
    return ns


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def is_bad(loss) -> bool:
    """NaN/Inf abort condition (train_glow.py:113-118)."""
    loss = float(loss)
    return not np.isfinite(loss)
