"""Minimal functional NN layers (explicit param pytrees, NHWC).

The whole framework uses these instead of a layer library so that params
stay plain pytrees: flows can stack per-noise-level parameter sets for the
BASIS Glow prior with a single ``jax.tree_util.tree_map(jnp.stack, ...)``
and every apply function jits/shards transparently.

Initialisation follows Keras defaults (glorot_uniform kernels, zero biases)
so trained-statistics parity with the reference is meaningful.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def glorot_uniform(key: Array, shape: Tuple[int, ...],
                   dtype=jnp.float32) -> Array:
    """Keras-default Glorot/Xavier uniform for HWIO conv / IO dense kernels."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:  # HWIO
        rf = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def normal_init(key: Array, shape: Tuple[int, ...], stddev: float = 0.02,
                dtype=jnp.float32) -> Array:
    return stddev * jax.random.normal(key, shape, dtype)


# ---------------------------------------------------------------------------
# conv / dense
# ---------------------------------------------------------------------------

_DIMSPEC = ("NHWC", "HWIO", "NHWC")


def conv2d_init(key: Array, in_ch: int, out_ch: int, kernel_size: int = 3,
                use_bias: bool = True, zero_init: bool = False,
                dtype=jnp.float32) -> dict:
    kshape = (kernel_size, kernel_size, in_ch, out_ch)
    kernel = (jnp.zeros(kshape, dtype) if zero_init
              else glorot_uniform(key, kshape, dtype))
    p = {"kernel": kernel}
    if use_bias:
        p["bias"] = jnp.zeros((out_ch,), dtype)
    return p


def conv2d(params: dict, x: Array, stride: int = 1, dilation: int = 1,
           padding: str = "SAME") -> Array:
    kernel = params["kernel"]
    y = jax.lax.conv_general_dilated(
        x, kernel.astype(x.dtype),
        window_strides=(stride, stride),
        padding=padding,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=_DIMSPEC,
    )
    if "bias" in params:
        y = y + params["bias"].astype(x.dtype)
    return y


def dense_init(key: Array, in_dim: int, out_dim: int, use_bias: bool = True,
               zero_init: bool = False, dtype=jnp.float32) -> dict:
    kernel = (jnp.zeros((in_dim, out_dim), dtype) if zero_init
              else glorot_uniform(key, (in_dim, out_dim), dtype))
    p = {"kernel": kernel}
    if use_bias:
        p["bias"] = jnp.zeros((out_dim,), dtype)
    return p


def dense(params: dict, x: Array) -> Array:
    y = x @ params["kernel"].astype(x.dtype)
    if "bias" in params:
        y = y + params["bias"].astype(x.dtype)
    return y


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def frozen_batchnorm_init(num_features: int, dtype=jnp.float32) -> dict:
    return {"gamma": jnp.ones((num_features,), dtype),
            "beta": jnp.zeros((num_features,), dtype)}


def frozen_batchnorm(params: dict, x: Array, eps: float = 1e-3) -> Array:
    """Per-channel affine ``gamma * x / sqrt(1+eps) + beta``.

    The reference's Keras BatchNormalization layers inside coupling nets
    (flow_tfk_layers.py:61-66) are only ever called in inference mode from
    custom training loops, so their moving statistics stay at (0, 1) forever
    and the layer degenerates to exactly this affine map. Implemented as
    such — pure, stateless, and an honest description of the computation.
    """
    g = params["gamma"].astype(x.dtype) * jax.lax.rsqrt(
        jnp.asarray(1.0 + eps, x.dtype))
    return x * g + params["beta"].astype(x.dtype)


def instance_norm_init(num_features: int, scale_offset: bool = True,
                       dtype=jnp.float32) -> dict:
    p = {}
    if scale_offset:
        p = {"gamma": jnp.ones((num_features,), dtype),
             "beta": jnp.zeros((num_features,), dtype)}
    return p


def instance_norm(params: dict, x: Array, eps: float = 1e-3) -> Array:
    """Per-sample, per-channel normalisation over H, W (tfa default eps=1e-3).

    Statistics accumulate in float32 regardless of compute dtype (bf16
    variance over thousands of pixels loses too much precision)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(1, 2), keepdims=True)
    var = jnp.var(xf, axis=(1, 2), keepdims=True)
    h = ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)
    if "gamma" in params:
        h = h * params["gamma"].astype(x.dtype) + params["beta"].astype(x.dtype)
    return h


def layer_norm_init(num_features: int, dtype=jnp.float32) -> dict:
    return {"gamma": jnp.ones((num_features,), dtype),
            "beta": jnp.zeros((num_features,), dtype)}


def layer_norm(params: dict, x: Array, eps: float = 1e-3) -> Array:
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    h = (x - mean) * jax.lax.rsqrt(var + eps)
    return h * params["gamma"].astype(x.dtype) + params["beta"].astype(x.dtype)


# ---------------------------------------------------------------------------
# weight-normalised conv (RealNVP coupling nets, flow_tfk_layers.py:87-97)
# ---------------------------------------------------------------------------

def wnconv2d_init(key: Array, in_ch: int, out_ch: int, kernel_size: int = 3,
                  use_bias: bool = True, zero_init: bool = False,
                  dtype=jnp.float32) -> dict:
    kshape = (kernel_size, kernel_size, in_ch, out_ch)
    v = (jnp.zeros(kshape, dtype) if zero_init
         else glorot_uniform(key, kshape, dtype))
    norm = jnp.sqrt(jnp.sum(v * v, axis=(0, 1, 2)) + 1e-12)
    p = {"v": v, "g": norm}
    if use_bias:
        p["bias"] = jnp.zeros((out_ch,), dtype)
    return p


def wnconv2d(params: dict, x: Array, stride: int = 1,
             padding: str = "SAME") -> Array:
    v = params["v"]
    norm = jnp.sqrt(jnp.sum(v * v, axis=(0, 1, 2)) + 1e-12)
    kernel = (params["g"] / norm) * v
    y = jax.lax.conv_general_dilated(
        x, kernel.astype(x.dtype), (stride, stride), padding,
        dimension_numbers=_DIMSPEC)
    if "bias" in params:
        y = y + params["bias"].astype(x.dtype)
    return y


# ---------------------------------------------------------------------------
# pooling / resize
# ---------------------------------------------------------------------------

def avg_pool_same(x: Array, window: int, stride: int = 1) -> Array:
    """Average pooling with SAME padding (counts only valid elements).

    Separable formulation: a KxK sum window is the composition of Kx1 and
    1xK sum windows, and the SAME valid-count is the product of the per-axis
    counts — identical math to the single 2-D ``reduce_window``, at O(2K)
    instead of O(K^2) reads per element. (Only exact for stride 1, which is
    the only stride the model uses; a 2-D window with stride would sample
    different row phases.)
    """
    if stride != 1:
        ones = jnp.ones(x.shape[1:3], x.dtype)[None, :, :, None]
        dims = (1, window, window, 1)
        strides = (1, stride, stride, 1)
        s = jax.lax.reduce_window(x, 0.0, jax.lax.add, dims, strides, "SAME")
        n = jax.lax.reduce_window(ones, 0.0, jax.lax.add, dims, strides,
                                  "SAME")
        return s / n
    s = jax.lax.reduce_window(x, 0.0, jax.lax.add, (1, window, 1, 1),
                              (1, 1, 1, 1), "SAME")
    s = jax.lax.reduce_window(s, 0.0, jax.lax.add, (1, 1, window, 1),
                              (1, 1, 1, 1), "SAME")
    ones = jnp.ones(x.shape[1:3], x.dtype)[None, :, :, None]
    n = jax.lax.reduce_window(ones, 0.0, jax.lax.add, (1, window, 1, 1),
                              (1, 1, 1, 1), "SAME")
    n = jax.lax.reduce_window(n, 0.0, jax.lax.add, (1, 1, window, 1),
                              (1, 1, 1, 1), "SAME")
    return s / n


def max_pool_same(x: Array, window: int, stride: int = 1) -> Array:
    if stride == 1:
        # separable (exact for stride 1): KxK max = Kx1 max then 1xK max
        h = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                  (1, window, 1, 1), (1, 1, 1, 1), "SAME")
        return jax.lax.reduce_window(h, -jnp.inf, jax.lax.max,
                                     (1, 1, window, 1), (1, 1, 1, 1), "SAME")
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, stride, stride, 1), "SAME")


def avg_pool2(x: Array) -> Array:
    """2x2 average pooling, stride 2 (Keras AveragePooling2D(pool_size=2))."""
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") * 0.25


def resize_bilinear(x: Array, size: Tuple[int, int]) -> Array:
    """tf.image.resize default: bilinear, half-pixel centers, no antialias.

    Same-size resize is the identity (common in the RefineNet MSF blocks,
    where inputs often already share the target resolution)."""
    if (x.shape[1], x.shape[2]) == tuple(size):
        return x
    return jax.image.resize(
        x, (x.shape[0], size[0], size[1], x.shape[3]), method="bilinear")


def embedding_init(key: Array, num_embeddings: int, dim: int,
                   dtype=jnp.float32) -> dict:
    return {"table": jax.random.uniform(
        key, (num_embeddings, dim), dtype, -0.05, 0.05)}


def embedding(params: dict, idx: Array) -> Array:
    return params["table"][idx]
