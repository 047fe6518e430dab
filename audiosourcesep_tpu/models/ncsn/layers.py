"""NCSN RefineNet building blocks (functional, NHWC).

Re-designs of /root/reference/ncsn/score_network.py (v1, conditional on the
noise-level index through ConditionalInstanceNorm2d+) and
score_network_v2.py (v2, unconditional InstanceNorm2d+; conditions only by
dividing the output score by sigma). Structure and quirks follow the
reference faithfully (e.g. RCU blocks apply convs without activations,
score_network_v2.py:41-47), since trained-statistics parity is the goal.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ... import nn

Array = jax.Array


def _norm2dplus(x, scale, alpha, bias, eps_in=1e-3, eps_means=1e-5):
    """InstanceNorm2d+ with folded [N, C] affine rows, written for XLA:

        out = scale * (x - mean_hw) * rsqrt(var_hw + eps)
              + alpha * norm_c(mean_hw) + bias

    Statistics come from ONE pass over x (sum and sum-of-squares fuse into
    a single f32-accumulating reduction loop; ``jnp.var``'s two-pass
    formulation reads x twice more), and the whole normalisation collapses
    to one multiply-add per element: ``x * a + b``, which XLA fuses into
    the surrounding conv epilogues.
    """
    xf = x.astype(jnp.float32)
    s1 = jnp.mean(xf, axis=(1, 2), keepdims=True)             # [N,1,1,C]
    s2 = jnp.mean(xf * xf, axis=(1, 2), keepdims=True)
    # one-pass E[x^2]-E[x]^2 can go slightly NEGATIVE under f32
    # catastrophic cancellation (large means, small spread) -> NaN out of
    # rsqrt; clamp to 0 (free in the fused epilogue)
    var = jnp.maximum(s2 - s1 * s1, 0.0)
    m = jnp.mean(s1, axis=-1, keepdims=True)
    v = jnp.maximum(jnp.mean(s1 * s1, axis=-1, keepdims=True) - m * m, 0.0)
    means_n = (s1 - m) * jax.lax.rsqrt(v + eps_means)
    a = scale[:, None, None, :] * jax.lax.rsqrt(var + eps_in)
    b = alpha[:, None, None, :] * means_n + bias[:, None, None, :] - a * s1
    return (xf * a + b).astype(x.dtype)


# ---------------------------------------------------------------------------
# normalisers
# ---------------------------------------------------------------------------

class InstanceNorm2dPlus:
    """InstanceNorm2d+ (score_network_v2.py:174-199).

    Normalises instance means across channels and reinjects them via a
    learnable ``alpha``, so the score keeps per-sample scale information:
    ``out = gamma * IN(x) + norm(mean_c(x)) * alpha + beta``.

    Computed via :func:`_norm2dplus` with the instance-norm affine and the
    outer gamma/beta folded into per-sample rows.
    """

    def __init__(self, num_features: int, bias: bool = True):
        self.num_features = num_features
        self.bias = bias

    def init_params(self, key):
        ka, kg = jax.random.split(key)
        p = {
            "in": nn.instance_norm_init(self.num_features),
            "alpha": nn.normal_init(ka, (self.num_features,), 0.02),
            "gamma": nn.normal_init(kg, (self.num_features,), 0.02),
        }
        if self.bias:
            p["beta"] = jnp.zeros((self.num_features,))
        return p

    def apply(self, params, x, y=None):
        N = x.shape[0]
        g_in = params["in"].get("gamma", 1.0)
        b_in = params["in"].get("beta", 0.0)
        scale = params["gamma"] * g_in
        bias = params["gamma"] * b_in
        if self.bias:
            bias = bias + params["beta"]
        tile = lambda r: jnp.broadcast_to(r, (N, self.num_features))
        return _norm2dplus(x, tile(scale), tile(params["alpha"]),
                           tile(bias))


class ConditionalInstanceNorm2dPlus:
    """InstanceNorm2d+ with per-noise-level (gamma, alpha, beta) embeddings
    (score_network.py:181-221)."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        self.num_features = num_features
        self.num_classes = num_classes
        self.bias = bias

    def init_params(self, key):
        ka, kg = jax.random.split(key)
        p = {
            "in": nn.instance_norm_init(self.num_features),
            "embed_gamma": nn.normal_init(
                kg, (self.num_classes, self.num_features), 0.02),
            "embed_alpha": nn.normal_init(
                ka, (self.num_classes, self.num_features), 0.02),
        }
        if self.bias:
            p["embed_beta"] = jnp.zeros((self.num_classes,
                                         self.num_features))
        return p

    def apply(self, params, x, y):
        gamma = params["embed_gamma"][y]                      # [N, C]
        alpha = params["embed_alpha"][y]
        g_in = params["in"].get("gamma", 1.0)
        b_in = params["in"].get("beta", 0.0)
        scale = gamma * g_in
        bias = gamma * b_in
        if self.bias:
            bias = bias + params["embed_beta"][y]
        return _norm2dplus(x, scale, alpha, bias)


def make_normalizer(num_features: int, num_classes: Optional[int],
                    bias: bool = True):
    if num_classes is None:
        return InstanceNorm2dPlus(num_features, bias)
    return ConditionalInstanceNorm2dPlus(num_features, num_classes, bias)


# ---------------------------------------------------------------------------
# residual blocks
# ---------------------------------------------------------------------------

class ResidualBlock:
    """Conditional/unconditional residual block
    (score_network.py:121-178 / score_network_v2.py:110-171).

    ``resample='down'`` without dilation halves the resolution by average
    pooling; dilated variants keep resolution (dilation 2/4 widen the
    receptive field instead).
    """

    def __init__(self, input_dim: int, output_dim: int,
                 num_classes: Optional[int], resample: Optional[str] = None,
                 dilation: Optional[int] = None, act=jax.nn.elu):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.resample = resample
        self.dilation = dilation
        self.act = act
        self.norm1 = make_normalizer(input_dim, num_classes)
        self.norm2 = make_normalizer(
            input_dim if resample == "down" else output_dim, num_classes)

    @property
    def identity_shortcut(self) -> bool:
        return self.output_dim == self.input_dim and self.resample is None

    def init_params(self, key):
        k1, k2, k3, kn1, kn2 = jax.random.split(key, 5)
        d = self.dilation
        p = {"norm1": self.norm1.init_params(kn1),
             "norm2": self.norm2.init_params(kn2)}
        if self.resample == "down":
            if d is not None:
                p["conv1"] = nn.conv2d_init(k1, self.input_dim,
                                            self.input_dim, 3)
                p["conv2"] = nn.conv2d_init(k2, self.input_dim,
                                            self.output_dim, 3)
                p["shortcut"] = nn.conv2d_init(k3, self.input_dim,
                                               self.output_dim, 3)
            else:
                p["conv1"] = nn.conv2d_init(k1, self.input_dim,
                                            self.input_dim, 3,
                                            use_bias=False)
                p["conv2"] = nn.conv2d_init(k2, self.input_dim,
                                            self.output_dim, 3)
                p["shortcut"] = nn.conv2d_init(k3, self.input_dim,
                                               self.output_dim, 1)
        else:
            if d is not None:
                p["conv1"] = nn.conv2d_init(k1, self.input_dim,
                                            self.output_dim, 3)
                p["conv2"] = nn.conv2d_init(k2, self.output_dim,
                                            self.output_dim, 3)
                p["shortcut"] = nn.conv2d_init(k3, self.input_dim,
                                               self.output_dim, 3)
            else:
                p["conv1"] = nn.conv2d_init(k1, self.input_dim,
                                            self.output_dim, 3,
                                            use_bias=False)
                p["conv2"] = nn.conv2d_init(k2, self.output_dim,
                                            self.output_dim, 3,
                                            use_bias=False)
                if not self.identity_shortcut:
                    p["shortcut"] = nn.conv2d_init(k3, self.input_dim,
                                                   self.output_dim, 3,
                                                   use_bias=False)
        # identity-shortcut dilated blocks also never touch their shortcut
        # conv (the reference's Keras layer stays unbuilt -> no variables)
        if self.identity_shortcut:
            p.pop("shortcut", None)
        return p

    def apply(self, params, x, y=None):
        d = self.dilation
        h = self.norm1.apply(params["norm1"], x, y)
        h = self.act(h)
        h = nn.conv2d(params["conv1"], h, dilation=d or 1)
        h = self.norm2.apply(params["norm2"], h, y)
        h = self.act(h)
        h = nn.conv2d(params["conv2"], h, dilation=d or 1)
        if self.resample == "down" and d is None:
            h = nn.avg_pool2(h)

        if self.identity_shortcut:
            shortcut = x
        else:
            shortcut = nn.conv2d(params["shortcut"], x, dilation=d or 1)
            if self.resample == "down" and d is None:
                shortcut = nn.avg_pool2(shortcut)
        return shortcut + h


# ---------------------------------------------------------------------------
# RefineNet blocks (CRP / RCU / MSF)
# ---------------------------------------------------------------------------

class CRPBlock:
    """Chained residual pooling.

    v1 (conditional): relu-family act, 5x5 average pooling, conditional norm
    before each conv (score_network.py:7-28). v2: elu, 5x5 max pooling, no
    norm (score_network_v2.py:6-25).
    """

    def __init__(self, features: int, n_stages: int,
                 num_classes: Optional[int], act=jax.nn.elu):
        self.features = features
        self.n_stages = n_stages
        self.num_classes = num_classes
        self.act = act
        if num_classes is not None:
            self.norms = [make_normalizer(features, num_classes)
                          for _ in range(n_stages)]

    def init_params(self, key):
        keys = jax.random.split(key, 2 * self.n_stages)
        p = {}
        for i in range(self.n_stages):
            p[f"conv_{i}"] = nn.conv2d_init(keys[2 * i], self.features,
                                            self.features, 3, use_bias=False)
            if self.num_classes is not None:
                p[f"norm_{i}"] = self.norms[i].init_params(keys[2 * i + 1])
        return p

    def apply(self, params, x, y=None):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            if self.num_classes is not None:
                path = self.norms[i].apply(params[f"norm_{i}"], path, y)
                path = nn.avg_pool_same(path, 5)
            else:
                path = nn.max_pool_same(path, 5)
            path = nn.conv2d(params[f"conv_{i}"], path)
            x = x + path
        return x


class RCUBlock:
    """Residual conv unit.

    v1: (norm -> conv) x n_stages per block (score_network.py:31-54);
    v2: conv x n_stages per block (score_network_v2.py:28-47).
    """

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 num_classes: Optional[int], act=jax.nn.elu):
        self.features = features
        self.n_blocks = n_blocks
        self.n_stages = n_stages
        self.num_classes = num_classes
        self.act = act
        if num_classes is not None:
            self.norms = [make_normalizer(features, num_classes)
                          for _ in range(n_blocks * n_stages)]

    def init_params(self, key):
        n = self.n_blocks * self.n_stages
        keys = jax.random.split(key, 2 * n)
        p = {}
        for i in range(n):
            p[f"conv_{i}"] = nn.conv2d_init(keys[2 * i], self.features,
                                            self.features, 3, use_bias=False)
            if self.num_classes is not None:
                p[f"norm_{i}"] = self.norms[i].init_params(keys[2 * i + 1])
        return p

    def apply(self, params, x, y=None):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                k = i * self.n_stages + j
                if self.num_classes is not None:
                    x = self.norms[k].apply(params[f"norm_{k}"], x, y)
                x = nn.conv2d(params[f"conv_{k}"], x)
            x = x + residual
        return x


class MSFBlock:
    """Multi-resolution fusion: per-input (norm ->) conv -> bilinear resize
    -> sum (score_network.py:57-79 / score_network_v2.py:50-69)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: Optional[int]):
        self.in_planes = list(in_planes)
        self.features = features
        self.num_classes = num_classes
        if num_classes is not None:
            self.norms = [make_normalizer(c, num_classes)
                          for c in self.in_planes]

    def init_params(self, key):
        keys = jax.random.split(key, 2 * len(self.in_planes))
        p = {}
        for i, c in enumerate(self.in_planes):
            p[f"conv_{i}"] = nn.conv2d_init(keys[2 * i], c, self.features, 3)
            if self.num_classes is not None:
                p[f"norm_{i}"] = self.norms[i].init_params(keys[2 * i + 1])
        return p

    def apply(self, params, xs, shape, y=None):
        total = None
        for i, x in enumerate(xs):
            h = x
            if self.num_classes is not None:
                h = self.norms[i].apply(params[f"norm_{i}"], h, y)
            h = nn.conv2d(params[f"conv_{i}"], h)
            h = nn.resize_bilinear(h, shape)
            total = h if total is None else total + h
        return total


class RefineBlock:
    """RefineNet decoder block: per-input RCUs -> MSF -> CRP -> output RCU
    (score_network.py:82-118 / score_network_v2.py:72-107)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: Optional[int], act=jax.nn.elu,
                 start: bool = False, end: bool = False):
        self.in_planes = list(in_planes)
        self.features = features
        self.start = start
        self.adapt = [RCUBlock(c, 2, 2, num_classes, act)
                      for c in self.in_planes]
        self.output_conv = RCUBlock(features, 3 if end else 1, 2,
                                    num_classes, act)
        if not start:
            self.msf = MSFBlock(self.in_planes, features, num_classes)
        self.crp = CRPBlock(features, 2, num_classes, act)

    def init_params(self, key):
        keys = jax.random.split(key, len(self.adapt) + 3)
        p = {f"adapt_{i}": a.init_params(keys[i])
             for i, a in enumerate(self.adapt)}
        p["output"] = self.output_conv.init_params(keys[-3])
        if not self.start:
            p["msf"] = self.msf.init_params(keys[-2])
        p["crp"] = self.crp.init_params(keys[-1])
        return p

    def apply(self, params, xs, shape, y=None):
        hs = [a.apply(params[f"adapt_{i}"], x, y)
              for i, (a, x) in enumerate(zip(self.adapt, xs))]
        if len(hs) > 1:
            h = self.msf.apply(params["msf"], hs, shape, y)
        else:
            h = hs[0]
        h = self.crp.apply(params["crp"], h, y)
        return self.output_conv.apply(params["output"], h, y)
