"""ActNorm, invertible 1x1 convolution, squeeze, and preprocessing bijectors.

Functional JAX re-designs of the reference layers
(/root/reference/flow_models/flow_tfp_bijectors.py:156-396). Inputs are NHWC.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .core import Bijector, sum_event


class ActNorm(Bijector):
    """Per-channel affine ``y = x * exp(log_scale) + shift``.

    Data-dependent init from the example minibatch: post-actnorm activations
    have zero mean / unit variance per channel (``normalize='channel'``,
    reference flow_tfp_bijectors.py:222-225) or per element
    (``normalize='all'``, :227-230). log-det = H*W*sum(log_scale)
    (:250-253).
    """

    name = "actnorm"

    def __init__(self, normalize: str = "channel", eps: float = 1e-8):
        assert normalize in ("channel", "all")
        self.normalize = normalize
        self.eps = eps

    def init_params(self, key, x):
        if self.normalize == "channel":
            mean = jnp.mean(x, axis=(0, 1, 2))
            std = jnp.std(x, axis=(0, 1, 2)) + self.eps
        else:
            mean = jnp.mean(x, axis=0)
            std = jnp.sqrt(jnp.var(x, axis=0)) + self.eps
        return {"log_scale": -jnp.log(std), "shift": -mean / std}

    def reinit(self, params, x):
        new = self.init_params(None, x)
        y, _ = self.forward(new, x)
        return new, y

    def forward(self, params, x, rng=None):
        y = x * jnp.exp(params["log_scale"]) + params["shift"]
        H, W = x.shape[1], x.shape[2]
        if self.normalize == "channel":
            ld = H * W * jnp.sum(params["log_scale"])
        else:
            ld = jnp.sum(params["log_scale"])
        return y, jnp.full((x.shape[0],), ld, x.dtype)

    def inverse(self, params, y, rng=None):
        x = (y - params["shift"]) * jnp.exp(-params["log_scale"])
        H, W = y.shape[1], y.shape[2]
        if self.normalize == "channel":
            ld = H * W * jnp.sum(params["log_scale"])
        else:
            ld = jnp.sum(params["log_scale"])
        return x, jnp.full((y.shape[0],), ld, y.dtype)


class Invertible1x1Conv(Bijector):
    """PLU-parameterised invertible 1x1 convolution (Glow).

    ``W = P @ L @ (U + diag(sign_s * exp(log_s)))`` with P and sign_s fixed,
    L strictly-lower + I, U strictly-upper (reference
    flow_tfp_bijectors.py:256-322). The 1x1 conv is a single channel matmul
    ``y = x @ W`` — one matrix product instead of a conv kernel. The inverse
    uses triangular solves (no explicit ``inv`` as in the reference :308-317)
    for stability.

    log-det = H*W*sum(log_s).
    """

    name = "inv1x1"

    def init_params(self, key, x):
        C = x.shape[-1]
        w = jnp.linalg.qr(jax.random.normal(key, (C, C)))[0]
        P, L, U = jax.scipy.linalg.lu(w)
        s = jnp.diag(U)
        return {
            "P": P,                       # fixed permutation
            "sign_s": jnp.sign(s),        # fixed signs
            "L": jnp.tril(L, -1),         # trainable strictly-lower part
            "U": jnp.triu(U, 1),          # trainable strictly-upper part
            "log_s": jnp.log(jnp.abs(s)),
        }

    def _assemble(self, params):
        C = params["P"].shape[0]
        eye = jnp.eye(C, dtype=params["P"].dtype)
        L = jnp.tril(params["L"], -1) + eye
        U = jnp.triu(params["U"], 1) + jnp.diag(
            params["sign_s"] * jnp.exp(params["log_s"]))
        return L, U, eye

    def forward(self, params, x, rng=None):
        L, U, _ = self._assemble(params)
        W = params["P"] @ (L @ U)
        y = jnp.einsum("nhwc,cd->nhwd", x, W,
                      precision=jax.lax.Precision.HIGHEST)
        H, Wd = x.shape[1], x.shape[2]
        ld = H * Wd * jnp.sum(params["log_s"])
        return y, jnp.full((x.shape[0],), ld, x.dtype)

    def inverse(self, params, y, rng=None):
        L, U, eye = self._assemble(params)
        # W^-1 = U^-1 L^-1 P^T via triangular solves against identity.
        Linv = solve_triangular(L, eye, lower=True, unit_diagonal=True)
        Uinv = solve_triangular(U, eye, lower=False)
        Winv = Uinv @ (Linv @ params["P"].T)
        x = jnp.einsum("nhwc,cd->nhwd", y, Winv,
                      precision=jax.lax.Precision.HIGHEST)
        H, Wd = y.shape[1], y.shape[2]
        ld = H * Wd * jnp.sum(params["log_s"])
        return x, jnp.full((y.shape[0],), ld, y.dtype)


class Squeeze(Bijector):
    """Space-to-depth (H, W, C) -> (H/2, W/2, 4C); log-det 0.

    Matches the reference's element ordering (flow_tfp_bijectors.py:170-180):
    reshape (N, H/2, 2, W/2, 2, C) -> transpose (N, H/2, W/2, C, 2, 2) ->
    reshape, so checkpoint-converted weights keep channel order.
    """

    name = "squeeze"

    def init_params(self, key, x):
        return ()

    def forward(self, params, x, rng=None):
        N, H, W, C = x.shape
        y = x.reshape(N, H // 2, 2, W // 2, 2, C)
        y = y.transpose(0, 1, 3, 5, 2, 4)
        y = y.reshape(N, H // 2, W // 2, 4 * C)
        return y, jnp.zeros(N, x.dtype)

    def inverse(self, params, y, rng=None):
        N, H2, W2, C4 = y.shape
        C = C4 // 4
        x = y.reshape(N, H2, W2, C, 2, 2)
        x = x.transpose(0, 1, 4, 2, 5, 3)
        x = x.reshape(N, H2 * 2, W2 * 2, C)
        return x, jnp.zeros(N, y.dtype)


class ImgPreprocessing(Bijector):
    """Uniform dequantisation + optional logit: ``logit(a + (1-2a) x/256)``.

    The reference re-samples dequantisation noise inside the log-det pass
    (flow_tfp_bijectors.py:353-360) so output and log-det disagree; here both
    come from the same ``rng`` draw. With ``rng=None`` no noise is added
    (deterministic eval).
    """

    name = "img_preprocessing"

    def __init__(self, alpha: float = 0.05, use_logit: bool = True):
        self.alpha = alpha
        self.use_logit = use_logit

    def init_params(self, key, x):
        return ()

    def forward(self, params, x, rng=None):
        if rng is not None:
            x = x + jax.random.uniform(rng, x.shape, x.dtype)
        if self.use_logit:
            a = self.alpha
            u = a + (1.0 - 2 * a) * x / 256.0
            y = jnp.log(u) - jnp.log1p(-u)
            ld = -jnp.log(u) - jnp.log1p(-u) + jnp.log((1.0 - 2 * a) / 256.0)
            return y, sum_event(ld)
        y = x / 256.0 - 0.5
        ld = jnp.full(x.shape, -jnp.log(256.0), x.dtype)
        return y, sum_event(ld)

    def inverse(self, params, y, rng=None):
        if self.use_logit:
            a = self.alpha
            u = jax.nn.sigmoid(y)
            x = (u - a) * 256.0 / (1.0 - 2 * a)
            ld = -jnp.log(u) - jnp.log1p(-u) + jnp.log((1.0 - 2 * a) / 256.0)
            return x, sum_event(ld)
        x = (y + 0.5) * 256.0
        ld = jnp.full(y.shape, -jnp.log(256.0), y.dtype)
        return x, sum_event(ld)


class SpecPreprocessing(Bijector):
    """Min-max rescale to [0, 1] then logit (or shift by -0.5).

    Reference flow_tfp_bijectors.py:364-396. Note the reference's forward
    log-det (:390-396) has sign conventions that make it the true
    ``d y / d x`` only for the logit branch; this implementation returns the
    exact analytic log-det in both branches.
    """

    name = "spec_preprocessing"

    def __init__(self, minval: float, maxval: float, alpha: float = 1e-10,
                 use_logit: bool = True):
        self.minval = minval
        self.maxval = maxval
        self.alpha = alpha
        self.use_logit = use_logit

    def init_params(self, key, x):
        return ()

    def forward(self, params, x, rng=None):
        span = self.maxval - self.minval
        u = (x - self.minval) / span
        if self.use_logit:
            a = self.alpha
            v = (1.0 - 2 * a) * u + a
            y = jnp.log(v) - jnp.log1p(-v)
            ld = (-jnp.log(v) - jnp.log1p(-v)
                  + jnp.log(1.0 - 2 * a) - jnp.log(span))
            return y, sum_event(ld)
        y = u - 0.5
        ld = jnp.full(x.shape, -jnp.log(span), x.dtype)
        return y, sum_event(ld)

    def inverse(self, params, y, rng=None):
        span = self.maxval - self.minval
        if self.use_logit:
            a = self.alpha
            v = jax.nn.sigmoid(y)
            u = (v - a) / (1.0 - 2 * a)
            x = u * span + self.minval
            ld = (-jnp.log(v) - jnp.log1p(-v)
                  + jnp.log(1.0 - 2 * a) - jnp.log(span))
            return x, sum_event(ld)
        x = (y + 0.5) * span + self.minval
        ld = jnp.full(y.shape, -jnp.log(span), y.dtype)
        return x, sum_event(ld)
