"""Core bijector protocol — pure-functional flows under ``jax.jit``.

Design
------
The reference builds flows from stateful TFP bijector objects
(/root/reference/flow_models/flow_tfp_bijectors.py). Here a bijector is a
*static* Python object describing the transform; all learnable state lives in
an explicit param pytree, so the whole flow jits/vmaps/shards like any other
JAX function and per-noise-level parameter stacks (needed by BASIS with Glow
priors) are ordinary ``jnp.stack`` over pytrees.

Protocol (data -> latent is the ``forward`` direction, matching the
reference's ``TransformedDistribution(prior, Invert(chain))`` layout):

* ``init(key, x) -> (params, y)`` — build params from an example minibatch
  ``x`` and return ``y = forward(params, x)`` so that data-dependent
  initialisation (ActNorm, reference flow_glow.py:42-49) threads the batch
  through the partially-built chain naturally.
* ``forward(params, x, rng=None) -> (y, fldj)`` — ``fldj`` has shape ``(N,)``
  (log-det summed over event dims).
* ``inverse(params, y, rng=None) -> (x, fldj)`` — ``fldj`` is the *forward*
  log-det evaluated at the reconstructed ``x`` (callers negate for the
  inverse log-det).

``rng`` feeds stochastic bijectors (uniform dequantisation). Unlike the
reference (flow_tfp_bijectors.py:353-360, which re-samples noise in the
log-det pass, making it inconsistent with forward), forward computes the
output and its log-det from the same sample.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = Any
Array = jax.Array


def sum_event(x: Array) -> Array:
    """Sum over every axis except the leading batch axis."""
    return jnp.sum(x, axis=tuple(range(1, x.ndim)))


class Bijector:
    """Base class. Subclasses override ``init_params``/``forward``/``inverse``."""

    name: str = "bijector"

    def init(self, key: Array, x: Array) -> Tuple[Params, Array]:
        params = self.init_params(key, x)
        y, _ = self.forward(params, x)
        return params, y

    def init_params(self, key: Array, x: Array) -> Params:
        raise NotImplementedError

    def forward(self, params: Params, x: Array, rng: Optional[Array] = None
                ) -> Tuple[Array, Array]:
        raise NotImplementedError

    def inverse(self, params: Params, y: Array, rng: Optional[Array] = None
                ) -> Tuple[Array, Array]:
        raise NotImplementedError

    def reinit(self, params: Params, x: Array) -> Tuple[Params, Array]:
        """Recompute data-dependent statistics against a new minibatch.

        Mirrors :meth:`init`'s threading but keeps every TRAINED parameter,
        replacing only data-dependent ones (ActNorm stats). Default: no
        data-dependent state — forward ``x`` through the trained params.
        Composites override to recurse. Motivation: a flow fine-tuned on
        ``x + sigma * eps`` at large sigma sees activations far outside its
        fitted range and its tanh-bounded coupling scales saturate
        (measured: scores 1e8 x the smoothed-score scale, docs/DESIGN.md);
        re-anchoring the ActNorm stats restores calibrated activations in
        one cheap pass instead of thousands of optimizer steps.
        """
        y, _ = self.forward(params, x, None)
        return params, y

    # -- conveniences ------------------------------------------------------
    def forward_log_det_jacobian(self, params: Params, x: Array,
                                 rng: Optional[Array] = None) -> Array:
        return self.forward(params, x, rng)[1]

    def inverse_log_det_jacobian(self, params: Params, y: Array,
                                 rng: Optional[Array] = None) -> Array:
        return -self.inverse(params, y, rng)[1]


class Identity(Bijector):
    name = "identity"

    def init_params(self, key, x):
        return ()

    def forward(self, params, x, rng=None):
        return x, jnp.zeros(x.shape[0], x.dtype)

    def inverse(self, params, y, rng=None):
        return y, jnp.zeros(y.shape[0], y.dtype)


class Chain(Bijector):
    """Compose bijectors, applied first-to-last in the forward direction.

    (The reference uses ``tfb.Chain`` which applies *last*-to-first,
    e.g. flow_glow.py:21-22 ``Chain([coupling, inv1x1, actnorm])`` runs
    actnorm -> inv1x1 -> coupling; constructors here list bijectors in
    execution order instead.)

    Params are a dict keyed by unique layer names.
    """

    def __init__(self, bijectors: Sequence[Bijector], name: str = "chain"):
        self.name = name
        self.bijectors = list(bijectors)
        self.names = [f"{b.name}_{i}" for i, b in enumerate(self.bijectors)]

    def _rngs(self, rng, n):
        if rng is None:
            return [None] * n
        return list(jax.random.split(rng, n))

    def init(self, key, x):
        keys = jax.random.split(key, max(len(self.bijectors), 1))
        params = {}
        for k, name, b in zip(keys, self.names, self.bijectors):
            p, x = b.init(k, x)
            params[name] = p
        return params, x

    def init_params(self, key, x):
        return self.init(key, x)[0]

    def reinit(self, params, x):
        out = dict(params)
        for name, b in zip(self.names, self.bijectors):
            out[name], x = b.reinit(params[name], x)
        return out, x

    def forward(self, params, x, rng=None):
        total = jnp.zeros(x.shape[0], jnp.result_type(float))
        for r, name, b in zip(self._rngs(rng, len(self.bijectors)),
                              self.names, self.bijectors):
            x, fldj = b.forward(params[name], x, r)
            total = total + fldj
        return x, total

    def inverse(self, params, y, rng=None):
        total = jnp.zeros(y.shape[0], jnp.result_type(float))
        for r, name, b in zip(reversed(self._rngs(rng, len(self.bijectors))),
                              reversed(self.names), reversed(self.bijectors)):
            y, fldj = b.inverse(params[name], y, r)
            total = total + fldj
        return y, total


class Invert(Bijector):
    """Swap a bijector's forward and inverse directions."""

    def __init__(self, bijector: Bijector, name: Optional[str] = None):
        self.bijector = bijector
        self.name = name or f"invert_{bijector.name}"

    def init_params(self, key, x):
        # init threads x through the *forward* of the wrapped bijector's
        # inverse direction, which generally cannot use data-dependent init;
        # fall back to the wrapped bijector's init on x.
        return self.bijector.init_params(key, x)

    def init(self, key, x):
        params = self.init_params(key, x)
        y, _ = self.forward(params, x)
        return params, y

    def forward(self, params, x, rng=None):
        y, fldj = self.bijector.inverse(params, x, rng)
        return y, -fldj

    def inverse(self, params, y, rng=None):
        x, fldj = self.bijector.forward(params, y, rng)
        return x, -fldj
