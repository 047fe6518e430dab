"""NCSNv2 hyperparameter techniques (Song & Ermon 2020).

Re-design of /root/reference/technique1_ncsnv2.py and
technique2and4_ncsnv2.py. Technique 1 (max pairwise distance -> sigma_1) is
an O(n^2) pairwise reduction computed as a blocked Gram matmul on device
instead of a Python double loop.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy import optimize, stats


def max_pairwise_distance(X: np.ndarray, block: int = 512) -> float:
    """Technique 1: max Euclidean distance over all sample pairs.

    ``||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y`` computed block-wise as
    matmuls, replacing the reference's O(n^2) per-pair loop
    (technique1_ncsnv2.py:28-35).
    """
    flat = jnp.asarray(np.reshape(X, (len(X), -1)), jnp.float32)
    sq = jnp.sum(flat * flat, axis=1)
    best = 0.0
    for i in range(0, len(flat), block):
        xi = flat[i:i + block]
        gram = xi @ flat.T
        d2 = sq[i:i + block, None] + sq[None, :] - 2.0 * gram
        best = max(best, float(jnp.max(d2)))
    return math.sqrt(max(best, 0.0))


def technique1_sigma1(X: np.ndarray, minval: float = -100.0,
                      maxval: float = 20.0, max_samples: int = 2000) -> float:
    """sigma_1 for NCSNv2: max pairwise distance of rescaled spectrograms
    (technique1_ncsnv2.py:18-37)."""
    X = np.asarray(X[:max_samples])
    X = (X - minval) / (maxval - minval)
    return max_pairwise_distance(X)


def technique2_gamma(D: int, sigma1: float, sigmaL: float,
                     verbose: bool = True) -> Tuple[float, float]:
    """Noise-schedule ratio gamma s.t. Phi(sqrt(2D)(g-1)+3g) -
    Phi(sqrt(2D)(g-1)-3g) = 0.5 (technique2and4_ncsnv2.py:6-27).

    Returns (gamma, implied num_classes)."""
    def t2(gamma):
        cdf1 = stats.norm.cdf(np.sqrt(2.0 * D) * (gamma - 1.0) + 3 * gamma)
        cdf2 = stats.norm.cdf(np.sqrt(2.0 * D) * (gamma - 1.0) - 3 * gamma)
        return cdf1 - cdf2 - 0.5

    opt = optimize.root_scalar(t2, x0=0.5, x1=1.0, bracket=[0.5, 1.0])
    if not opt.converged and verbose:
        print("DID NOT FIND ROOT FOR GAMMA")
    gamma = opt.root
    n = np.log(sigmaL / sigma1) / np.log(gamma)
    if verbose:
        print(f"gamma={round(gamma, 4)}")
        print(f"num_classes = {round(n, 0)}")
    return gamma, n


def technique4_epsilon(T: float, sigmaL: float, gamma: float,
                       verbose: bool = True) -> float:
    """Langevin step size epsilon from the NCSNv2 paper's fixed-point
    condition (technique2and4_ncsnv2.py:30-44)."""
    s2 = sigmaL ** 2

    def t4(eps):
        decay = (1.0 - eps / s2) ** (2 * T)
        denom = s2 - s2 * (1.0 - eps / s2) ** 2
        ratio = 2.0 * eps / denom
        return decay * (gamma ** 2 - ratio) + ratio - 1.0

    opt = optimize.root_scalar(t4, x0=1e-6, x1=1e-4)
    if not opt.converged and verbose:
        print("DID NOT FIND ROOT FOR EPSILON")
    if verbose:
        print(f"epsilon={opt.root}")
    return opt.root
