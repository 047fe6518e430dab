"""NCSN RefineNet score networks (v1 conditional, v2 unconditional, v2-deep).

Re-designs of /root/reference/ncsn/score_network.py:224-302 (v1) and
score_network_v2.py:202-377 (v2 / deeper). Apply signature:
``apply(params, x, sigma_idx) -> score`` with ``x`` NHWC and ``sigma_idx``
an int32 vector (one noise-level index per sample).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ... import nn
from .layers import RefineBlock, ResidualBlock, make_normalizer

Array = jax.Array


class RefineNetDilated:
    """4-cascade dilated ResNet encoder + 4 RefineNet decoder blocks.

    ``num_classes`` set -> v1: every norm is conditional on the noise index
    and the input is rescaled ``2x - 1`` unless ``logit_transform``
    (score_network.py:277-278).
    ``sigmas`` set -> v2: unconditional norms; the output is divided by
    ``sigmas[sigma_idx]`` (score_network_v2.py:275-277).
    """

    def __init__(self, data_shape: Sequence[int], ngf: int,
                 num_classes: Optional[int] = None,
                 sigmas: Optional[np.ndarray] = None,
                 logit_transform: bool = False, deeper: bool = False,
                 compute_dtype=None):
        assert (num_classes is None) != (sigmas is None), \
            "exactly one of num_classes (v1) / sigmas (v2) must be given"
        self.data_shape = tuple(data_shape)
        self.ngf = ngf
        self.num_classes = num_classes
        self.sigmas = None if sigmas is None else jnp.asarray(sigmas)
        self.logit_transform = logit_transform
        self.deeper = deeper
        # compute_dtype=bfloat16 runs every conv in bf16 (norm statistics
        # stay f32, output returns f32) -- the fast path for the
        # Langevin/BASIS loops; None keeps the input dtype
        self.compute_dtype = compute_dtype
        self.act = jax.nn.elu
        nc = num_classes
        C = self.data_shape[-1]

        def res(i, o, resample=None, dilation=None):
            return ResidualBlock(i, o, nc, resample, dilation, self.act)

        if not deeper:
            self.res_stacks = [
                [res(ngf, ngf), res(ngf, ngf)],
                [res(ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 2 * ngf, "down", 2),
                 res(2 * ngf, 2 * ngf, None, 2)],
                [res(2 * ngf, 2 * ngf, "down", 4),
                 res(2 * ngf, 2 * ngf, None, 4)],
            ]
            self.refines = [
                RefineBlock([2 * ngf], 2 * ngf, nc, self.act, start=True),
                RefineBlock([2 * ngf, 2 * ngf], 2 * ngf, nc, self.act),
                RefineBlock([2 * ngf, 2 * ngf], ngf, nc, self.act),
                RefineBlock([ngf, ngf], ngf, nc, self.act, end=True),
            ]
        else:
            # RefineNetDilatedDeeper (score_network_v2.py:286-371): a 5th
            # cascade at 4*ngf and five refine blocks.
            self.res_stacks = [
                [res(ngf, ngf), res(ngf, ngf)],
                [res(ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 4 * ngf, "down", 2),
                 res(4 * ngf, 4 * ngf, None, 2)],
                [res(4 * ngf, 4 * ngf, "down", 4),
                 res(4 * ngf, 4 * ngf, None, 4)],
            ]
            self.refines = [
                RefineBlock([4 * ngf], 4 * ngf, nc, self.act, start=True),
                RefineBlock([4 * ngf, 4 * ngf], 2 * ngf, nc, self.act),
                RefineBlock([2 * ngf, 2 * ngf], 2 * ngf, nc, self.act),
                RefineBlock([2 * ngf, 2 * ngf], ngf, nc, self.act),
                RefineBlock([ngf, ngf], ngf, nc, self.act, end=True),
            ]
        self.normalizer = make_normalizer(ngf, nc)

    def init_params(self, key) -> dict:
        n_res = sum(len(s) for s in self.res_stacks)
        keys = jax.random.split(key, 3 + n_res + len(self.refines) + 1)
        C = self.data_shape[-1]
        p = {
            "begin_conv": nn.conv2d_init(keys[0], C, self.ngf, 3),
            "end_conv": nn.conv2d_init(keys[1], self.ngf, C, 3),
            "normalizer": self.normalizer.init_params(keys[2]),
        }
        ki = 3
        for si, stack in enumerate(self.res_stacks):
            for bi, block in enumerate(stack):
                p[f"res{si+1}_{bi+1}"] = block.init_params(keys[ki])
                ki += 1
        for ri, refine in enumerate(self.refines):
            p[f"refine{ri+1}"] = refine.init_params(keys[ki])
            ki += 1
        return p

    def apply(self, params: dict, x: Array, sigma_idx: Array) -> Array:
        y = sigma_idx
        in_dtype = x.dtype
        if self.num_classes is not None and not self.logit_transform:
            x = 2.0 * x - 1.0
        if self.compute_dtype is not None:
            x = x.astype(self.compute_dtype)

        h = nn.conv2d(params["begin_conv"], x)

        layers = []
        for si, stack in enumerate(self.res_stacks):
            for bi, block in enumerate(stack):
                h = block.apply(params[f"res{si+1}_{bi+1}"], h, y)
            layers.append(h)

        ref = self.refines[0].apply(params["refine1"], [layers[-1]],
                                    layers[-1].shape[1:3], y)
        for i in range(1, len(self.refines)):
            skip = layers[-1 - i]
            ref = self.refines[i].apply(params[f"refine{i+1}"],
                                        [skip, ref], skip.shape[1:3], y)

        out = self.normalizer.apply(params["normalizer"], ref, y)
        out = self.act(out)
        out = nn.conv2d(params["end_conv"], out)

        out = out.astype(in_dtype)
        if self.sigmas is not None:
            used = self.sigmas[y].astype(out.dtype)
            out = out / used[:, None, None, None]
        return out

    # convenience: number of parameters
    def count_params(self, params) -> int:
        return sum(int(np.prod(v.shape))
                   for v in jax.tree_util.tree_leaves(params))


def get_score_model(version: str, data_shape, n_filters: int,
                    num_classes: int, sigmas=None,
                    logit_transform: bool = False,
                    deeper: bool = False,
                    compute_dtype=None) -> RefineNetDilated:
    """Factory mirroring ncsn/utils.py:41-64: v1 takes the class count,
    v2 takes the sigma schedule."""
    if version == "v1":
        return RefineNetDilated(data_shape, n_filters,
                                num_classes=num_classes,
                                logit_transform=logit_transform,
                                compute_dtype=compute_dtype)
    elif version == "v2":
        return RefineNetDilated(data_shape, n_filters, sigmas=sigmas,
                                logit_transform=logit_transform,
                                deeper=deeper, compute_dtype=compute_dtype)
    raise ValueError("version should be 'v1' or 'v2'")
