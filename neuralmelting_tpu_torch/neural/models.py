"""Solid/liquid phase classifiers (counterpart of
``neuralmelting_tpu.neural.models``): a 1-D CNN and an MLP over g(r) bins,
each emitting one logit.

torch needs the input width up front (flax infers it), so both take
``nbins``. ``PhaseCNN`` flattens its last feature map in (width, channel)
order, as the flax model's NWC layout does, so weights converted by
``classifier_params_from_flax`` line up with the first dense layer.
Parameters start from ``init_params``: flax's defaults (LeCun-normal
kernels, truncated at 2 sigma; zero biases), drawn from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


class PhaseCNN(nn.Module):
    """1-D CNN: [conv(k, SAME) -> relu -> maxpool 2] per feature width,
    then dense -> relu -> dense(1)."""

    def __init__(self, nbins: int, features: Sequence[int] = (32, 64),
                 kernel: int = 5, dense: int = 64):
        super().__init__()
        chans = [1] + list(features)
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, cout, kernel, padding="same")
            for cin, cout in zip(chans[:-1], chans[1:]))
        width = nbins
        for _ in features:
            width //= 2
        self.denses = nn.ModuleList([nn.Linear(width * chans[-1], dense),
                                     nn.Linear(dense, 1)])

    def forward(self, x):
        h = x[:, None, :]                              # (B, 1, nbins)
        for conv in self.convs:
            h = nn.functional.max_pool1d(torch.relu(conv(h)), 2)
        h = h.permute(0, 2, 1).reshape(h.shape[0], -1)  # NWC flatten
        h = torch.relu(self.denses[0](h))
        return self.denses[1](h)[..., 0]


class PhaseMLP(nn.Module):
    def __init__(self, nbins: int, widths: Sequence[int] = (128, 64)):
        super().__init__()
        dims = [nbins] + list(widths) + [1]
        self.convs = nn.ModuleList()
        self.denses = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        h = x
        for layer in self.denses[:-1]:
            h = torch.relu(layer(h))
        return self.denses[-1](h)[..., 0]


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator):
    """flax defaults: kernels LeCun normal (variance 1/fan_in, truncated
    at +-2 std), biases zero."""
    for layer in list(model.convs) + list(model.denses):
        w = layer.weight
        fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
        # std of the untruncated normal whose +-2 sigma truncation has
        # variance 1/fan_in (flax's variance_scaling constant)
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w.copy_(nn.init.trunc_normal_(torch.empty_like(w, device="cpu"),
                                      std=std, a=-2.0 * std, b=2.0 * std,
                                      generator=generator))
        layer.bias.zero_()
    return model


def classifier_params_from_flax(params) -> dict:
    """flax params of PhaseCNN / PhaseMLP (numpy arrays, optionally under
    a "params" key) -> a torch state dict for the port's model.

    Conv kernels (k, in, out) become (out, in, k); Dense kernels
    (in, out) become Linear weights (out, in)."""
    p = params.get("params", params)
    sd = {}
    for i in range(len([k for k in p if k.startswith("Conv_")])):
        c = p[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = torch.as_tensor(
            np.transpose(np.asarray(c["kernel"]), (2, 1, 0)).copy())
        sd[f"convs.{i}.bias"] = torch.as_tensor(np.array(c["bias"]))
    for i in range(len([k for k in p if k.startswith("Dense_")])):
        d = p[f"Dense_{i}"]
        sd[f"denses.{i}.weight"] = torch.as_tensor(
            np.asarray(d["kernel"]).T.copy())
        sd[f"denses.{i}.bias"] = torch.as_tensor(np.array(d["bias"]))
    return sd
