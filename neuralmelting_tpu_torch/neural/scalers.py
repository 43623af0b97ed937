"""Feature scalers (counterpart of ``neuralmelting_tpu.neural.scalers``):
sklearn-style fit / transform / fit_transform on tensors. The tanh scaler
is the reference's TanhScaler: 0.5 * (tanh(k * (x - mu) / sigma) + 1)."""

from __future__ import annotations

import torch


class _Scaler:
    def fit_transform(self, x):
        self.fit(x)
        return self.transform(x)


class MinMaxScaler(_Scaler):
    def fit(self, x):
        self.lo = torch.min(x, dim=0).values
        self.hi = torch.max(x, dim=0).values
        return self

    def transform(self, x):
        return (x - self.lo) / torch.clamp(self.hi - self.lo, min=1e-12)


class StandardScaler(_Scaler):
    def fit(self, x):
        self.mu = torch.mean(x, dim=0)
        self.sigma = torch.clamp(torch.std(x, dim=0, correction=0),
                                 min=1e-12)
        return self

    def transform(self, x):
        return (x - self.mu) / self.sigma


class RobustScaler(_Scaler):
    def fit(self, x):
        q = torch.tensor([0.25, 0.5, 0.75], dtype=x.dtype, device=x.device)
        q25, q50, q75 = torch.quantile(x, q, dim=0)
        self.med = q50
        self.iqr = torch.clamp(q75 - q25, min=1e-12)
        return self

    def transform(self, x):
        return (x - self.med) / self.iqr


class TanhScaler(_Scaler):
    """0.5*(tanh(k*(x-mu)/sigma)+1): bounded, outlier-insensitive."""

    def __init__(self, k: float = 0.01):
        self.k = k

    def fit(self, x):
        self.mu = torch.mean(x, dim=0)
        self.sigma = torch.clamp(torch.std(x, dim=0, correction=0),
                                 min=1e-12)
        return self

    def transform(self, x):
        return 0.5 * (torch.tanh(self.k * (x - self.mu) / self.sigma) + 1.0)


_SCALERS = {
    "minmax": MinMaxScaler,
    "standard": StandardScaler,
    "robust": RobustScaler,
    "tanh": TanhScaler,
}


def get_scaler(name: str):
    try:
        return _SCALERS[name]()
    except KeyError:
        raise ValueError(f"unknown scaler {name!r}; choose from {sorted(_SCALERS)}")
