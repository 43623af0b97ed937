"""Classifier training with extreme-temperature labels (counterpart of
``neuralmelting_tpu.neural.train``).

Per pressure the lowest-temperature band is labelled solid (0) and the
highest liquid (1); the classifier trains full-batch on those bands with
AdamW (the same decoupled weight decay as optax.adamw) and predicts
P(liquid) for every sample. On CUDA it runs in full f32: cuDNN's TF32
convolutions and TF32 matmuls are switched off for the call.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class TrainResult:
    params: dict             # state dict of the trained model
    losses: torch.Tensor     # (epochs,) loss before each update
    probs: torch.Tensor      # P(liquid) for ALL samples


@contextlib.contextmanager
def full_f32():
    """No TF32 in cuDNN convolutions or matmuls inside the block."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    mm_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(mm_precision)


def extreme_t_labels(ntemp: int, band: int, device="cpu"):
    """Per-pressure template: (train_mask (ntemp,) bool, labels (ntemp,)
    f32) with the first ``band`` slots 0 and the last ``band`` 1."""
    idx = torch.arange(ntemp, device=device)
    train_mask = (idx < band) | (idx >= ntemp - band)
    labels = (idx >= ntemp - band).to(torch.float32)
    return train_mask, labels


def train_classifier(model, features, train_mask, labels,
                     epochs: int = 300, lr: float = 1e-3,
                     weight_decay: float = 1e-4) -> TrainResult:
    """Train ``model`` from its current parameters on the masked samples
    (full batch, one AdamW step per epoch) and predict on all.

    features (nsamples, nbins); train_mask (nsamples,) bool; labels
    (nsamples,) 0/1 (only masked entries count)."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    w = train_mask.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)
    losses = []
    with full_f32():
        for _ in range(epochs):
            opt.zero_grad()
            logits = model(features)
            per = torch.nn.functional.binary_cross_entropy_with_logits(
                logits, labels, reduction="none")
            loss = torch.sum(per * w) / wsum
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            probs = torch.sigmoid(model(features))
    return TrainResult(params=model.state_dict(), losses=torch.stack(losses),
                       probs=probs)
