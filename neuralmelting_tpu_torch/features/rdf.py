"""Structural features: g(r), S(q), density (counterpart of
``neuralmelting_tpu.features.rdf``; plain torch — XLA code in JAX, not a
kernel).

The histogram bins each minimum-image pair distance with
``torch.bucketize`` and counts with an integer ``bincount``: the same
per-bin integer counts as the JAX cumulative-edge form, because r^2 and
the f32 bin edges are computed in the same order and the minimum image
rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import math

import torch


def _mi(d, length):
    """Minimum image, one component (round half to even)."""
    return d - length * torch.round(d / length)


def _edges2(nbins: int, rmax: float, device):
    dr = rmax / nbins
    e = (torch.arange(nbins, dtype=torch.float32, device=device) + 1.0) * dr
    return e * e


def _shell_norm(counts, n, box, nbins, rmax):
    """g = counts / ideal-gas unordered pair count per shell."""
    dr = rmax / nbins
    vol = box[..., 0] * box[..., 1] * box[..., 2]
    rho = n / vol
    edges = torch.arange(nbins + 1, dtype=torch.float32,
                         device=counts.device) * dr
    shell = (4.0 / 3.0) * math.pi * (edges[1:] * (edges[1:] * edges[1:])
                                     - edges[:-1] * (edges[:-1] * edges[:-1]))
    ideal = 0.5 * n * rho[..., None] * shell
    return counts / torch.clamp(ideal, min=1e-30)


def _pair_counts(pos, box, nbins: int, rmax: float, max_elems: int):
    """Unordered pair counts per bin, pos (F, N, 3), box (F, 3) ->
    (F, nbins) float (exact integers)."""
    f, n, _ = pos.shape
    dev = pos.device
    edges2 = _edges2(nbins, rmax, dev)
    counts = torch.zeros((f, nbins + 1), dtype=torch.int64, device=dev)
    rb = max(1, min(n, max_elems // max(f * n, 1)))
    fidx = torch.arange(f, device=dev)[:, None, None] * (nbins + 1)
    for start in range(0, n, rb):
        stop = min(n, start + rb)
        d = [_mi(pos[:, start:stop, None, a] - pos[:, None, :, a],
                 box[:, a, None, None]) for a in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]      # (F, rb, N)
        rows = torch.arange(start, stop, device=dev)[:, None]
        r2 = torch.where(rows == torch.arange(n, device=dev)[None, :],
                         1e30, r2)
        # bin b holds edges2[b-1] <= r2 < edges2[b]; index nbins: beyond
        idx = torch.bucketize(r2, edges2, right=True)
        counts += torch.bincount((idx + fidx).reshape(-1),
                                 minlength=f * (nbins + 1)).view(f, -1)
    return counts[:, :nbins].to(torch.float32) * 0.5


def rdf_hist(pos, box, nbins: int, rmax: float, max_elems: int = 1 << 24):
    """Radial distribution g(r) for one frame: (g, counts), both (nbins,);
    counts are raw unordered pair counts. Valid for rmax <= min(box)/2."""
    counts = _pair_counts(pos[None], box[None], nbins, rmax, max_elems)[0]
    return _shell_norm(counts, pos.shape[0], box, nbins, rmax), counts


def rdf_frames(positions, boxes, nbins: int, rmax: float,
               frame_batch: int = 16, max_elems: int = 1 << 25):
    """g(r) stacked over frames: positions (F, N, 3), boxes (F, 3) ->
    (F, nbins), in batches of ``frame_batch`` frames."""
    n = positions.shape[1]
    out = []
    for s in range(0, positions.shape[0], frame_batch):
        p, b = positions[s:s + frame_batch], boxes[s:s + frame_batch]
        counts = _pair_counts(p, b, nbins, rmax, max_elems)
        out.append(_shell_norm(counts, n, b, nbins, rmax))
    return torch.cat(out)


def structure_factor(g, box, natoms, rmax: float, nq: int = 0,
                     qmax: float = 0.0):
    """S(q) = 1 + 4 pi rho int r^2 (g - 1) sinc(q r) dr.

    g (..., nbins); box (..., 3). Returns (q (nq,), S (..., nq))."""
    nbins = g.shape[-1]
    dr = rmax / nbins
    dev = g.device
    r = (torch.arange(nbins, dtype=torch.float32, device=dev) + 0.5) * dr
    vol = (box[..., 0] * box[..., 1] * box[..., 2])[..., None]
    rho = natoms / vol
    if nq <= 0:
        nq = nbins // 2
    if qmax <= 0.0:
        qmax = math.pi / dr * 0.5
    q = torch.linspace(2.0 * math.pi / rmax, qmax, nq, dtype=torch.float32,
                       device=dev)
    qr = q[None, :] * r[:, None]                       # (nbins, nq)
    sinc = torch.sin(qr) / qr
    integrand = (g - 1.0)[..., :, None] * (r * r)[:, None] * sinc
    s = 1.0 + 4.0 * math.pi * rho * dr * torch.sum(integrand, dim=-2)
    return q, s


def density(boxes, natoms):
    """Number density per frame: boxes (..., 3) -> (...)."""
    return natoms / (boxes[..., 0] * boxes[..., 1] * boxes[..., 2])
