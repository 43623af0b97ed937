"""Structural features: g(r), S(q), density (counterpart of
``neuralmelting_tpu.features.rdf``; plain torch — XLA code in JAX, not a
kernel).

The histogram bins each minimum-image pair distance with
``torch.bucketize`` and counts with an integer ``bincount``, and gives
the JAX package's per-bin integer counts as XLA computes them on the CPU.
XLA contracts the JAX minimum image ``d - L * round(d / L)`` into
fma(-L, round(d / L), d) and r^2 into fma(dz, dz, fma(dx, dx, dy * dy))
(found by comparing counts on frames with pairs within an f32 ulp of the
bin edges). ``_r2_fma`` emulates both in f64 for every pair: a product
of two f32 values is exact there, and one rounding to f32 follows the
add (a double rounding differs from the fused result with probability
about 2^-29). On a CUDA tensor the pass from coordinates to bin indices
(``_bin_block``) runs as one fused kernel through ``torch.compile``, so
the f64 steps cost no memory traffic; on the CPU it runs eagerly.
"""

from __future__ import annotations

import math

import torch


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


def _r2_fma(raw, lengths):
    """r^2 as XLA on the CPU computes the JAX package's, from the raw
    coordinate differences ``raw`` (3 tensors) and the box lengths
    ``lengths`` (3 tensors broadcasting against them): each fused
    multiply-add as an f64 product and add, rounded once to f32. Every
    product is one of f32 values taken in f64, so exact, and every f32
    rounding is an explicit cast: a compiler that contracts a multiply
    and an add into one fma gives the same bits. The f32 quotient d / L
    is taken as the f64 one rounded to f32, which is the correctly
    rounded f32 quotient (53 >= 2 * 24 + 2 bits), whatever division a
    compiler would pick for f32."""
    d = []
    for c, length in zip(raw, lengths):
        c64, l64 = c.double(), length.double()
        q = torch.round((c64 / l64).float()).double()
        d.append((c64 - l64 * q).float().double())
    x, y, z = d
    inner = (x * x + (y * y).float().double()).float().double()
    return (z * z + inner).float()


def _bin_block(rows, pos, box, edges2):
    """Bucket of every pair of rows (F, rb, 3) against pos (F, N, 3) in
    boxes (F, 3), offset by the frame: (F, rb, N) int32 holding
    b + f * (nbins + 1), where bin b holds edges2[b-1] <= r2 < edges2[b]
    and b = nbins lies beyond. A pair of an atom with itself has r2 = 0:
    bin 0."""
    raw = [rows[:, :, None, a] - pos[:, None, :, a] for a in range(3)]
    r2 = _r2_fma(raw, [box[:, a, None, None] for a in range(3)])
    idx = torch.bucketize(r2, edges2, out_int32=True, right=True)
    frame = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return idx + frame[:, None, None] * (edges2.shape[0] + 1)


_COMPILED = []


def _bin_block_compiled():
    # without the pattern matcher: one of its graph passes folds an
    # f64 -> f32 -> f64 cast chain into one cast, which drops the f32
    # roundings that _r2_fma spells as casts; one kernel compiles in this
    # process, with no pool of compile workers
    if not _COMPILED:
        _COMPILED.append(torch.compile(
            _bin_block, dynamic=True, fullgraph=True,
            options={"pattern_matcher": False, "compile_threads": 1}))
    return _COMPILED[0]


def _pair_counts(pos, box, nbins: int, rmax: float, max_elems: int,
                 compiled: bool = True):
    """Unordered pair counts per bin, pos (F, N, 3), box (F, 3) ->
    (F, nbins) float (exact integers). A CUDA tensor takes ``_bin_block``
    through ``torch.compile`` unless ``compiled`` is false (its eager
    reference; the same counts)."""
    f, n, _ = pos.shape
    dev = pos.device
    edges2 = _edges2(nbins, rmax, dev)
    bins = _bin_block
    if compiled and pos.is_cuda:
        # the compiled pass is specialised to inputs that start their
        # own storage: a view into a larger batch would compile it again
        bins = _bin_block_compiled()
        pos, box = pos.clone(), box.clone()
    counts = torch.zeros(f * (nbins + 1), dtype=torch.int64, device=dev)
    rb = max(1, min(n, max_elems // max(f * n, 1)))
    for start in range(0, n, rb):
        idx = bins(pos[:, start:start + rb].clone(), pos, box, edges2)
        counts += torch.bincount(idx.reshape(-1), minlength=f * (nbins + 1))
    counts = counts.view(f, nbins + 1)[:, :nbins]
    counts[:, 0] -= n                      # each atom paired with itself
    return counts.to(torch.float32) * 0.5


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
