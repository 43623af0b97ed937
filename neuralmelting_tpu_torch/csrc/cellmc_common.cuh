// Slab geometry of the LJ cell-MC kernels (stride-2 checkerboard), and the
// per-cell counts and bounding boxes and the candidate walk that the total
// kernels B1 and B4 share.
//
// A replica's slab is C*K rows per coordinate: C cells in colour-major
// order (8 colours x the (hx, hy, hz) within-colour grid), K slots per
// cell, empty slots parked at 1e30. A neighbour cell's rows are found from
// full-cell coordinates directly: (c + d) mod ncell on each axis, mapped to
// the colour-major cell index, and the coordinate of an axis that wrapped
// is read at its periodic image (+-L). See ops/cellmc_geom.py.
#pragma once

#include <cuda_runtime.h>

namespace nm {

constexpr float kInvalid = 1.0e30f;
constexpr float kValidBelow = 1.0e29f;  // 0.1 * kInvalid

struct Geo {
  int n[3];     // cells per axis, each even
  int h[3];     // within-colour grid, n / 2
  int cw;       // cells per colour
  int C;        // cells
  int K;        // slots per cell
  int rows;     // C * K
};

inline Geo make_geo(int nx, int ny, int nz, int k) {
  Geo g;
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  for (int a = 0; a < 3; ++a) g.h[a] = g.n[a] / 2;
  g.C = nx * ny * nz;
  g.cw = g.C / 8;
  g.K = k;
  g.rows = g.C * k;
  return g;
}

// Colour-major slab cell index of full-cell coordinates (in range).
__device__ __forceinline__ int slab_cell(const Geo& g, const int* c) {
  const int color = ((c[0] & 1) * 2 + (c[1] & 1)) * 2 + (c[2] & 1);
  const int w = ((c[0] >> 1) * g.h[1] + (c[1] >> 1)) * g.h[2] + (c[2] >> 1);
  return color * g.cw + w;
}

// Full-cell coordinates of slab cell `cell`.
__device__ __forceinline__ void cell_coords(const Geo& g, int cell, int* c) {
  const int color = cell / g.cw;
  const int w = cell - color * g.cw;
  c[0] = 2 * (w / (g.h[1] * g.h[2])) + (color >> 2);
  c[1] = 2 * ((w / g.h[2]) % g.h[1]) + ((color >> 1) & 1);
  c[2] = 2 * (w % g.h[2]) + (color & 1);
}

// Neighbour of full cell `c` at offset `d`: its slab row base, and the
// periodic image shift of each coordinate (0 or +-L).
__device__ __forceinline__ int neighbor(const Geo& g, const int* c,
                                        const int* d, const float* L,
                                        float* sh) {
  int nb[3];
  for (int a = 0; a < 3; ++a) {
    nb[a] = c[a] + d[a];
    sh[a] = 0.0f;
    if (nb[a] >= g.n[a]) {
      nb[a] -= g.n[a];
      sh[a] = L[a];
    } else if (nb[a] < 0) {
      nb[a] += g.n[a];
      sh[a] = -L[a];
    }
  }
  return slab_cell(g, nb) * g.K;
}

// Per cell of a replica's slabs (C cells of K slots, occupied slots packed
// below the count): scnt[c] = the count, the popcount of a ballot of
// x < kValidBelow per 32 slots, and sbox[6 c ..] = the least x, y, z and
// the greatest x, y, z of its atoms (the largest float and its negative
// for an empty cell). Warp `warp` of `nwarps` takes cells warp, warp +
// nwarps, ...
__device__ __forceinline__ void counts_and_boxes(const float* x,
                                                 const float* y,
                                                 const float* z, int C,
                                                 int K, int warp, int nwarps,
                                                 int* scnt, float* sbox) {
  const int lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += nwarps) {
    int n = 0;
    float lo[3] = {3.402823466e38f, 3.402823466e38f, 3.402823466e38f};
    float hi[3] = {-3.402823466e38f, -3.402823466e38f, -3.402823466e38f};
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool occ = k < K && x[c * K + k] < kValidBelow;
      n += __popc(__ballot_sync(0xffffffffu, occ));
      if (occ) {
        const float v[3] = {x[c * K + k], y[c * K + k], z[c * K + k]};
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], v[a]);
          hi[a] = fmaxf(hi[a], v[a]);
        }
      }
    }
    for (int a = 0; a < 3; ++a)
      for (int off = 16; off > 0; off >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
      }
    if (lane == 0) {
      scnt[c] = n;
      for (int a = 0; a < 3; ++a) {
        sbox[6 * c + a] = lo[a];
        sbox[6 * c + 3 + a] = hi[a];
      }
    }
  }
}

// Squared distance from m to the box b = [least x, y, z, greatest x, y,
// z] (a cell's box plus an image shift, each coordinate added in f32 as a
// pair's candidate is). Each axis gap is formed with a pair's own f32
// operations, (c + h) - m, which are monotone, so the result is <= the
// r^2 the kernels compute for m and any atom of the cell: a cell whose
// gap is >= a cutoff holds no pair inside it, exactly.
__device__ __forceinline__ float box_gap2(const float* b, const float* m) {
  float g[3];
  for (int a = 0; a < 3; ++a)
    g[a] = fmaxf(fmaxf(b[a] - m[a], m[a] - b[3 + a]), 0.f);
  return g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
}

// One mover's candidate walk over a stencil of NOFF (<= 32) cells, the
// loop that B1 and B4 share. Lane o < NOFF brings stencil cell o: `first`,
// the row of its first candidate, and `n`, its number of candidates (0 on
// the other lanes and for a cell that is skipped); sh[3 o ..] holds the
// cell's image shift. A warp prefix over the n flattens the candidates
// into one list: candidate t is row beg[o] + t of the stencil cell o with
// end[o-1] <= t < end[o] (beg and end: NOFF words each of the warp's
// shared memory). The lanes take the candidates 32 at a time and compute
// r^2 = |(p_row + shift) - mp|^2 only; keep(row, r2) says whether a pair
// is listed, and __ballot_sync and __popc prefixes give each listed pair
// its position `at` after the nlist entries the list holds, where
// put(at, row, r2) writes it. flush(32) runs whenever the list holds 32
// or more and must take 32 off it: one step appends at most 32, so a
// list of 64 entries never overflows.
template <int NOFF, class Keep, class Put, class Flush>
__device__ __forceinline__ void walk_candidates(
    const float* x, const float* y, const float* z, const float* mp,
    int first, int n, int* beg, int* end, const float* sh, int& nlist,
    Keep&& keep, Put&& put, Flush&& flush) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float mx = mp[0], my = mp[1], mz = mp[2];
  int incl = n;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  __syncwarp();  // the previous walk has read the tables
  if (lane < NOFF) {
    end[lane] = incl;
    beg[lane] = first - (incl - n);
  }
  const int ncand = __shfl_sync(kAll, incl, NOFF - 1);
  __syncwarp();
  int o = 0, tend = end[0], rb = beg[0];
  float h0 = sh[0], h1 = sh[1], h2 = sh[2];
  for (int t0 = 0; t0 < ncand; t0 += 32) {
    const int t = t0 + lane;
    bool in = false;
    int row = 0;
    float r2 = 0.f;
    if (t < ncand) {
      while (t >= tend) {
        ++o;
        tend = end[o];
        rb = beg[o];
        h0 = sh[3 * o];
        h1 = sh[3 * o + 1];
        h2 = sh[3 * o + 2];
      }
      row = rb + t;
      const float d0 = (x[row] + h0) - mx;
      const float d1 = (y[row] + h1) - my;
      const float d2 = (z[row] + h2) - mz;
      r2 = d0 * d0 + d1 * d1 + d2 * d2;
      in = keep(row, r2);
    }
    const unsigned ball = __ballot_sync(kAll, in);
    if (in) put(nlist + __popc(ball & below), row, r2);
    nlist += __popc(ball);
    __syncwarp();
    if (nlist >= 32) flush(32);
  }
}

}  // namespace nm
