// Slab geometry of the EAM cell-MC kernels (stride-3 checkerboard).
//
// A replica's slab is C*K rows per coordinate: C cells in colour-major
// order (27 colours x the (hx, hy, hz) within-colour grid, h = n / 3), K
// slots per cell, empty slots parked at 1e30. A neighbour cell's rows are
// found from full-cell coordinates: (c + d) mod n on each axis, mapped to
// the colour-major cell index; the coordinate of an axis that wrapped is
// read at its periodic image (+-L). See ops/cellmc_geom.py (stride 3).
#pragma once

#include <cuda_runtime.h>

namespace nm {

constexpr float kEamInvalidBelow = 1.0e29f;  // 0.1 * the parked 1e30

struct Geo3 {
  int n[3];  // cells per axis, each divisible by 3
  int h[3];  // within-colour grid, n / 3
  int cw;    // cells per colour
  int C;     // cells
  int K;     // slots per cell
  int rows;  // C * K
};

inline Geo3 make_geo3(int nx, int ny, int nz, int k) {
  Geo3 g;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  for (int a = 0; a < 3; ++a) g.h[a] = g.n[a] / 3;
  g.C = nx * ny * nz;
  g.cw = g.C / 27;
  g.K = k;
  g.rows = g.C * k;
  return g;
}

// Full-cell coordinates of slab cell `cell`.
__device__ __forceinline__ void cell_coords3(const Geo3& g, int cell,
                                             int* c) {
  const int color = cell / g.cw;
  const int w = cell - color * g.cw;
  c[0] = 3 * (w / (g.h[1] * g.h[2])) + color / 9;
  c[1] = 3 * ((w / g.h[2]) % g.h[1]) + (color / 3) % 3;
  c[2] = 3 * (w % g.h[2]) + color % 3;
}

// Neighbour of full cell `c` at offset `d`: its slab row base, and the
// periodic image shift of each coordinate (0 or +-L).
__device__ __forceinline__ int neighbor3(const Geo3& g, const int* c,
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
  const int color = ((nb[0] % 3) * 3 + nb[1] % 3) * 3 + nb[2] % 3;
  const int w = ((nb[0] / 3) * g.h[1] + nb[1] / 3) * g.h[2] + nb[2] / 3;
  return (color * g.cw + w) * g.K;
}

// Offset o of [(0,0,0)] + the 26 others in lexicographic order (the JAX
// kernels' OFF27).
__device__ __forceinline__ void offset27(int o, int* d) {
  if (o == 0) {
    d[0] = d[1] = d[2] = 0;
    return;
  }
  int q = o - 1;
  if (q >= 13) q += 1;  // skip (0,0,0), lexicographic index 13
  d[0] = q / 9 - 1;
  d[1] = (q / 3) % 3 - 1;
  d[2] = q % 3 - 1;
}

}  // namespace nm
