// Slab geometry shared by the cell-MC kernels (stride-2 checkerboard).
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

}  // namespace nm
