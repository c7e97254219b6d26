// Kernel A: one Maxwell half-update of the 2D Yee grid, E or B, with the
// CPML psi recursion fused into the same pass.
//
// Replaces: epoch_tpu/ops/field_kernels.py::make_field_half_kernel (the
// Pallas kernel, pallas_call at field_kernels.py:138), whose math is
// epoch_tpu/core/fields.py::update_e_field / update_b_field.  The plain
// PyTorch version is epoch_tpu_torch/core/fields.py (same names).
//
// What it computes, per cell of the padded grid (n + 2*ng per axis):
//   E half: E += c^2 dt/2 curl B * (1/kappa) - dt/2/eps0 J   (update region)
//           psi_E = b_E psi_E + c_E dB ;  E += s c^2 dt/2 psi_E  (everywhere)
//   B half: B -= dt/2 curl E * (1/kappa)                     (update region)
//           psi_B = b_B psi_B + c_B dE ;  B -= s dt/2 psi_B     (everywhere)
// The update region is the Fortran [0, n] range, [ng-1, n+ng-1] here.
// Neighbour indices wrap around the padded array exactly as the
// reference's jnp.roll does.
//
// What bounds it on the H100: bytes.  Per cell the E half reads 13 f32
// planes (E, B, J, 4 psi) and writes 7 (E, 4 psi); the B half reads 10 and
// writes 7.  At 2-6 flops per byte it sits far below the card's
// flops:bytes ratio, so the least time is the planes over 3.35 TB/s.
//
// What the design does about it: one thread per cell, neighbouring threads
// on neighbouring addresses of the contiguous y axis, every input read
// once from DRAM (stencil neighbours come from L1/L2), every output
// written once, the psi update in the same pass as the field update so the
// psi planes make one round trip.  No shared-memory tiling yet: the stencil
// reach is one cell and the L1 catches the reuse.
//
// Numerics: the file is built with -fmad=false, so every product and sum
// rounds as the plain PyTorch version's elementwise operations do, in the
// same order; the kernel then matches the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

template <int ORDER> struct Stencil;
template <> struct Stencil<2> {
  static constexpr int K = 1;
  __device__ static float c(int) { return 1.0f; }
};
template <> struct Stencil<4> {
  static constexpr int K = 2;
  __device__ static float c(int k) {
    return k == 0 ? (float)(9.0 / 8.0) : (float)(-1.0 / 24.0);
  }
};
template <> struct Stencil<6> {
  static constexpr int K = 3;
  __device__ static float c(int k) {
    return k == 0 ? (float)(75.0 / 64.0)
                  : (k == 1 ? (float)(-25.0 / 384.0) : (float)(3.0 / 640.0));
  }
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

struct Grid2 {
  int n0, n1;             // padded extents
  int lo0, hi0, lo1, hi1; // update region, inclusive
};

// f(i + k) along axis 0 or 1 of a row-major (n0, n1) plane
__device__ __forceinline__ float at(const float* f, const Grid2& g, int i,
                                    int j, int axis, int k) {
  return axis == 0 ? f[wrap(i + k, g.n0) * g.n1 + j]
                   : f[i * g.n1 + wrap(j + k, g.n1)];
}

// backward-staggered derivative sum_k c_k (f(i+k-1) - f(i-k))
template <int ORDER>
__device__ __forceinline__ float d_minus(const float* f, const Grid2& g,
                                         int i, int j, int axis) {
  float out = 0.0f;
#pragma unroll
  for (int k = 1; k <= Stencil<ORDER>::K; ++k) {
    float t = Stencil<ORDER>::c(k - 1) *
              (at(f, g, i, j, axis, k - 1) - at(f, g, i, j, axis, -k));
    out = (k == 1) ? t : out + t;
  }
  return out;
}

// forward-staggered derivative sum_k c_k (f(i+k) - f(i-k+1))
template <int ORDER>
__device__ __forceinline__ float d_plus(const float* f, const Grid2& g,
                                        int i, int j, int axis) {
  float out = 0.0f;
#pragma unroll
  for (int k = 1; k <= Stencil<ORDER>::K; ++k) {
    float t = Stencil<ORDER>::c(k - 1) *
              (at(f, g, i, j, axis, k) - at(f, g, i, j, axis, 1 - k));
    out = (k == 1) ? t : out + t;
  }
  return out;
}

struct EArgs {
  const float *ex, *ey, *ez, *bx, *by, *bz, *jx, *jy, *jz, *psi;
  float *ex_o, *ey_o, *ez_o, *psi_o;
  // per-axis profiles: 1/kappa, psi decay b, psi gain c (length n0 / n1)
  const float *ik0, *ik1, *pb0, *pb1, *pc0, *pc1;
  float mfac;   // -dt/2/eps0
  float cn0, cn1;
  float facc;   // dt/2 c^2
};

struct BArgs {
  const float *ex, *ey, *ez, *bx, *by, *bz, *psi;
  float *bx_o, *by_o, *bz_o, *psi_o;
  const float *ik0, *ik1, *pb0, *pb1, *pc0, *pc1;
  float hdtd0, hdtd1;
  float hdt;
};

// Levi-Civita pairs of the 2D curl, in the reference's order
// (fields._eps_pairs): (c, d, e, s) = (1,0,2,-1) (2,0,1,+1) (0,1,2,+1)
// (2,1,0,-1).
template <int ORDER, bool CPML>
__global__ void e_half(EArgs a, Grid2 g) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.n0 * g.n1) return;
  int i = idx / g.n1, j = idx - (idx / g.n1) * g.n1;
  float de0 = a.mfac * a.jx[idx];
  float de1 = a.mfac * a.jy[idx];
  float de2 = a.mfac * a.jz[idx];
  float t;
  t = a.cn0 * d_minus<ORDER>(a.bz, g, i, j, 0);
  if (CPML) t = t * a.ik0[i];
  de1 = de1 + (-t);
  t = a.cn0 * d_minus<ORDER>(a.by, g, i, j, 0);
  if (CPML) t = t * a.ik0[i];
  de2 = de2 + t;
  t = a.cn1 * d_minus<ORDER>(a.bz, g, i, j, 1);
  if (CPML) t = t * a.ik1[j];
  de0 = de0 + t;
  t = a.cn1 * d_minus<ORDER>(a.bx, g, i, j, 1);
  if (CPML) t = t * a.ik1[j];
  de2 = de2 + (-t);
  bool in = i >= g.lo0 && i <= g.hi0 && j >= g.lo1 && j <= g.hi1;
  float e0 = a.ex[idx], e1 = a.ey[idx], e2 = a.ez[idx];
  float n0 = in ? e0 + de0 : e0;
  float n1 = in ? e1 + de1 : e1;
  float n2 = in ? e2 + de2 : e2;
  if (CPML) {
    const int P = g.n0 * g.n1;
    float dp, psi;
    dp = a.bz[idx] - at(a.bz, g, i, j, 0, -1);
    psi = a.pb0[i] * a.psi[idx] + a.pc0[i] * dp;
    n1 = n1 + (-a.facc) * psi;
    a.psi_o[idx] = psi;
    dp = a.by[idx] - at(a.by, g, i, j, 0, -1);
    psi = a.pb0[i] * a.psi[P + idx] + a.pc0[i] * dp;
    n2 = n2 + a.facc * psi;
    a.psi_o[P + idx] = psi;
    dp = a.bz[idx] - at(a.bz, g, i, j, 1, -1);
    psi = a.pb1[j] * a.psi[2 * P + idx] + a.pc1[j] * dp;
    n0 = n0 + a.facc * psi;
    a.psi_o[2 * P + idx] = psi;
    dp = a.bx[idx] - at(a.bx, g, i, j, 1, -1);
    psi = a.pb1[j] * a.psi[3 * P + idx] + a.pc1[j] * dp;
    n2 = n2 + (-a.facc) * psi;
    a.psi_o[3 * P + idx] = psi;
  }
  a.ex_o[idx] = n0;
  a.ey_o[idx] = n1;
  a.ez_o[idx] = n2;
}

template <int ORDER, bool CPML>
__global__ void b_half(BArgs a, Grid2 g) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.n0 * g.n1) return;
  int i = idx / g.n1, j = idx - (idx / g.n1) * g.n1;
  float db0 = 0.0f, db1 = 0.0f, db2 = 0.0f;
  float t;
  t = a.hdtd0 * d_plus<ORDER>(a.ez, g, i, j, 0);
  if (CPML) t = t * a.ik0[i];
  db1 = db1 - (-t);
  t = a.hdtd0 * d_plus<ORDER>(a.ey, g, i, j, 0);
  if (CPML) t = t * a.ik0[i];
  db2 = db2 - t;
  t = a.hdtd1 * d_plus<ORDER>(a.ez, g, i, j, 1);
  if (CPML) t = t * a.ik1[j];
  db0 = db0 - t;
  t = a.hdtd1 * d_plus<ORDER>(a.ex, g, i, j, 1);
  if (CPML) t = t * a.ik1[j];
  db2 = db2 - (-t);
  bool in = i >= g.lo0 && i <= g.hi0 && j >= g.lo1 && j <= g.hi1;
  float b0 = a.bx[idx], b1 = a.by[idx], b2 = a.bz[idx];
  float n0 = in ? b0 + db0 : b0;
  float n1 = in ? b1 + db1 : b1;
  float n2 = in ? b2 + db2 : b2;
  if (CPML) {
    const int P = g.n0 * g.n1;
    float dp, psi;
    dp = at(a.ez, g, i, j, 0, 1) - a.ez[idx];
    psi = a.pb0[i] * a.psi[idx] + a.pc0[i] * dp;
    n1 = n1 - (-a.hdt) * psi;
    a.psi_o[idx] = psi;
    dp = at(a.ey, g, i, j, 0, 1) - a.ey[idx];
    psi = a.pb0[i] * a.psi[P + idx] + a.pc0[i] * dp;
    n2 = n2 - a.hdt * psi;
    a.psi_o[P + idx] = psi;
    dp = at(a.ez, g, i, j, 1, 1) - a.ez[idx];
    psi = a.pb1[j] * a.psi[2 * P + idx] + a.pc1[j] * dp;
    n0 = n0 - a.hdt * psi;
    a.psi_o[2 * P + idx] = psi;
    dp = at(a.ex, g, i, j, 1, 1) - a.ex[idx];
    psi = a.pb1[j] * a.psi[3 * P + idx] + a.pc1[j] * dp;
    n2 = n2 - (-a.hdt) * psi;
    a.psi_o[3 * P + idx] = psi;
  }
  a.bx_o[idx] = n0;
  a.by_o[idx] = n1;
  a.bz_o[idx] = n2;
}

template <int ORDER, bool CPML, typename Args>
void launch_e(const Args& a, const Grid2& g, cudaStream_t s) {
  int n = g.n0 * g.n1;
  e_half<ORDER, CPML><<<(n + 255) / 256, 256, 0, s>>>(a, g);
}

template <int ORDER, bool CPML, typename Args>
void launch_b(const Args& a, const Grid2& g, cudaStream_t s) {
  int n = g.n0 * g.n1;
  b_half<ORDER, CPML><<<(n + 255) / 256, 256, 0, s>>>(a, g);
}

}  // namespace

// Plain C interface (bound with ctypes).  All arrays are contiguous f32 on
// the device; ``fields`` holds the 9 (E half) or 6 (B half) input planes in
// the order ex ey ez bx by bz [jx jy jz]; ``outs`` the 3 output planes;
// ``psi``/``psi_o`` the (4, n0, n1) stacks and ``prof`` the 6 profile
// vectors (ik0 ik1 b0 b1 c0 c1), all three NULL without CPML.  ``s`` holds
// the scalars: E half (-dt/2/eps0, cn0, cn1, dt/2 c^2), B half (hdtd0,
// hdtd1, dt/2).  Returns the launch's cudaError_t.
extern "C" int field_half_f32(int which_b, int order, int cpml,
                              const float* const* fields, float* const* outs,
                              const float* psi, float* psi_o,
                              const float* const* prof, const float* s,
                              int n0, int n1, int lo0, int hi0, int lo1,
                              int hi1, void* stream) {
  Grid2 g{n0, n1, lo0, hi0, lo1, hi1};
  cudaStream_t st = (cudaStream_t)stream;
  const float* none = nullptr;
  const float* pr[6];
  for (int k = 0; k < 6; ++k) pr[k] = cpml ? prof[k] : none;
  if (order != 2 && order != 4 && order != 6) return (int)cudaErrorInvalidValue;
  if (!which_b) {
    EArgs a{fields[0], fields[1], fields[2], fields[3], fields[4], fields[5],
            fields[6], fields[7], fields[8], psi,
            outs[0], outs[1], outs[2], psi_o,
            pr[0], pr[1], pr[2], pr[3], pr[4], pr[5],
            s[0], s[1], s[2], s[3]};
    if (cpml) {
      if (order == 2) launch_e<2, true>(a, g, st);
      else if (order == 4) launch_e<4, true>(a, g, st);
      else launch_e<6, true>(a, g, st);
    } else {
      if (order == 2) launch_e<2, false>(a, g, st);
      else if (order == 4) launch_e<4, false>(a, g, st);
      else launch_e<6, false>(a, g, st);
    }
  } else {
    BArgs a{fields[0], fields[1], fields[2], fields[3], fields[4], fields[5],
            psi, outs[0], outs[1], outs[2], psi_o,
            pr[0], pr[1], pr[2], pr[3], pr[4], pr[5],
            s[0], s[1], s[2]};
    if (cpml) {
      if (order == 2) launch_b<2, true>(a, g, st);
      else if (order == 4) launch_b<4, true>(a, g, st);
      else launch_b<6, true>(a, g, st);
    } else {
      if (order == 2) launch_b<2, false>(a, g, st);
      else if (order == 4) launch_b<4, false>(a, g, st);
      else launch_b<6, false>(a, g, st);
    }
  }
  return (int)cudaGetLastError();
}
