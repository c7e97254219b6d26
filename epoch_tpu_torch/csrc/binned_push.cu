// Kernel B: the 2D binned particle hot loop of one species — half-drift,
// per-axis rebin, field gather, Boris push, move and the PSC charge-
// conserving current deposit — on the slot grid
//     w (K, nx, ny), xi (2, K, nx, ny), p (3, K, nx, ny)   (f32, y fastest).
//
// Replaces: epoch_tpu/ops/binned_kernels.py::make_fused_push (the Pallas
// kernel, pallas_call at binned_kernels.py:1438; driver PallasBinned:1480),
// in its variant without moving window, extra payload rows, probes, QED or
// thermal walls: x open or periodic, y periodic.  The plain PyTorch version
// is epoch_tpu_torch/core/binned.py::push_deposit_plain.
//
// Three launches (fusing them is later work):
//   1. drift_xrebin  — one thread per destination cell: drifts the
//      particles of cells {c, c-1, c+1} along x (the drift is recomputed by
//      each reader), removes those leaving through an open x edge, and
//      keeps the candidates routed to c in the stable order centre, left,
//      right; the first K live ones fill the cell's slots, the rest count
//      as dropped.
//   2. yrebin_push   — one thread per destination cell: the same rebin
//      along y (periodic), then for every kept particle, in slot order,
//      the gather of the six field components from the (6, nx+4, ny+4)
//      stack, Boris, the move, the deposit of its 5x5 window of Jx, Jy, Jz
//      into the thread's registers, and the end-of-push open-x removal.
//      The thread writes its cell's 75 partial currents to a
//      (3, 25, nx, ny) buffer.
//   3. fold_currents — one thread per node of the margin-padded J
//      (3, nx+4, ny+4): sums the partials of the 25 cells whose window
//      covers it, in a fixed order.  Deterministic: no atomics, so two runs
//      give the same J bit for bit (the counterpart of the reference's
//      per-stripe partials plus fold_jpart overlap-add).
//
// What bounds it on the H100: bytes.  Per species and step the slot state
// is read once and written once: 12 f32 values per slot (w, 2 xi, 3 p in
// and out), 127 MB at K = 18 on 384 x 384 cells, about 38 us at 3.35 TB/s.
// The arithmetic (~600 flops per live particle for gather, Boris and the
// deposit) is about 1 GFLOP per species-step at 1.66 M particles,
// ~15 us at 67 TFLOP/s.
//
// What the design does about it, and what it does not yet: each thread
// owns one destination cell, so the rebin needs no atomics and no sort; the
// neighbour cells' slots come from global memory through L1/L2 (adjacent
// threads read adjacent y addresses).  Launch 1's compacted slots
// round-trip through a scratch copy of the slot state (a second 127 MB),
// and the partial currents through a 44 MB buffer; fusing the launches is
// the next step toward the bound.
//
// Numerics: built with -fmad=false so every product and sum rounds as the
// plain PyTorch version's elementwise operations do, in the same order;
// positions, momenta, weights and the dropped count then agree exactly, and
// J differs from the plain version only by the order of its sums (f32
// round-off, see ops/binned_kernels.py for the tolerance).
#include <cuda_runtime.h>

namespace {

struct Params {
  int K, nx, ny;
  int periodic_x, open_lo, open_hi;
  float ipart_mc, fx, fy;        // drift
  float cm, ccm, part_mc, c;     // Boris
  float dmx, dmy;                // dt/2 / dx, dt/2 / dy
  float fj0, fj1, fj2, q, fac, third;
};

// triangle weight at integer offset r in {-1, 0, 1} (gx.inc)
__device__ __forceinline__ float tri(float cf, int r) {
  if (r == -1) return (0.25f + cf * cf) + cf;
  if (r == 0) return 1.5f - (2.0f * cf) * cf;
  return (0.25f + cf * cf) - cf;
}

// weight at offset o of a window whose centre is the integer-valued base:
// tri(cf, o - base) inside the support, else 0
__device__ __forceinline__ float wsel(float cf, int o, int base) {
  int r = o - base;
  return (r >= -1 && r <= 1) ? tri(cf, r) : 0.0f;
}

__device__ __forceinline__ float clamp1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

// ---- launch 1: drift, open-x removal and x rebin -------------------------
__global__ void drift_xrebin(const float* __restrict__ w,
                             const float* __restrict__ xi,
                             const float* __restrict__ p, float* w1,
                             float* xi1, float* p1, int* ndrop, Params P) {
  const int C = P.nx * P.ny;
  int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= C) return;
  int ix = cell / P.ny, iy = cell - (cell / P.ny) * P.ny;
  int cnt = 0, drop = 0;
  // candidate sources in the stable order centre, left, right; a particle
  // of the left cell arrives with dc = +1, of the right cell with dc = -1
  for (int role = 0; role < 3; ++role) {
    int off = role == 0 ? 0 : (role == 1 ? -1 : 1);
    float want = (float)(-off);
    int sx = ix + off;
    if (sx < 0 || sx >= P.nx) {
      if (!P.periodic_x) continue;
      sx = sx < 0 ? sx + P.nx : sx - P.nx;
    }
    int src = sx * P.ny + iy;
    for (int k = 0; k < P.K; ++k) {
      int s = k * C + src;
      float wv = w[s];
      if (!(wv > 0.0f)) continue;
      float u0 = p[s] * P.ipart_mc;
      float u1 = p[P.K * C + s] * P.ipart_mc;
      float u2 = p[2 * P.K * C + s] * P.ipart_mc;
      float igam = 1.0f / sqrtf(((u0 * u0 + u1 * u1) + u2 * u2) + 1.0f);
      float x0 = xi[s] + (u0 * igam) * P.fx;
      float x1 = xi[P.K * C + s] + (u1 * igam) * P.fy;
      if (!P.periodic_x) {
        if (P.open_lo && sx == 0 && x0 < -0.5f) continue;
        if (P.open_hi && sx == P.nx - 1 && x0 >= 0.5f) continue;
      }
      float dc = clamp1(floorf(x0 + 0.5f));
      if (dc != want) continue;
      if (cnt < P.K) {
        int d = cnt * C + cell;
        w1[d] = wv;
        xi1[d] = x0 - dc;
        xi1[P.K * C + d] = x1;
        p1[d] = p[s];
        p1[P.K * C + d] = p[P.K * C + s];
        p1[2 * P.K * C + d] = p[2 * P.K * C + s];
        ++cnt;
      } else {
        ++drop;
      }
    }
  }
  for (int k = cnt; k < P.K; ++k) w1[k * C + cell] = 0.0f;
  if (drop) atomicAdd(ndrop, drop);
}

// the six field components at a particle at xi (x0, x1) in [-1/2, 1/2) of
// cell (ix, iy) — the reference's _gather6, in its summation order
__device__ __forceinline__ void gather6(const float* __restrict__ f,
                                        const Params& P, int ix, int iy,
                                        float x0, float x1, float out[6]) {
  const int W0 = P.nx + 4, W1 = P.ny + 4;
  float cfa[2] = {-x0, -x1};
  float c2[2] = {floorf(x0), floorf(x1)};
  float cfb[2] = {(c2[0] - x0) + 0.5f, (c2[1] - x1) + 0.5f};
  // g: unstaggered weights on offsets -1..1; h: staggered on -2..1
  float g[2][3], h[2][4];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
#pragma unroll
    for (int o = -1; o <= 1; ++o) g[d][o + 1] = tri(cfa[d], o);
#pragma unroll
    for (int o = -2; o <= 1; ++o) h[d][o + 2] = wsel(cfb[d], o, (int)c2[d]);
  }
  // stagger (x, y): ex (1,0) ey (0,1) ez (0,0) bx (0,1) by (1,0) bz (1,1)
  const int sx[6] = {1, 0, 0, 0, 1, 1};
  const int sy[6] = {0, 1, 0, 1, 0, 1};
#pragma unroll
  for (int comp = 0; comp < 6; ++comp) {
    const float* fc = f + comp * W0 * W1;
    float acc = 0.0f;
    const int nxo = sx[comp] ? 4 : 3, nyo = sy[comp] ? 4 : 3;
    const int ox0 = sx[comp] ? -2 : -1, oy0 = sy[comp] ? -2 : -1;
#pragma unroll
    for (int a = 0; a < nxo; ++a) {
      float wx = sx[comp] ? h[0][a] : g[0][a];
#pragma unroll
      for (int b = 0; b < nyo; ++b) {
        float wy = sy[comp] ? h[1][b] : g[1][b];
        float win = fc[(2 + ix + ox0 + a) * W1 + (2 + iy + oy0 + b)];
        acc = acc + (wx * wy) * win;
      }
    }
    out[comp] = P.fac * acc;
  }
}

// ---- launch 2: y rebin, push, deposit into per-cell partials ------------
__global__ void __launch_bounds__(128)
yrebin_push(const float* __restrict__ w1, const float* __restrict__ xi1,
            const float* __restrict__ p1, const float* __restrict__ fpad,
            float* w_o, float* xi_o, float* p_o, float* part, int* ndrop,
            Params P) {
  const int C = P.nx * P.ny;
  const int KC = P.K * C;
  int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= C) return;
  int ix = cell / P.ny, iy = cell - (cell / P.ny) * P.ny;
  float jx[25], jy[25], jz[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) jx[k] = jy[k] = jz[k] = 0.0f;
  int cnt = 0, drop = 0;
  for (int role = 0; role < 3; ++role) {
    int off = role == 0 ? 0 : (role == 1 ? -1 : 1);
    float want = (float)(-off);
    int sy = iy + off;
    sy = sy < 0 ? sy + P.ny : (sy >= P.ny ? sy - P.ny : sy);
    int src = ix * P.ny + sy;
    for (int k = 0; k < P.K; ++k) {
      int s = k * C + src;
      float wv = w1[s];
      if (!(wv > 0.0f)) continue;
      float y0 = xi1[KC + s];
      float dc = clamp1(floorf(y0 + 0.5f));
      if (dc != want) continue;
      if (cnt >= P.K) {
        ++drop;
        continue;
      }
      float x[2] = {xi1[s], y0 - dc};
      float pu[3] = {p1[s], p1[KC + s], p1[2 * KC + s]};
      // gather + Boris (particles.F90:304-350)
      float F[6];
      gather6(fpad, P, ix, iy, x[0], x[1], F);
      float u0 = pu[0] * P.ipart_mc, u1 = pu[1] * P.ipart_mc,
            u2 = pu[2] * P.ipart_mc;
      float uxm = u0 + P.cm * F[0];
      float uym = u1 + P.cm * F[1];
      float uzm = u2 + P.cm * F[2];
      float igam = 1.0f / sqrtf(((uxm * uxm + uym * uym) + uzm * uzm) + 1.0f);
      float rootb = P.ccm * igam;
      float tx = F[3] * rootb, ty = F[4] * rootb, tz = F[5] * rootb;
      float tx2 = tx * tx, ty2 = ty * ty, tz2 = tz * tz;
      float tau = 1.0f / (((1.0f + tx2) + ty2) + tz2);
      float uxp = ((((1.0f + tx2) - ty2) - tz2) * uxm +
                   2.0f * ((tx * ty + tz) * uym + (tx * tz - ty) * uzm)) * tau;
      float uyp = ((((1.0f - tx2) + ty2) - tz2) * uym +
                   2.0f * ((ty * tz + tx) * uzm + (ty * tx - tz) * uxm)) * tau;
      float uzp = ((((1.0f - tx2) - ty2) + tz2) * uzm +
                   2.0f * ((tz * tx + ty) * uxm + (tz * ty - tx) * uym)) * tau;
      float ux = uxp + P.cm * F[0];
      float uy = uyp + P.cm * F[1];
      float uz = uzp + P.cm * F[2];
      igam = 1.0f / sqrtf(((ux * ux + uy * uy) + uz * uz) + 1.0f);
      float rootc = P.c * igam;
      float del[2] = {(ux * rootc) * P.dmx, (uy * rootc) * P.dmy};
      float vz = uz * rootc;
      float xn[2] = {x[0] + del[0], x[1] + del[1]};

      // PSC deposit at t + 1.5 dt (particles.F90:397-514), closed form
      float gx5[2][5], dxw[2][5], dcum[2][5];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float xd = xn[d] + del[d];
        float c3 = clamp1(floorf(xd + 0.5f));
        float cf3 = c3 - xd;
        float cf1 = -x[d];
#pragma unroll
        for (int o = -2; o <= 2; ++o) {
          float gv = (o >= -1 && o <= 1) ? tri(cf1, o) : 0.0f;
          float hv = wsel(cf3, o, (int)c3);
          gx5[d][o + 2] = gv;
          dxw[d][o + 2] = hv - gv;
        }
        dcum[d][0] = dxw[d][0];
#pragma unroll
        for (int k = 1; k < 5; ++k) dcum[d][k] = dcum[d][k - 1] + dxw[d][k];
      }
      float fjx = (P.fj0 * wv) * P.q;
      float fjy = (P.fj1 * wv) * P.q;
      float fjz = (P.fj2 * wv) * P.q;
      float fz = fjz * vz;
      float xfac1[5], yfac1[5], yfac2[5], xjx[5], yjy[5], fzd[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        xfac1[k] = gx5[0][k] + 0.5f * dxw[0][k];
        yfac1[k] = gx5[1][k] + 0.5f * dxw[1][k];
        yfac2[k] = P.third * dxw[1][k] + 0.5f * gx5[1][k];
        xjx[k] = (-fjx) * dcum[0][k];
        yjy[k] = (-fjy) * dcum[1][k];
        fzd[k] = fz * dxw[0][k];
      }
#pragma unroll
      for (int ki = 0; ki < 5; ++ki) {
        float fzg = fz * gx5[0][ki];
#pragma unroll
        for (int kj = 0; kj < 5; ++kj) {
          if (ki < 4) jx[ki * 5 + kj] += xjx[ki] * yfac1[kj];
          if (kj < 4) jy[ki * 5 + kj] += xfac1[ki] * yjy[kj];
          if (ki >= 1 && ki <= 3) jz[ki * 5 + kj] += fzg * yfac1[kj];
          jz[ki * 5 + kj] += fzd[ki] * yfac2[kj];
        }
      }
      // end-of-push open x boundaries, after the deposit
      float wout = wv;
      if (!P.periodic_x) {
        if (P.open_lo && ix == 0 && xn[0] < -0.5f) wout = 0.0f;
        if (P.open_hi && ix == P.nx - 1 && xn[0] >= 0.5f) wout = 0.0f;
      }
      int dst = cnt * C + cell;
      w_o[dst] = wout;
      xi_o[dst] = xn[0];
      xi_o[KC + dst] = xn[1];
      p_o[dst] = ux * P.part_mc;
      p_o[KC + dst] = uy * P.part_mc;
      p_o[2 * KC + dst] = uz * P.part_mc;
      ++cnt;
    }
  }
  for (int k = cnt; k < P.K; ++k) {
    int dst = k * C + cell;
    w_o[dst] = 0.0f;
    xi_o[dst] = 0.0f;
    xi_o[KC + dst] = 0.0f;
    p_o[dst] = 0.0f;
    p_o[KC + dst] = 0.0f;
    p_o[2 * KC + dst] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    part[k * C + cell] = jx[k];
    part[(25 + k) * C + cell] = jy[k];
    part[(50 + k) * C + cell] = jz[k];
  }
  if (drop) atomicAdd(ndrop, drop);
}

// ---- launch 3: fold the per-cell partials into the margin-padded J ------
__global__ void fold_currents(const float* __restrict__ part, float* jpad,
                              int nx, int ny) {
  const int C = nx * ny;
  const int W0 = nx + 4, W1 = ny + 4;
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= 3 * W0 * W1) return;
  int comp = node / (W0 * W1);
  int r = node - comp * W0 * W1;
  int X = r / W1, Y = r - (r / W1) * W1;
  float acc = 0.0f;
#pragma unroll
  for (int ki = 0; ki < 5; ++ki) {
    int sx = X - ki;            // cell whose offset ki - 2 lands on X - 2
    if (sx < 0 || sx >= nx) continue;
#pragma unroll
    for (int kj = 0; kj < 5; ++kj) {
      int sy = Y - kj;
      if (sy < 0 || sy >= ny) continue;
      acc += part[((comp * 25) + ki * 5 + kj) * C + sx * ny + sy];
    }
  }
  jpad[node] = acc;
}

}  // namespace

// Plain C interface (bound with ctypes).  Arrays are contiguous f32 on the
// device: w/xi/p the input slots, w1/xi1/p1 scratch of the same shapes,
// w_o/xi_o/p_o the output slots, fpad (6, nx+4, ny+4), part (75, nx, ny)
// scratch, jpad (3, nx+4, ny+4) the species' deposit, ndrop one int32 the
// kernel adds the dropped count to.
// ``s`` holds the scalars in the order of Params' floats.  Returns the
// first non-zero cudaError_t of the three launches.
extern "C" int binned_push_f32(const float* w, const float* xi,
                               const float* p, const float* fpad, float* w1,
                               float* xi1, float* p1, float* w_o, float* xi_o,
                               float* p_o, float* part, float* jpad,
                               int* ndrop, int K, int nx, int ny,
                               int periodic_x, int open_lo, int open_hi,
                               const float* s, void* stream) {
  Params P{K, nx, ny, periodic_x, open_lo, open_hi,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
           s[9], s[10], s[11], s[12], s[13], s[14]};
  cudaStream_t st = (cudaStream_t)stream;
  const int C = nx * ny;
  drift_xrebin<<<(C + 255) / 256, 256, 0, st>>>(w, xi, p, w1, xi1, p1, ndrop,
                                                P);
  int err = (int)cudaGetLastError();
  if (err) return err;
  yrebin_push<<<(C + 127) / 128, 128, 0, st>>>(w1, xi1, p1, fpad, w_o, xi_o,
                                               p_o, part, ndrop, P);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int nodes = 3 * (nx + 4) * (ny + 4);
  fold_currents<<<(nodes + 255) / 256, 256, 0, st>>>(part, jpad, nx, ny);
  return (int)cudaGetLastError();
}
