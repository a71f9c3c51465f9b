// Column-pair nonbonded energy, forces and per-axis virial on Hopper
// (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_column.py, column_pair_call with its
// kernel _kernel, together with what its caller columns.column_energy_forces
// does around it (the per-slot force scatter and the -0.5 on the virial
// stays with the Python wrapper). The contract is ops/column.py's: for
// every column c, i block bi of IBLK slots and half-stencil offset o9 in
// 4..8, the block's atoms against the W extended j slots of the neighbour
// column starting at slot 128 * wstart[c][o9][bi] (j z shifted by
// jzshift * Lz, x/y by the neighbour column's wrap times the current box);
// a pair counts when both ids are below N, i != j, j is not excluded for
// i and d^2 < cutoff^2. The self offset (o9 = 4) has weight 1 on the 0.5-
// weighted energies and i-side forces only; the four directed offsets have
// weight 2 and put the j-side force on atom j. The per-pair math is
// pair_terms.cuh, shared with nonbonded.cu and cell.cu.
//
// What bounds it on this card: it visits 5 * ncol * NB * IBLK * W slot
// pairs (the 62,500-site water box: ~4.1e8 for ~1.05e7 unordered pairs
// inside the cutoff), each a shared-memory read and ~10 FP32 operations
// before the cutoff test; device memory moves O(N) bytes. It is FP32-ALU
// and shared-memory bound, so:
//   - one block per (column, i block), SPLIT threads per i slot, each
//     taking a quarter of the window: IBLK * SPLIT = 192 threads, i data
//     in registers, the 5 offsets in a loop inside the block;
//   - for each offset the block stages the W-slot window (x, y, z with
//     the image shift added, q, sigma/2, sqrt|eps|, id) in shared memory;
//     padding slots sit at 1e18 A, so the cutoff test drops them;
//   - the lanes of a warp start their pass over the window quarter at
//     their own i slot (a rotation), so at each step they touch distinct
//     j slots: the j-side forces of the directed offsets go to a shared
//     per-window-slot accumulator with atomicAdd free of same-address
//     conflicts, and after the offset each slot's sum is added to the
//     atom with one global atomicAdd per axis;
//   - i forces stay in registers across the offsets, are reduced over the
//     SPLIT threads of the slot through shared memory, and added to the
//     atom with atomicAdd (the atom also receives j-side forces from other
//     blocks). Forces are therefore summed in a run-dependent order: not
//     bitwise deterministic, equal to f32 rounding;
//   - energies and the raw virial sums g * d_a^2 accumulate per offset in
//     f32 and across offsets in f64, reduce per block, and each block adds
//     them with one double atomicAdd; a finishing kernel rounds to f32.
// The VIRIAL template flag carries the virial sums; without it they cost
// nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

constexpr int SPLIT = 4;
constexpr int STRIDE = 128;
constexpr int REG_EXCL = 8;
constexpr int MAX_THREADS = 1024;
constexpr float FAR = 1e18f;

}  // namespace

// Must match ColumnCfg in torchmd_tpu_torch/ops/column.py field by field.
struct ColumnCfg {
  int natoms;
  int ncx, ncy;
  int C, CE, W, NB, iblk;
  int nexcl;      // width of the exclusion table
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_switch;
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

template <bool VIRIAL>
__global__ void __launch_bounds__(MAX_THREADS)
column_kernel(const float* __restrict__ pos, const float* __restrict__ q,
              const float* __restrict__ sig, const float* __restrict__ eps,
              const int32_t* __restrict__ excl, const int32_t* __restrict__ islot,
              const int32_t* __restrict__ jslot, const float* __restrict__ jzshift,
              const int32_t* __restrict__ wstart, const float* __restrict__ box,
              const ColumnCfg cfg, float* __restrict__ forces,
              double* __restrict__ acc) {
  extern __shared__ float smem[];
  __shared__ double scratch[MAX_THREADS / 32];
  const int W = cfg.W;
  float* sx = smem;
  float* sy = sx + W;
  float* sz = sy + W;
  float* sq = sz + W;
  float* ss = sq + W;
  float* se = ss + W;
  int* sid = reinterpret_cast<int*>(se + W);
  float* jacc = reinterpret_cast<float*>(sid + W);  // (W, 3)
  float* fred = jacc + 3 * W;                       // (blockDim, 3)

  const int n = cfg.natoms;
  const int c = blockIdx.x / cfg.NB;
  const int bi = blockIdx.x % cfg.NB;
  if (wstart[(c * 9 + 4) * cfg.NB + bi] < 0) return;  // an all-padding block

  const int t = threadIdx.x;
  const int il = t % cfg.iblk;
  const int sp = t / cfg.iblk;
  int i = n;
  if (sp < SPLIT) i = islot[c * cfg.C + bi * cfg.iblk + il];
  const bool active = i < n;
  const int ne = cfg.nexcl;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, si = 0.f, ei = 0.f;
  int ex[REG_EXCL];
  if (active) {
    xi = pos[3 * i]; yi = pos[3 * i + 1]; zi = pos[3 * i + 2];
    qi = q[i]; si = sig[i]; ei = eps[i];
  }
#pragma unroll
  for (int e = 0; e < REG_EXCL; ++e)
    ex[e] = (active && e < ne) ? excl[(size_t)i * ne + e] : -1;
  const float bx = box[0], by = box[1], bz = box[2];
  const int cx = c / cfg.ncy, cy = c % cfg.ncy;
  const int L = W / SPLIT;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  double elj = 0.0, eel = 0.0, wx = 0.0, wy = 0.0, wz = 0.0;
  for (int o9 = 4; o9 < 9; ++o9) {
    const bool directed = o9 != 4;
    const int tx = cx + o9 / 3 - 1, ty = cy + o9 % 3 - 1;
    const float shx = tx < 0 ? -bx : (tx >= cfg.ncx ? bx : 0.f);
    const float shy = ty < 0 ? -by : (ty >= cfg.ncy ? by : 0.f);
    const int cj = ((tx + cfg.ncx) % cfg.ncx) * cfg.ncy + (ty + cfg.ncy) % cfg.ncy;
    const int base = cj * cfg.CE + wstart[(c * 9 + o9) * cfg.NB + bi] * STRIDE;
    __syncthreads();  // the previous window has been consumed
    for (int k = t; k < W; k += blockDim.x) {
      const int j = jslot[base + k];
      if (j < n) {
        sx[k] = pos[3 * j] + shx;
        sy[k] = pos[3 * j + 1] + shy;
        sz[k] = pos[3 * j + 2] + jzshift[base + k] * bz;
        sq[k] = q[j]; ss[k] = sig[j]; se[k] = eps[j];
      } else {
        sx[k] = sy[k] = sz[k] = FAR;
        sq[k] = ss[k] = se[k] = 0.f;
      }
      sid[k] = j;
      if (directed) jacc[3 * k] = jacc[3 * k + 1] = jacc[3 * k + 2] = 0.f;
    }
    __syncthreads();

    if (active) {
      float tlj = 0.f, tel = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
      const int k0 = sp * L;
      for (int r = 0; r < L; ++r) {
        int kr = r + il;
        kr = kr >= L ? kr % L : kr;
        const int k = k0 + kr;
        const float dx = xi - sx[k], dy = yi - sy[k], dz = zi - sz[k];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > cfg.cutoff2) continue;
        const int j = sid[k];
        if (j == i) continue;
        bool hit = false;
#pragma unroll
        for (int e = 0; e < REG_EXCL; ++e) hit |= ex[e] == j;
        for (int e = REG_EXCL; e < ne; ++e) hit |= __ldg(excl + (size_t)i * ne + e) == j;
        if (hit) continue;
        float A = 0.f, B = 0.f;
        if (cfg.lj_kind != 0) lb_coefficients(si, ss[k], ei, se[k], A, B);
        const float g = pair_terms(cfg, d2, A, B, cfg.elec_factor * qi * sq[k], tlj, tel);
        const float gx = g * dx, gy = g * dy, gz = g * dz;
        fx -= gx;
        fy -= gy;
        fz -= gz;
        if (directed) {
          atomicAdd(jacc + 3 * k, gx);
          atomicAdd(jacc + 3 * k + 1, gy);
          atomicAdd(jacc + 3 * k + 2, gz);
        }
        if (VIRIAL) {
          vx += gx * dx;
          vy += gy * dy;
          vz += gz * dz;
        }
      }
      // energies carry 0.5 (self: both orderings) or 1 (directed: once);
      // the raw virial sums 1 or 2
      const double we = directed ? 1.0 : 0.5;
      elj += we * (double)tlj;
      eel += we * (double)tel;
      if (VIRIAL) {
        const double wv = 2.0 * we;
        wx += wv * (double)vx;
        wy += wv * (double)vy;
        wz += wv * (double)vz;
      }
    }
    if (directed) {
      __syncthreads();
      for (int k = t; k < W; k += blockDim.x) {
        const int j = sid[k];
        const float ax = jacc[3 * k], ay = jacc[3 * k + 1], az = jacc[3 * k + 2];
        if (j < n && (ax != 0.f || ay != 0.f || az != 0.f)) {
          atomicAdd(forces + 3 * j, ax);
          atomicAdd(forces + 3 * j + 1, ay);
          atomicAdd(forces + 3 * j + 2, az);
        }
      }
    }
  }

  // i forces: sum the SPLIT partials of each slot, one atomic per axis
  fred[3 * t] = fx; fred[3 * t + 1] = fy; fred[3 * t + 2] = fz;
  __syncthreads();
  if (sp == 0 && active) {
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int s = 0; s < SPLIT; ++s) {
      const int u = s * cfg.iblk + il;
      ax += fred[3 * u]; ay += fred[3 * u + 1]; az += fred[3 * u + 2];
    }
    atomicAdd(forces + 3 * i, ax);
    atomicAdd(forces + 3 * i + 1, ay);
    atomicAdd(forces + 3 * i + 2, az);
  }
  const double blj = block_sum(elj, scratch);
  const double bel = block_sum(eel, scratch);
  if (t == 0) {
    atomicAdd(acc, blj);
    atomicAdd(acc + 1, bel);
  }
  if (VIRIAL) {
    const double bvx = block_sum(wx, scratch);
    const double bvy = block_sum(wy, scratch);
    const double bvz = block_sum(wz, scratch);
    if (t == 0) {
      atomicAdd(acc + 2, bvx);
      atomicAdd(acc + 3, bvy);
      atomicAdd(acc + 4, bvz);
    }
  }
}

__global__ void column_finish(const double* __restrict__ acc, int nout,
                              float* __restrict__ out) {
  if (threadIdx.x < nout) out[threadIdx.x] = (float)acc[threadIdx.x];
}

template <bool VIRIAL>
cudaError_t launch(const float* pos, const float* q, const float* sig,
                   const float* eps, const int32_t* excl, const int32_t* islot,
                   const int32_t* jslot, const float* jzshift, const int32_t* wstart,
                   const float* box, const ColumnCfg& cfg, float* forces, double* acc,
                   cudaStream_t s) {
  const int ncol = cfg.ncx * cfg.ncy;
  const int threads = (cfg.iblk * SPLIT + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (10 * (size_t)cfg.W + 3 * (size_t)threads);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        column_kernel<VIRIAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  column_kernel<VIRIAL><<<ncol * cfg.NB, threads, smem, s>>>(
      pos, q, sig, eps, excl, islot, jslot, jzshift, wstart, box, cfg, forces, acc);
  return cudaGetLastError();
}

}  // namespace

// pos (N,3) anchored positions, q/sig/eps (N), excl (N, nexcl) int32 (N =
// empty), islot (ncol, C), jslot (ncol, CE) int32 (N = padding), jzshift
// (ncol, CE) in units of Lz, wstart (ncol, 9, NB) int32 in units of 128
// slots (-1 = skip), box (3). Scratch: acc (5) f64. Outputs: forces (N,3),
// zeroed first; out (5) as [lj-family energy, electrostatic energy] and,
// with `virial`, the weighted raw sums g * d_a^2 for a = x, y, z (the
// caller applies -0.5). Returns cudaGetLastError().
extern "C" int tmd_column_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* excl, const int32_t* islot, const int32_t* jslot,
    const float* jzshift, const int32_t* wstart, const float* box, ColumnCfg cfg,
    int virial, float* forces, double* acc, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.iblk < 1 || cfg.iblk * SPLIT > MAX_THREADS || cfg.W < STRIDE ||
      cfg.W % STRIDE != 0 || cfg.W % SPLIT != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(acc, 0, sizeof(double) * 5, s);
  if (err != cudaSuccess) return (int)err;
  err = virial ? launch<true>(pos, q, sig, eps, excl, islot, jslot, jzshift, wstart,
                              box, cfg, forces, acc, s)
               : launch<false>(pos, q, sig, eps, excl, islot, jslot, jzshift, wstart,
                               box, cfg, forces, acc, s);
  if (err != cudaSuccess) return (int)err;
  column_finish<<<1, 32, 0, s>>>(acc, virial ? 5 : 2, out);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
