// Cell-list nonbonded energy and forces on Hopper (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_cell.py, pallas_cell_energy_forces with
// its kernel _kernel (27-stencil ghost-cell pair blocks; the per-pair math
// is pallas_nonbonded.pair_terms, here pair_terms.cuh shared with
// nonbonded.cu). Same contract as neighbors.cell_nonbonded_energy_forces:
// the pairs of each cell's atoms with the atoms of its 27 neighbour cells
// (cell edge >= cutoff + skin), the periodic image as a per-neighbour-cell
// shift of the anchored positions (no per-pair wrap, no ghost arrays),
// exclusions from a padded per-atom list, the cutoff on d^2, LJ with the
// switch or repulsion or repulsioncg plus Coulomb plain / reaction field /
// Ewald erfc. Energies carry 0.5 (every pair is seen from both cells).
//
// What bounds it on this card: the stencil visits every (i, j) pair of
// neighbouring cells, 27 * ncells * count^2 candidate pairs (the 62,500-site
// water box: ~3e8 for ~2.2e7 pairs inside the cutoff), each a shared-memory
// read and ~10 FP32 operations before the cutoff test; the ~7 % inside the
// cutoff take the full pair terms (~60 operations with erfc). It is FP32-
// ALU and shared-memory bound; device memory moves only O(N) bytes. So:
//   - one block per cell, one thread per slot of the cell (blockDim = the
//     capacity rounded up to a warp), i data in registers;
//   - for each of the 27 neighbour cells the block stages its occupied
//     slots (x, y, z + image shift, q, sigma/2, sqrt|eps|, id) in shared
//     memory, and every thread loops over them; the loop bound is the
//     neighbour's count, so empty slots cost nothing;
//   - i's exclusion list is held in registers (the first REG_EXCL entries)
//     and checked only for pairs inside the cutoff;
//   - each thread owns its atom's force: no atomics, deterministic forces;
//   - energies accumulate per neighbour cell in f32 and across cells in
//     f64, reduce per block, and a finishing kernel sums the blocks.
// The VIRIAL instance (MTK barostat; pallas_cell.py's with_virial) also
// sums g * d_a^2 per axis over the pairs, like the energies, and returns
// that raw sum: the caller applies the -0.5 (each pair is seen from both
// cells). The plain instance carries none of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

constexpr int REG_EXCL = 8;
constexpr int MAX_THREADS = 1024;
constexpr int FIN_THREADS = 256;

}  // namespace

// Must match CellCfg in torchmd_tpu_torch/ops/cell.py field by field.
struct CellCfg {
  int natoms;
  int capacity;
  int ncx, ncy, ncz;
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

// Neighbour cell index along one axis and the image shift of its atoms.
__device__ __forceinline__ int wrap_cell(int c, int nc, float box, float& shift) {
  shift = 0.f;
  if (c < 0) { c += nc; shift = -box; }
  else if (c >= nc) { c -= nc; shift = box; }
  return c;
}

template <bool VIRIAL>
__global__ void __launch_bounds__(MAX_THREADS)
cell_kernel(const float* __restrict__ pos, const float* __restrict__ q,
            const float* __restrict__ sig, const float* __restrict__ eps,
            const int32_t* __restrict__ slots, const int32_t* __restrict__ counts,
            const int32_t* __restrict__ excl, const float* __restrict__ box,
            const CellCfg cfg, float* __restrict__ forces,
            double* __restrict__ epart) {
  extern __shared__ float smem[];
  __shared__ double scratch[MAX_THREADS / 32];
  const int cap = cfg.capacity;
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* sq = sz + cap;
  float* ss = sq + cap;
  float* se = ss + cap;
  int* sid = reinterpret_cast<int*>(se + cap);

  const int c = blockIdx.x;
  const int cz = c % cfg.ncz;
  const int cy = (c / cfg.ncz) % cfg.ncy;
  const int cx = c / (cfg.ncz * cfg.ncy);
  const int t = threadIdx.x;
  const int cnt_i = min(counts[c], cap);
  const bool active = t < cnt_i;
  const int ne = cfg.nexcl;

  int i = -1;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, si = 0.f, ei = 0.f;
  int ex[REG_EXCL];
  if (active) {
    i = slots[c * cap + t];
    xi = pos[3 * i]; yi = pos[3 * i + 1]; zi = pos[3 * i + 2];
    qi = q[i]; si = sig[i]; ei = eps[i];
  }
#pragma unroll
  for (int e = 0; e < REG_EXCL; ++e)
    ex[e] = (active && e < ne) ? excl[(size_t)i * ne + e] : -1;
  const float bx = box[0], by = box[1], bz = box[2];

  float fx = 0.f, fy = 0.f, fz = 0.f;
  double elj = 0.0, eel = 0.0;
  double wx = 0.0, wy = 0.0, wz = 0.0;
  for (int o = 0; o < 27; ++o) {
    float shx, shy, shz;
    const int nx = wrap_cell(cx + o / 9 - 1, cfg.ncx, bx, shx);
    const int ny = wrap_cell(cy + (o / 3) % 3 - 1, cfg.ncy, by, shy);
    const int nz = wrap_cell(cz + o % 3 - 1, cfg.ncz, bz, shz);
    const int nc = (nx * cfg.ncy + ny) * cfg.ncz + nz;
    const int cnt_j = min(counts[nc], cap);
    __syncthreads();  // the previous neighbour cell has been consumed
    for (int k = t; k < cnt_j; k += blockDim.x) {
      const int j = slots[nc * cap + k];
      sx[k] = pos[3 * j] + shx;
      sy[k] = pos[3 * j + 1] + shy;
      sz[k] = pos[3 * j + 2] + shz;
      sq[k] = q[j]; ss[k] = sig[j]; se[k] = eps[j];
      sid[k] = j;
    }
    __syncthreads();
    if (!active) continue;

    float tlj = 0.f, tel = 0.f;
    float vx = 0.f, vy = 0.f, vz = 0.f;
    for (int r = 0; r < cnt_j; ++r) {
      const float dx = xi - sx[r], dy = yi - sy[r], dz = zi - sz[r];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 > cfg.cutoff2) continue;
      const int j = sid[r];
      if (j == i) continue;
      bool hit = false;
#pragma unroll
      for (int e = 0; e < REG_EXCL; ++e) hit |= ex[e] == j;
      for (int e = REG_EXCL; e < ne; ++e) hit |= __ldg(excl + (size_t)i * ne + e) == j;
      if (hit) continue;
      float A = 0.f, B = 0.f;
      if (cfg.lj_kind != 0) lb_coefficients(si, ss[r], ei, se[r], A, B);
      const float g = pair_terms(cfg, d2, A, B, cfg.elec_factor * qi * sq[r], tlj, tel);
      fx -= g * dx;
      fy -= g * dy;
      fz -= g * dz;
      if (VIRIAL) {
        vx += g * dx * dx;
        vy += g * dy * dy;
        vz += g * dz * dz;
      }
    }
    elj += (double)tlj;
    eel += (double)tel;
    if (VIRIAL) {
      wx += (double)vx;
      wy += (double)vy;
      wz += (double)vz;
    }
  }

  if (active) {
    forces[3 * i] = fx; forces[3 * i + 1] = fy; forces[3 * i + 2] = fz;
  }
  constexpr int NP = VIRIAL ? 5 : 2;
  const double blj = block_sum(elj, scratch);
  const double bel = block_sum(eel, scratch);
  if (t == 0) {
    epart[NP * c] = 0.5 * blj;
    epart[NP * c + 1] = 0.5 * bel;
  }
  if (VIRIAL) {
    const double bx = block_sum(wx, scratch);
    const double by = block_sum(wy, scratch);
    const double bz = block_sum(wz, scratch);
    if (t == 0) {
      epart[NP * c + 2] = bx;
      epart[NP * c + 3] = by;
      epart[NP * c + 4] = bz;
    }
  }
}

// Sums the per-cell partials (np of them per cell: the two energies, and
// the three raw virial sums) in a fixed order.
__global__ void __launch_bounds__(FIN_THREADS)
cell_finish(const double* __restrict__ epart, int ncells, int np,
            float* __restrict__ energies) {
  __shared__ double scratch[FIN_THREADS / 32];
  for (int k = 0; k < np; ++k) {
    double a = 0.0;
    for (int p = threadIdx.x; p < ncells; p += FIN_THREADS) a += epart[np * p + k];
    a = block_sum(a, scratch);
    if (threadIdx.x == 0) energies[k] = (float)a;
  }
}

}  // namespace

// pos (N,3) anchored positions, q/sig/eps (N), slots (ncells, capacity)
// int32 with slot k < counts[c] occupied, counts (ncells) int32, excl
// (N, nexcl) int32 (N = empty), box (3). Scratch: epart (ncells, np) f64
// with np = 5 when `virial` is set, else 2. Outputs: forces (N,3), zeroed
// first so an atom that a capacity overflow dropped from its cell reads 0
// (the caller redoes an overflowed step); energies (np) as [lj-family,
// electrostatics] and, with `virial`, the raw sums g * d_a^2 for a = x,
// y, z. Returns cudaGetLastError().
extern "C" int tmd_cell_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* slots, const int32_t* counts, const int32_t* excl,
    const float* box, CellCfg cfg, int virial, float* forces, double* epart,
    float* energies, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncells = cfg.ncx * cfg.ncy * cfg.ncz;
  if (cfg.capacity < 1 || cfg.capacity > MAX_THREADS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = (cfg.capacity + 31) / 32 * 32;
  const size_t smem = sizeof(float) * 7 * (size_t)cfg.capacity;
  if (virial)
    cell_kernel<true><<<ncells, threads, smem, s>>>(pos, q, sig, eps, slots, counts,
                                                    excl, box, cfg, forces, epart);
  else
    cell_kernel<false><<<ncells, threads, smem, s>>>(pos, q, sig, eps, slots, counts,
                                                     excl, box, cfg, forces, epart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cell_finish<<<1, FIN_THREADS, 0, s>>>(epart, ncells, virial ? 5 : 2, energies);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
