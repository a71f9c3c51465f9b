// Dense all-pairs nonbonded energy and forces on Hopper (sm_90a).
// The per-pair term math is pair_terms.cuh, shared with cell.cu and
// column.cu.
//
// Replaces: torchmd_tpu/ops/pallas_nonbonded.py, pallas_nonbonded_energy_forces
// with its kernels _kernel_tri (the Newton-half schedule) and _kernel (the
// full square); the per-pair math is pair_terms. Same inputs (per-atom
// charge, sigma/2 and sqrt|eps| rows or NBFIX A/B tables by type, an int8
// exclusion mask), same outputs (0.5-weighted lj/electrostatics energies,
// forces (N, 3)), same branches: LJ with the polynomial switch, repulsion
// A/r^12, repulsioncg B/r^6, Coulomb plain / reaction field / Ewald erfc,
// and a minimum-image wrap on a diagonal box where a 0 component means no
// wrap on that axis.
//
// What bounds it on this card: the full square is N^2 pair slots of ~60
// f32 operations each (thrombin: 21.9 M slots, ~1.3 GFLOP a call) against
// an N^2-byte int8 mask (21.9 MB, which stays resident in the 50 MB L2
// from one step to the next). That is FP32-ALU bound, so the design keeps
// the ALUs fed:
//   - one thread per i atom, 128 i atoms per block; the block stages 128 j
//     atoms (x, y, z, q, sigma/2, sqrt|eps|, type) and the 128x128 mask
//     tile in shared memory, so the inner loop reads only shared memory
//     and registers;
//   - the mask is symmetric, so thread i reads mask[j, i]: neighbouring
//     threads load neighbouring bytes;
//   - a 4,676-atom system has only 37 i-tiles for 132 SMs, so grid.y
//     splits the j range; each split writes its own force partial and a
//     second kernel sums the splits in a fixed order. Forces are therefore
//     deterministic and no atomics are used;
//   - energies accumulate per j tile in f32 and across tiles in f64, then
//     reduce per block; the finishing kernel sums the block partials.
// Each thread sums its own full row (full square, 0.5 on the energies).
// The Newton-half schedule is left to a later optimisation. The kernel has
// one instance per electrostatics kind (pair_terms.cuh's ELEC): with the
// kind a runtime branch the reaction-field loop ran 17 % slower (thrombin,
// same H100; the other kinds' code shared its loop).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

constexpr int TILE = 128;
constexpr int FIN_THREADS = 256;

}  // namespace

// Must match PairCfg in torchmd_tpu_torch/ops/nonbonded.py field by field.
struct PairCfg {
  int natoms;
  int ntypes;
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_cutoff;
  int use_switch;
  int pbc;        // read by the host entry only (template flag)
  int nsplit;     // number of j-range splits (grid.y)
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

__device__ __forceinline__ float wrap(float d, float b) {
  return b > 0.f ? d - b * rintf(d / b) : d;
}

template <bool PBC, bool NBFIX, int ELEC>
__global__ void __launch_bounds__(TILE)
pair_kernel(const float* __restrict__ pos, const float* __restrict__ q,
            const float* __restrict__ sig, const float* __restrict__ eps,
            const int32_t* __restrict__ types, const float* __restrict__ lj_a,
            const float* __restrict__ lj_b, const int8_t* __restrict__ mask,
            const float* __restrict__ box, const PairCfg cfg,
            float* __restrict__ fpart, double* __restrict__ epart) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sq[TILE], ss[TILE], se[TILE];
  __shared__ int st[TILE];
  __shared__ int8_t smask[TILE * TILE];
  __shared__ double scratch[TILE / 32];

  const int n = cfg.natoms;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * TILE + tid;
  const bool active = i < n;

  float bx = 0.f, by = 0.f, bz = 0.f;
  if (PBC) { bx = box[0]; by = box[1]; bz = box[2]; }

  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, si = 0.f, ei = 0.f;
  int ti = 0;
  if (active) {
    xi = pos[3 * i]; yi = pos[3 * i + 1]; zi = pos[3 * i + 2];
    qi = q[i]; si = sig[i]; ei = eps[i];
    if (NBFIX) ti = types[i];
  }

  const int ntiles = (n + TILE - 1) / TILE;
  const int per_split = (ntiles + cfg.nsplit - 1) / cfg.nsplit;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(ntiles, t_begin + per_split);

  float fx = 0.f, fy = 0.f, fz = 0.f;
  double elj = 0.0, eel = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * TILE;
    const int jn = min(TILE, n - j0);
    __syncthreads();  // the previous tile has been consumed
    if (tid < jn) {
      const int j = j0 + tid;
      sx[tid] = pos[3 * j]; sy[tid] = pos[3 * j + 1]; sz[tid] = pos[3 * j + 2];
      sq[tid] = q[j]; ss[tid] = sig[j]; se[tid] = eps[j];
      if (NBFIX) st[tid] = types[j];
    }
    for (int r = 0; r < jn; ++r)
      smask[r * TILE + tid] = active ? mask[(size_t)(j0 + r) * n + i] : (int8_t)0;
    __syncthreads();

    float tlj = 0.f, tel = 0.f;
    for (int r = 0; r < jn; ++r) {
      if (smask[r * TILE + tid] == 0) continue;
      float dx = xi - sx[r], dy = yi - sy[r], dz = zi - sz[r];
      if (PBC) { dx = wrap(dx, bx); dy = wrap(dy, by); dz = wrap(dz, bz); }
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (cfg.use_cutoff && d2 > cfg.cutoff2) continue;
      float A = 0.f, B = 0.f;
      if (cfg.lj_kind != 0) {
        if (NBFIX) {
          const int k = ti * cfg.ntypes + st[r];
          A = __ldg(lj_a + k);
          B = __ldg(lj_b + k);
        } else {
          lb_coefficients(si, ss[r], ei, se[r], A, B);
        }
      }
      const float g = pair_terms<ELEC>(cfg, d2, A, B, cfg.elec_factor * qi * sq[r], tlj, tel);
      fx -= g * dx;
      fy -= g * dy;
      fz -= g * dz;
    }
    elj += (double)tlj;
    eel += (double)tel;
  }

  if (active) {
    float* out = fpart + (size_t)blockIdx.y * 3 * n + 3 * i;
    out[0] = fx; out[1] = fy; out[2] = fz;
  }
  const double blj = block_sum(elj, scratch);
  const double bel = block_sum(eel, scratch);
  if (tid == 0) {
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    epart[2 * b] = 0.5 * blj;
    epart[2 * b + 1] = 0.5 * bel;
  }
}

// Sums the j-split force partials per atom component in split order, and
// (block 0) the per-block energy partials.
__global__ void __launch_bounds__(FIN_THREADS)
pair_finish(const float* __restrict__ fpart, const double* __restrict__ epart,
            int n, int nsplit, int nblocks, float* __restrict__ forces,
            float* __restrict__ energies) {
  __shared__ double scratch[FIN_THREADS / 32];
  const int k = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (k < 3 * n) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += fpart[(size_t)p * 3 * n + k];
    forces[k] = s;
  }
  if (blockIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int p = threadIdx.x; p < nblocks; p += FIN_THREADS) {
      a += epart[2 * p];
      b += epart[2 * p + 1];
    }
    a = block_sum(a, scratch);
    b = block_sum(b, scratch);
    if (threadIdx.x == 0) {
      energies[0] = (float)a;
      energies[1] = (float)b;
    }
  }
}

template <bool PBC, bool NBFIX>
void launch_pair(dim3 grid, cudaStream_t s, const float* pos, const float* q,
                 const float* sig, const float* eps, const int32_t* types,
                 const float* lj_a, const float* lj_b, const int8_t* mask,
                 const float* box, const PairCfg& cfg, float* fpart,
                 double* epart) {
  // one instance per electrostatics kind (pair_terms.cuh)
  switch (cfg.elec_kind) {
    case 0:
      pair_kernel<PBC, NBFIX, 0><<<grid, TILE, 0, s>>>(pos, q, sig, eps, types, lj_a, lj_b,
                                                       mask, box, cfg, fpart, epart);
      break;
    case 1:
      pair_kernel<PBC, NBFIX, 1><<<grid, TILE, 0, s>>>(pos, q, sig, eps, types, lj_a, lj_b,
                                                       mask, box, cfg, fpart, epart);
      break;
    case 2:
      pair_kernel<PBC, NBFIX, 2><<<grid, TILE, 0, s>>>(pos, q, sig, eps, types, lj_a, lj_b,
                                                       mask, box, cfg, fpart, epart);
      break;
    default:
      pair_kernel<PBC, NBFIX, 3><<<grid, TILE, 0, s>>>(pos, q, sig, eps, types, lj_a, lj_b,
                                                       mask, box, cfg, fpart, epart);
  }
}

}  // namespace

// pos (N,3), q/sig/eps (N), types (N) or null, lj_a/lj_b (T,T) or null
// (null: Lorentz-Berthelot from sig/eps), mask (N,N) int8, box (3) or null
// (no PBC). Scratch: fpart (nsplit,N,3), epart (nblocks,2) f64 with
// nblocks = ceil(N/128) * nsplit. Outputs: forces (N,3), energies (2) as
// [lj-family, electrostatics]. Returns cudaGetLastError().
extern "C" int tmd_pair_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* types, const float* lj_a, const float* lj_b,
    const int8_t* mask, const float* box, PairCfg cfg, float* fpart,
    double* epart, float* forces, float* energies, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = cfg.natoms;
  const dim3 grid((n + TILE - 1) / TILE, cfg.nsplit);
  const bool nbfix = lj_a != nullptr;
  if (cfg.pbc) {
    if (nbfix) launch_pair<true, true>(grid, s, pos, q, sig, eps, types, lj_a, lj_b, mask, box, cfg, fpart, epart);
    else launch_pair<true, false>(grid, s, pos, q, sig, eps, types, lj_a, lj_b, mask, box, cfg, fpart, epart);
  } else {
    if (nbfix) launch_pair<false, true>(grid, s, pos, q, sig, eps, types, lj_a, lj_b, mask, box, cfg, fpart, epart);
    else launch_pair<false, false>(grid, s, pos, q, sig, eps, types, lj_a, lj_b, mask, box, cfg, fpart, epart);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (int)(grid.x * grid.y);
  const int fin_blocks = max(1, (3 * n + FIN_THREADS - 1) / FIN_THREADS);
  pair_finish<<<fin_blocks, FIN_THREADS, 0, s>>>(fpart, epart, n, cfg.nsplit,
                                                 nblocks, forces, energies);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
