// Fused bonded energies and forces on Hopper (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_bonded.py, pallas_bonded_energy_forces
// (_run_family with _fam_kernel_window, or _fam_kernel for wide windows);
// the physics is _physics. Same contract: per-assignment rows (multi-term
// torsions already expanded, locality-sorted) of harmonic bonds with the
// cutoff filter (also Urey-Bradley), harmonic angles, AMBER or CHARMM
// torsions, and scaled 1-4 LJ + Coulomb with rows [A/scnb, B/scnb,
// ELEC_FACTOR*qi*qj/scee]; optional diagonal-box wrap (0 = no wrap).
//
// What bounds it on this card: thrombin has ~46 k rows a step of a few
// dozen flops each, gathering 2-4 positions from a 56 KB array that stays
// in L2 and scattering 2-4 force vectors. Arithmetic is negligible; the
// kernel is bound by launch latency, the gathers' latency and the atomics.
// The TPU version spends its effort on one-hot matmul gathers and folded
// (nblk, 8, 128) layouts because a TPU has no fast gather or scatter; a
// GPU has both, so the design is the direct one:
//   - one launch for every family: rows of a family are padded to whole
//     256-row blocks, so each block belongs to one family and its branch
//     is uniform; a small table in the kernel arguments maps blocks to
//     families;
//   - one thread per row gathers its atoms' positions from global memory
//     (read-only cache) and applies the physics in registers;
//   - per-atom contributions go to an f32 (N, 3) buffer by atomicAdd; the
//     locality sort of the plan keeps a block's atoms close together;
//   - energies reduce with warp shuffles into f64 per-block partials,
//     which a one-block kernel sums per family.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAXFAM = 8;
constexpr float TWO_PI = 6.283185307179586f;

}  // namespace

// Must match BondedCfg in torchmd_tpu_torch/ops/bonded.py field by field.
struct BondedCfg {
  int natoms;
  int nfam;
  int block_start[MAXFAM + 1];  // family f owns blocks [start[f], start[f+1])
  int kind[MAXFAM];             // 0 bond, 1 angle, 2 torsion, 3 nb14
  int flags[MAXFAM];            // bond: cutoff on; torsion: AMBER form;
                                // nb14: bit 0 LJ, bit 1 electrostatics
  float cutoff[MAXFAM];
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load_pos(const float* __restrict__ pos, int a) {
  return V3{__ldg(pos + 3 * a), __ldg(pos + 3 * a + 1), __ldg(pos + 3 * a + 2)};
}
__device__ __forceinline__ float wrap(float d, float b) {
  return b > 0.f ? d - b * rintf(d / b) : d;
}
template <bool PBC>
__device__ __forceinline__ V3 delta(V3 a, V3 b, const float* box) {
  V3 d{a.x - b.x, a.y - b.y, a.z - b.z};
  if (PBC) { d.x = wrap(d.x, box[0]); d.y = wrap(d.y, box[1]); d.z = wrap(d.z, box[2]); }
  return d;
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 scale(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float inv_norm(V3 a) { return rsqrtf(fmaxf(dot(a, a), 1e-32f)); }
__device__ __forceinline__ void scatter(float* __restrict__ f, int a, V3 v) {
  atomicAdd(f + 3 * a, v.x);
  atomicAdd(f + 3 * a + 1, v.y);
  atomicAdd(f + 3 * a + 2, v.z);
}

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  return s;  // valid in thread 0
}

template <bool PBC>
__global__ void __launch_bounds__(BLOCK)
bonded_kernel(const float* __restrict__ pos, const int4* __restrict__ idx,
              const float* __restrict__ par, const float* __restrict__ box,
              const BondedCfg cfg, float* __restrict__ forces,
              double* __restrict__ epart) {
  __shared__ double scratch[BLOCK / 32];
  int fam = 0;
  while (fam + 1 < cfg.nfam && (int)blockIdx.x >= cfg.block_start[fam + 1]) ++fam;
  const int kind = cfg.kind[fam];
  const int flags = cfg.flags[fam];
  const int row = blockIdx.x * BLOCK + threadIdx.x;
  const int4 ix = idx[row];
  const bool valid = ix.x >= 0;  // padding rows carry -1
  const float vf = valid ? 1.f : 0.f;
  const float p0 = par[3 * row], p1 = par[3 * row + 1], p2 = par[3 * row + 2];
  float e_main = 0.f, e_aux = 0.f;

  if (valid && kind == 0) {  // harmonic bond (and Urey-Bradley), cutoff filter
    const V3 d = delta<PBC>(load_pos(pos, ix.x), load_pos(pos, ix.y), box);
    const float d2 = dot(d, d);
    const float rinv = rsqrtf(fmaxf(d2, 1e-32f));
    const float r = d2 * rinv;
    const float x = r - p1;
    float e = p0 * x * x, coeff = 2.f * p0 * x;
    if (flags && !(r <= cfg.cutoff[fam])) { e = 0.f; coeff = 0.f; }
    const V3 f = scale(coeff * rinv, d);
    scatter(forces, ix.x, neg(f));
    scatter(forces, ix.y, f);
    e_main = e;
  } else if (valid && kind == 1) {  // harmonic angle, sin(theta) guards
    const V3 c = load_pos(pos, ix.y);
    const V3 r21 = delta<PBC>(load_pos(pos, ix.x), c, box);
    const V3 r23 = delta<PBC>(load_pos(pos, ix.z), c, box);
    const float n21 = inv_norm(r21), n23 = inv_norm(r23);
    const float cos_t = fminf(fmaxf(dot(r21, r23) * n21 * n23, -1.f), 1.f);
    const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
    const float theta = atan2f(fmaxf(sin_t, 1e-12f), cos_t);
    const float dt = theta - p1;
    const float coeff = sin_t != 0.f ? -2.f * p0 * dt / fmaxf(sin_t, 1e-30f) : 0.f;
    const float a21 = coeff * n21 * n21, a23 = coeff * n23 * n23, ab = coeff * n21 * n23;
    const V3 f0 = add(scale(a21 * cos_t, r21), scale(-ab, r23));
    const V3 f2 = add(scale(a23 * cos_t, r23), scale(-ab, r21));
    scatter(forces, ix.x, f0);
    scatter(forces, ix.y, neg(add(f0, f2)));
    scatter(forces, ix.z, f2);
    e_main = p0 * dt * dt;
  } else if (valid && kind == 2) {  // AMBER or CHARMM torsion
    const V3 x1 = load_pos(pos, ix.y), x2 = load_pos(pos, ix.z);
    const V3 r12 = delta<PBC>(load_pos(pos, ix.x), x1, box);
    const V3 r23 = delta<PBC>(x1, x2, box);
    const V3 r34 = delta<PBC>(x2, load_pos(pos, ix.w), box);
    const V3 A = cross(r12, r23), B = cross(r23, r34), C = cross(r23, A);
    const float inA = inv_norm(A), inB = inv_norm(B), inC = inv_norm(C);
    const float cos_phi = dot(A, B) * inA * inB;
    const float sin_phi = dot(C, B) * inC * inB;
    const float phi = -atan2f(sin_phi, cos_phi);
    float e, coeff;
    if (flags) {  // AMBER: k (1 + cos(per*phi - phi0))
      const float diff = p2 * phi - p1;
      float s, c;
      sincosf(diff, &s, &c);
      e = p0 * (1.f + c);
      coeff = -p2 * p0 * s;
    } else {  // CHARMM: k * wrap(phi - phi0)^2
      float diff = phi - p1;
      diff = diff - TWO_PI * rintf(diff / TWO_PI);
      e = p0 * diff * diff;
      coeff = 2.f * p0 * diff;
    }
    const float inD = inv_norm(r23);
    const float normD = dot(r23, r23) * inD;
    const float in2D = inD * inD;
    const float ff0 = -coeff * normD * inA * inA;
    const float ff1 = dot(r12, r23) * in2D;
    const float ff2 = dot(r34, r23) * in2D;
    const float ff3 = coeff * normD * inB * inB;
    const V3 f0 = scale(ff0, A), f3 = scale(ff3, B);
    const V3 s = add(scale(ff1, f0), scale(-ff2, f3));
    scatter(forces, ix.x, neg(f0));
    scatter(forces, ix.y, add(f0, s));
    scatter(forces, ix.z, add(f3, neg(s)));
    scatter(forces, ix.w, neg(f3));
    e_main = e;
  } else if (kind == 3) {  // scaled 1-4 LJ + Coulomb
    const int a = valid ? ix.x : 0, b = valid ? ix.y : 0;
    const V3 d = delta<PBC>(load_pos(pos, a), load_pos(pos, b), box);
    // zero rinv on padding rows: r = 0 would overflow rinv^12
    const float rinv = inv_norm(d) * vf;
    const float rinv2 = rinv * rinv;
    float coeff = 0.f;
    if (flags & 1) {
      const float rinv6 = rinv2 * rinv2 * rinv2, rinv12 = rinv6 * rinv6;
      e_main = (p0 * rinv12 - p1 * rinv6) * vf;
      coeff += (-12.f * p0 * rinv12 + 6.f * p1 * rinv6) * rinv2;
    }
    if (flags & 2) {
      const float p_e = p2 * rinv;
      e_aux = p_e * vf;
      coeff -= p_e * rinv2;
    }
    if (valid) {
      const V3 f = scale(coeff, d);
      scatter(forces, a, neg(f));
      scatter(forces, b, f);
    }
  }

  const double bm = block_sum((double)e_main, scratch);
  const double ba = block_sum((double)e_aux, scratch);
  if (threadIdx.x == 0) {
    epart[2 * blockIdx.x] = bm;
    epart[2 * blockIdx.x + 1] = ba;
  }
}

// One block: energies[2f + k] = sum of the family's block partials.
__global__ void __launch_bounds__(BLOCK)
bonded_finish(const double* __restrict__ epart, const BondedCfg cfg,
              float* __restrict__ energies) {
  __shared__ double scratch[BLOCK / 32];
  for (int f = 0; f < cfg.nfam; ++f) {
    double a = 0.0, b = 0.0;
    for (int p = cfg.block_start[f] + threadIdx.x; p < cfg.block_start[f + 1]; p += BLOCK) {
      a += epart[2 * p];
      b += epart[2 * p + 1];
    }
    a = block_sum(a, scratch);
    b = block_sum(b, scratch);
    if (threadIdx.x == 0) {
      energies[2 * f] = (float)a;
      energies[2 * f + 1] = (float)b;
    }
  }
}

}  // namespace

// pos (N,3) f32; idx (R,4) int32 with R = block_start[nfam] * 256 rows,
// -1 in unused slots and padding rows; par (R,3) f32; box (3) or null (no
// PBC). Scratch epart (R/256, 2) f64. Outputs forces (N,3) f32 (zeroed
// here) and energies (nfam, 2) f32 as [main, 1-4 electrostatics].
// Returns cudaGetLastError().
extern "C" int tmd_bonded_energy_forces(const float* pos, const int32_t* idx,
                                        const float* par, const float* box,
                                        BondedCfg cfg, double* epart,
                                        float* forces, float* energies,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = cfg.block_start[cfg.nfam];
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  if (box != nullptr)
    bonded_kernel<true><<<nblocks, BLOCK, 0, s>>>(pos, idx4, par, box, cfg, forces, epart);
  else
    bonded_kernel<false><<<nblocks, BLOCK, 0, s>>>(pos, idx4, par, box, cfg, forces, epart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bonded_finish<<<1, BLOCK, 0, s>>>(epart, cfg, energies);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
