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
// What bounds it on this card: thrombin has ~41 k rows a step of a few
// dozen flops each, gathering 2-4 positions from a 56 KB array that stays
// in L2 and scattering 2-4 force vectors. Arithmetic is negligible (the
// bytes take 0.4 us); the kernel is bound by launches, the latency of one
// wave of blocks (gathers, atan2/sincos) and the scatter: a global atomic
// per force component is 369 k on thrombin. The TPU kernel gives each
// tile of rows an atom window and accumulates into it
// (_fam_kernel_window); here the same idea in shared memory:
//   - one launch for every family: rows of a family are padded to whole
//     blocks of `blockDim.x` rows (ops/bonded.py ROWS, 128), so each block
//     belongs to one family and its branch is uniform; a small table in
//     the kernel arguments maps blocks to families;
//   - atom windows: the plan gives each block the span [lo, lo + n) of the
//     atoms its rows touch (at most 696 atoms on thrombin in blocks of 128
//     rows); a block whose span fits the shared buffer (cfg.wcap atoms, 12
//     bytes each) zeroes it, and each row adds its atoms' force
//     contributions there with shared float atomics, once per atom and
//     warp after the lanes with equal atom ids summed by shuffles (on an
//     H100 the window with plain shared atomics ran no faster than the
//     global ones, the combine 15 % faster); a block whose span does not
//     fit adds them straight to the global forces;
//   - flush: the window's 3 n floats are one contiguous run of the (N, 3)
//     forces, so the block adds them with 16-byte global atomics on the
//     aligned groups of 4 floats that hold a nonzero value, whatever the
//     atom boundaries (scalar atomics at the buffer's end);
//   - energies reduce with warp shuffles into f64 per-block partials; the
//     first warp of the last block to finish (a ticket after
//     __threadfence) sums them per family in a fixed order, so the
//     energies are deterministic and no finishing launch is needed; it
//     resets the ticket for the next call.
// The forces are the zeroed buffer of the call (a memset and the kernel:
// two device events) or the caller's buffer, added into (the kernel only).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 256;  // rows (threads) of a block at most
constexpr int TAIL_LOADS = 12;  // per lane of the energy tail: 384 blocks at once
constexpr int MAXFAM = 8;
constexpr float TWO_PI = 6.283185307179586f;

}  // namespace

// Must match BondedCfg in torchmd_tpu_torch/ops/bonded.py field by field.
struct BondedCfg {
  int natoms;
  int nfam;
  int rows;                     // rows (threads) per block, <= MAX_ROWS
  int wcap;                     // atoms of the shared window buffer
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

// Where a block's rows add their contributions: its shared window (atoms
// lo, lo + 1, ...) or, for a block whose window does not fit, the global
// forces.
struct Sink {
  float* win;
  float* forces;
  int lo;
  bool shared;

  __device__ __forceinline__ void add(int a, V3 v) const {
    if (shared) {
      // the lanes of a warp that add to one atom first sum their values
      // (a tree over each group of equal atom ids), and the group's first
      // lane adds the sum: the shared float atomics, a compare-and-swap
      // loop that equal addresses serialise, were the limit
      const unsigned act = __activemask();
      const unsigned group = __match_any_sync(act, a);
      const int lane = threadIdx.x & 31;
      int rel = __popc(group & ((1u << lane) - 1u));
      unsigned peers = group & (0xfffffffeu << lane);
      while (__any_sync(act, peers)) {
        const int src = (__ffs(peers) - 1) & 31;
        const float x = __shfl_sync(act, v.x, src), y = __shfl_sync(act, v.y, src),
                    z = __shfl_sync(act, v.z, src);
        if (peers) v = V3{v.x + x, v.y + y, v.z + z};
        peers &= __ballot_sync(act, !(rel & 1));
        rel >>= 1;
      }
      if (__ffs(group) - 1 != lane) return;
      float* p = win + 3 * (a - lo);
      atomicAdd(p, v.x);
      atomicAdd(p + 1, v.y);
      atomicAdd(p + 2, v.z);
    } else {
      atomicAdd(forces + 3 * a, v.x);
      atomicAdd(forces + 3 * a + 1, v.y);
      atomicAdd(forces + 3 * a + 2, v.z);
    }
  }
};

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
__global__ void __launch_bounds__(MAX_ROWS)
bonded_kernel(const float* __restrict__ pos, const int4* __restrict__ idx,
              const float* __restrict__ par, const float* __restrict__ box,
              const int2* __restrict__ windows, const __grid_constant__ BondedCfg cfg,
              float* __restrict__ forces, double* __restrict__ epart,
              unsigned* __restrict__ ticket, float* __restrict__ energies,
              unsigned long long* __restrict__ stats) {
  extern __shared__ float window_smem[];  // 3 x cfg.wcap floats
  __shared__ double scratch[MAX_ROWS / 32];
  __shared__ int s_flushed;
  __shared__ bool s_last;
  int fam = 0;
  while (fam + 1 < cfg.nfam && (int)blockIdx.x >= cfg.block_start[fam + 1]) ++fam;
  const int kind = cfg.kind[fam];
  const int flags = cfg.flags[fam];
  const int tid = threadIdx.x;
  const int2 win = windows[blockIdx.x];  // lo, atoms
  const Sink sink{window_smem, forces, win.x, win.y <= cfg.wcap};
  if (sink.shared)
    for (int k = tid; k < 3 * win.y; k += blockDim.x) window_smem[k] = 0.f;
  if (tid == 0) s_flushed = 0;
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + tid;
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
    sink.add(ix.x, neg(f));
    sink.add(ix.y, f);
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
    sink.add(ix.x, f0);
    sink.add(ix.y, neg(add(f0, f2)));
    sink.add(ix.z, f2);
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
    sink.add(ix.x, neg(f0));
    sink.add(ix.y, add(f0, s));
    sink.add(ix.z, add(f3, neg(s)));
    sink.add(ix.w, neg(f3));
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
      sink.add(a, neg(f));
      sink.add(b, f);
    }
  }

  // flush: the window is the float run [3 lo, 3 (lo + n)) of the forces
  __syncthreads();
  if (sink.shared) {
    const int f0 = 3 * win.x, f1 = 3 * (win.x + win.y), total = 3 * cfg.natoms;
    int flushed = 0;
    for (int g = (f0 >> 2) + tid; g <= (f1 - 1) >> 2; g += blockDim.x) {
      float v[4];
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * g + j;
        v[j] = f >= f0 && f < f1 ? window_smem[f - f0] : 0.f;
        any |= v[j] != 0.f;
      }
      if (!any) continue;
      if (4 * g + 3 < total) {
        atomicAdd(reinterpret_cast<float4*>(forces + 4 * g), make_float4(v[0], v[1], v[2], v[3]));
        ++flushed;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v[j] != 0.f) {
            atomicAdd(forces + 4 * g + j, v[j]);
            ++flushed;
          }
      }
    }
    if (flushed) atomicAdd(&s_flushed, flushed);
  }
  const int nvalid = __syncthreads_count(valid);
  const double bm = block_sum((double)e_main, scratch);
  const double ba = block_sum((double)e_aux, scratch);
  if (tid == 0) {
    epart[2 * blockIdx.x] = bm;
    epart[2 * blockIdx.x + 1] = ba;
    if (stats != nullptr) {
      // global atomics, rows summed in a window and straight to the forces,
      // blocks of each kind
      typedef unsigned long long u64;
      const int arity = kind == 1 ? 3 : kind == 2 ? 4 : 2;  // atoms per row
      atomicAdd(stats, sink.shared ? (u64)s_flushed : (u64)3 * arity * nvalid);
      atomicAdd(stats + (sink.shared ? 1 : 2), (u64)nvalid);
      atomicAdd(stats + (sink.shared ? 3 : 4), (u64)1);
    }
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || tid >= 32) return;
  // the last block's first warp: lane l loads the partials of blocks l,
  // l + 32, ... at once (one round trip to L2 for up to 32 TAIL_LOADS
  // blocks), sums each family's in block order, then a fixed shuffle tree
  __threadfence();
  double ea[TAIL_LOADS], eb[TAIL_LOADS];
#pragma unroll
  for (int k = 0; k < TAIL_LOADS; ++k) {
    const int p = tid + 32 * k;
    ea[k] = p < (int)gridDim.x ? __ldcg(epart + 2 * p) : 0.0;
    eb[k] = p < (int)gridDim.x ? __ldcg(epart + 2 * p + 1) : 0.0;
  }
  for (int f = 0; f < cfg.nfam; ++f) {
    const int p0 = cfg.block_start[f], p1 = cfg.block_start[f + 1];
    double a = 0.0, b = 0.0;
#pragma unroll
    for (int k = 0; k < TAIL_LOADS; ++k) {
      const int p = tid + 32 * k;
      if (p >= p0 && p < p1) {
        a += ea[k];
        b += eb[k];
      }
    }
    for (int p = tid + 32 * TAIL_LOADS; p < p1; p += 32) {  // larger plans
      if (p >= p0) {
        a += __ldcg(epart + 2 * p);
        b += __ldcg(epart + 2 * p + 1);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (tid == 0) {
      energies[2 * f] = (float)a;
      energies[2 * f + 1] = (float)b;
    }
  }
  if (tid == 0) *ticket = 0u;  // ready for the next call
}

}  // namespace

// pos (N,3) f32; idx (R,4) int32 with R = block_start[nfam] * rows rows,
// -1 in unused slots and padding rows; par (R,3) f32; box (3) or null (no
// PBC); windows (R / rows) int2 (first atom, atoms) of each block. Scratch
// epart (R / rows, 2) f64 and ticket (1) uint32, 0 between calls. Outputs:
// forces (N,3) f32, 16-byte aligned, zeroed here unless `add` (then the
// call adds into them), energies (nfam, 2) f32 as [main, 1-4
// electrostatics]; stats (5 uint64, or null) gains the global atomics, the
// rows summed in a window and straight to the forces, and the blocks of
// each kind. Returns cudaGetLastError().
extern "C" int tmd_bonded_energy_forces(const float* pos, const int32_t* idx,
                                        const float* par, const float* box,
                                        const int32_t* windows, BondedCfg cfg,
                                        double* epart, unsigned* ticket, float* forces,
                                        int add, float* energies,
                                        unsigned long long* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.rows < 32 || cfg.rows > MAX_ROWS || cfg.rows % 32 || cfg.wcap < 0 ||
      12 * (size_t)cfg.wcap > 48 * 1024 || reinterpret_cast<uintptr_t>(forces) % 16)
    return (int)cudaErrorInvalidValue;
  if (!add) {
    cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int nblocks = cfg.block_start[cfg.nfam];
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const int2* win = reinterpret_cast<const int2*>(windows);
  const size_t smem = 12 * (size_t)cfg.wcap;
  if (box != nullptr)
    bonded_kernel<true><<<nblocks, cfg.rows, smem, s>>>(pos, idx4, par, box, win, cfg, forces,
                                                        epart, ticket, energies, stats);
  else
    bonded_kernel<false><<<nblocks, cfg.rows, smem, s>>>(pos, idx4, par, box, win, cfg, forces,
                                                         epart, ticket, energies, stats);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
