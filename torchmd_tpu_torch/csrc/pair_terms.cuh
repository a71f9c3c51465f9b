// Per-pair nonbonded term math, shared by the dense pair kernel
// (nonbonded.cu) and the cell-list and column pair kernels (cell.cu,
// column.cu, through tile_pairs.cuh), plus the block reduction their
// finishing passes use.
//
// Counterpart of pair_terms in torchmd_tpu/ops/pallas_nonbonded.py: LJ
// with the polynomial switch, repulsion A/r^12 or repulsioncg B/r^6 (one
// of the three at a time), and Coulomb plain / reaction field / Ewald
// erfc. `Cfg` is the kernel's config struct; it carries the fields
// lj_kind, use_switch, switch_dist, inv_switch_width, krf, crf and
// ewald_alpha with the meanings of PairCfg in nonbonded.cu. The
// electrostatics kind (cfg.elec_kind: 0 none, 1 Coulomb, 2 reaction field,
// 3 Ewald erfc) is the template argument ELEC, so that a kernel instance
// carries the code of its own kind only (the host entries dispatch on it).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Lorentz-Berthelot A and B from rows that carry sigma/2 and sqrt|eps|:
// one add and one multiply of mixing per pair.
__device__ __forceinline__ void lb_coefficients(float si, float sj, float ei,
                                                float ej, float& A, float& B) {
  const float s = si + sj;
  const float s2 = s * s;
  const float s6 = s2 * s2 * s2;
  B = 4.f * (ei * ej) * s6;
  A = B * s6;
}

// Adds the pair's (unweighted) LJ-family energy to elj and electrostatic
// energy to eel, and returns g = (dE/dr) / r, so that the force on i is
// -g * (r_i - r_j). d2 is the squared distance (inside the cutoff), qq
// the charge product times the Coulomb constant.
template <int ELEC, class Cfg>
__device__ __forceinline__ float pair_terms(const Cfg& cfg, float d2, float A,
                                            float B, float qq, float& elj,
                                            float& eel) {
  const float rinv = rsqrtf(d2);
  const float dist = d2 * rinv;
  float g = 0.f;
  if (cfg.lj_kind != 0) {
    const float rinv2 = rinv * rinv;
    const float rinv6 = rinv2 * rinv2 * rinv2;
    const float rinv12 = rinv6 * rinv6;
    if (cfg.lj_kind == 1) {
      float pot = A * rinv12 - B * rinv6;
      float dEdr = (-12.f * A * rinv12 + 6.f * B * rinv6) * rinv;
      if (cfg.use_switch && dist > cfg.switch_dist) {
        const float u = (dist - cfg.switch_dist) * cfg.inv_switch_width;
        const float sw = 1.f + u * u * u * (-10.f + u * (15.f - u * 6.f));
        const float dsw = u * u * (-30.f + u * (60.f - u * 30.f)) * cfg.inv_switch_width;
        dEdr = dEdr * sw + pot * dsw;
        pot *= sw;
      }
      elj += pot;
      g += dEdr * rinv;
    } else if (cfg.lj_kind == 2) {
      elj += A * rinv12;
      g += -12.f * A * rinv12 * rinv2;
    } else {
      elj += B * rinv6;
      g += -6.f * B * rinv6 * rinv2;
    }
  }
  if (ELEC != 0) {
    if (ELEC == 3) {
      // erfc by Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7, the TPU
      // kernel's _erfc_approx): one exp(-x^2) serves the energy and the
      // force
      const float x = cfg.ewald_alpha * dist;
      const float ex2 = __expf(-x * x);
      const float t = __fdividef(1.f, 1.f + 0.3275911f * x);
      const float erfc_t =
          t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
          t * (-1.453152027f + t * 1.061405429f)))) * ex2;
      eel += qq * erfc_t * rinv;
      g += -qq * rinv * rinv *
           (erfc_t * rinv + (2.f * cfg.ewald_alpha * 0.5641895835477563f) * ex2);
    } else if (ELEC == 2) {
      eel += qq * (rinv + cfg.krf * d2 - cfg.crf);
      g += qq * (2.f * cfg.krf - rinv * rinv * rinv);
    } else {
      eel += qq * rinv;
      g += -qq * rinv * rinv * rinv;
    }
  }
  return g;
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) s += scratch[w];
  return s;
}
