// Staged probe of the dense pair kernel on Hopper (sm_90a), and
// dependent-chain kernels for elemental throughputs.
//
// Replaces: scripts/bench_roofline.py, stage_kernel (called through
// build_call's pl.pallas_call): a family of kernels with the dense pair
// kernel's geometry, each adding one stage of its computation, so that
// the differences of their times say what each stage costs:
//   0 load    mask tile and i/j rows, the energy counts the mask
//   1 d2      + displacement and squared distance (d2 = 1 off the mask)
//   2 rsqrt   + rsqrt(d2)
//   3 math    + LJ with the switch and reaction-field Coulomb (energy)
//   4 g       + g = (dE/dr)/r (consumed as one sum, no force sums)
//   5 forces  + the per-row force sums (the production kernel's work)
//   6 mxred   forces through sum_j g dx = x_i sum_j g - sum_j g x_j (no
//             box); on the TPU two f32 matrix products, here four f32 row
//             sums. The identity cancels: its rounding grows with |x| / r
//             (x up to 60 A), ~2e-5 of sum_j |g| r for rows whose nearest
//             partner is a fraction of an angstrom away
// Every pair of the (npad, npad) square is computed and masked, as in the
// Pallas kernel: the stages measure the dense op mix, not a cutoff walk.
// Rows: x, y, z, q, sigma, eps of npad atoms (i and j are the same rows);
// mask (npad, npad) int8.
//
// Layout: the Pallas grid of (tile, tile) blocks of the pair square, each
// split into blocks of I_ROWS i rows (one thread a row) that stage the j
// tile's rows in shared memory and read their mask rows 16 bytes at a
// time. Force partials of the j tiles meet in global atomicAdd; energies
// sum per thread in f32, per block in f64, across blocks with one double
// atomicAdd. What bounds the forces stage on this card: FP32 issue over
// npad^2 pairs; the only O(N^2) bytes are the mask's.
//
// The chain kernels run UNROLL x iters dependent steps of one operation
// (fma: c = c * c + 0.25; rsqrt: c = rsqrt(c + 1); exp: c = exp(-c) + 0.1
// with the pair kernels' __expf; div: c = 1 / (c + 1)) per thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace {

// bench_roofline.py's constants as f32 literals: CUTOFF^2 and the switch
// width CUTOFF - SWITCH rounded once, as the Pallas kernel's jnp math does
constexpr float CUT2 = 53.29f, SWITCH = 6.0f, WIDTH = 1.3f;
constexpr float KRF = 0.0005f, CRF = 0.2f;
constexpr float ELEC = 332.0637f;
constexpr int I_ROWS = 128;
constexpr int MAX_TILE = 1024;
constexpr int UNROLL = 64;

template <int STAGE>
__global__ void __launch_bounds__(I_ROWS)
stage_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, const float* __restrict__ q,
             const float* __restrict__ s, const float* __restrict__ ep,
             const int8_t* __restrict__ mask, int npad, int T, float* __restrict__ fx,
             float* __restrict__ fy, float* __restrict__ fz, double* __restrict__ acc) {
  extern __shared__ float rows[];
  __shared__ double scratch[I_ROWS / 32];
  float* sx = rows;
  float* sy = sx + T;
  float* sz = sy + T;
  float* sq = sz + T;
  float* ss = sq + T;
  float* se = ss + T;
  const int i = blockIdx.x * I_ROWS + threadIdx.x;
  const int j0 = blockIdx.y * T;  // this block's j tile
  const float xi = x[i], yi = y[i], zi = z[i], qi = q[i], si = s[i], ei = ep[i];
  const int8_t* mrow = mask + (size_t)i * npad;
  float e = 0.f;
  float ax = 0.f, ay = 0.f, az = 0.f;
  float sg = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  for (int k = threadIdx.x; k < T; k += I_ROWS) {
    const int j = j0 + k;
    sx[k] = x[j]; sy[k] = y[j]; sz[k] = z[j];
    sq[k] = q[j]; ss[k] = s[j]; se[k] = ep[j];
  }
  __syncthreads();
  for (int jb = 0; jb < T; jb += 16) {
    const int4 mv = __ldg(reinterpret_cast<const int4*>(mrow + j0 + jb));
    const int8_t* mb = reinterpret_cast<const int8_t*>(&mv);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = jb + u;
      const bool m = mb[u] != 0;
      const float fm = m ? 1.f : 0.f;
      if (STAGE == 0) { e += fm; continue; }
      const float dx = xi - sx[r], dy = yi - sy[r], dz = zi - sz[r];
      float d2 = dx * dx + dy * dy + dz * dz;
      d2 = m ? d2 : 1.f;
      if (STAGE == 1) { e += d2 * fm; continue; }
      const float rinv = rsqrtf(d2);
      if (STAGE == 2) { e += rinv * fm; continue; }
      const float fm2 = (m && d2 <= CUT2) ? 1.f : 0.f;
      const float dist = d2 * rinv;
      const float sig = si + ss[r];
      const float eps = ei * se[r];
      const float s2 = sig * sig;
      const float s6 = s2 * s2 * s2;
      const float B = 4.f * eps * s6;
      const float A = B * s6;
      const float rinv2 = rinv * rinv;
      const float rinv6 = rinv2 * rinv2 * rinv2;
      const float rinv12 = rinv6 * rinv6;
      float pot = A * rinv12 - B * rinv6;
      float dEdr = (-12.f * A * rinv12 + 6.f * B * rinv6) * rinv;
      const float t = (dist - SWITCH) / WIDTH;
      const float sw = 1.f + t * t * t * (-10.f + t * (15.f - t * 6.f));
      const float dsw = t * t * (-30.f + t * (60.f - t * 30.f)) / WIDTH;
      const bool in_sw = dist > SWITCH;
      dEdr = in_sw ? dEdr * sw + pot * dsw : dEdr;
      pot = in_sw ? pot * sw : pot;
      const float qq = ELEC * qi * sq[r];
      const float pot_el = qq * (rinv + KRF * d2 - CRF);
      const float dEdr_el = qq * (2.f * KRF - rinv * rinv * rinv);
      e += 0.5f * (pot + pot_el) * fm2;
      if (STAGE == 3) continue;
      const float g = (dEdr * rinv + dEdr_el) * fm2;
      if (STAGE == 4) { e += g; continue; }
      if (STAGE == 5) {
        ax -= g * dx; ay -= g * dy; az -= g * dz;
      } else {
        sg += g; gx += g * sx[r]; gy += g * sy[r]; gz += g * sz[r];
      }
    }
  }
  if (STAGE == 6) {
    ax = gx - xi * sg;
    ay = gy - yi * sg;
    az = gz - zi * sg;
  }
  if (STAGE >= 5) {
    atomicAdd(fx + i, ax);
    atomicAdd(fy + i, ay);
    atomicAdd(fz + i, az);
  }
  const double b = block_sum((double)e, scratch);
  if (threadIdx.x == 0) atomicAdd(acc, b);
}

__global__ void stage_finish(const double* __restrict__ acc, float* __restrict__ out) {
  out[0] = (float)acc[0];
}

template <int OP>
__global__ void chain_kernel(float* __restrict__ x, int n, int iters) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float c = x[k];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (OP == 0) c = c * c + 0.25f;
      else if (OP == 1) c = rsqrtf(c + 1.f);
      else if (OP == 2) c = __expf(-c) + 0.1f;
      else c = 1.f / (c + 1.f);
    }
  }
  x[k] = c;
}

template <int STAGE>
void launch_stage(const float* x, const float* y, const float* z, const float* q,
                  const float* s, const float* ep, const int8_t* mask, int npad, int tile,
                  float* fx, float* fy, float* fz, double* acc, cudaStream_t st) {
  const dim3 grid(npad / I_ROWS, npad / tile);
  stage_kernel<STAGE><<<grid, I_ROWS, 6 * sizeof(float) * tile, st>>>(
      x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc);
}

}  // namespace

// One stage (0..6, above) on rows x/y/z/q/s/ep (npad) and mask (npad,
// npad) int8; tile a multiple of I_ROWS up to 1024, npad a multiple of
// tile. Scratch: acc (1) f64. Outputs: fx/fy/fz (npad), zeroed first and
// zero below the forces stage; out (1) the stage's energy. Returns
// cudaGetLastError().
extern "C" int tmd_roofline_stage(int stage, const float* x, const float* y, const float* z,
                                  const float* q, const float* s, const float* ep,
                                  const int8_t* mask, int npad, int tile, float* fx,
                                  float* fy, float* fz, double* acc, float* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage < 0 || stage > 6 || tile < I_ROWS || tile > MAX_TILE || tile % I_ROWS != 0 ||
      npad % tile != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double), st);
  float* const f[3] = {fx, fy, fz};
  for (int k = 0; k < 3 && err == cudaSuccess; ++k)
    err = cudaMemsetAsync(f[k], 0, sizeof(float) * (size_t)npad, st);
  if (err != cudaSuccess) return (int)err;
  switch (stage) {
    case 0: launch_stage<0>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    case 1: launch_stage<1>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    case 2: launch_stage<2>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    case 3: launch_stage<3>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    case 4: launch_stage<4>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    case 5: launch_stage<5>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st); break;
    default: launch_stage<6>(x, y, z, q, s, ep, mask, npad, tile, fx, fy, fz, acc, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_finish<<<1, 1, 0, st>>>(acc, out);
  return (int)cudaGetLastError();
}

// op 0 fma, 1 rsqrt, 2 exp, 3 div: x (n) in place, UNROLL x iters steps.
extern "C" int tmd_roofline_chain(int op, float* x, int n, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  const int threads = 256, blocks = (n + threads - 1) / threads;
  switch (op) {
    case 0: chain_kernel<0><<<blocks, threads, 0, st>>>(x, n, iters); break;
    case 1: chain_kernel<1><<<blocks, threads, 0, st>>>(x, n, iters); break;
    case 2: chain_kernel<2><<<blocks, threads, 0, st>>>(x, n, iters); break;
    default: chain_kernel<3><<<blocks, threads, 0, st>>>(x, n, iters);
  }
  return (int)cudaGetLastError();
}

extern "C" int tmd_roofline_unroll() { return UNROLL; }

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
