// PME charge spreading and ik force gathering on Hopper (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_pme.py, pme_spread (_spread_kernel) and
// pme_gather_ik (_gather_kernel). The TPU kernels contract dense per-axis
// tap rows on the matrix unit (bf16-split dots); here each thread owns one
// atom, computes its order-P cardinal B-spline weights per axis from its
// position (Cox-de Boor, tap t on grid point floor(u) - t mod K, u the
// scaled fractional coordinate), and touches its P^3 mesh points directly:
//   spread:  mesh[x,y,z] += q Mx My Mz        (atomicAdd, f32)
//   gather:  F_a = -q sum Mx My Mz dphi_a[x,y,z] over the three ik grids.
//
// What bounds them on this card: the 62,500-site water box at order 4 does
// 4.0 M mesh updates (spread) or 12 M grid reads (gather) on an 80^3 f32
// mesh of 2 MB per grid, which stays in the 50 MB L2. Device memory moves
// only the positions, charges, the mesh and the grids (~8 MB) and the work
// is ~1e8 FP32 operations, so both are bound by L2 atomics / L2 reads and
// launch latency, not by HBM or the ALUs. The design keeps them simple:
// one thread per atom, 256 atoms per block, the weights in registers
// (templated on P so the tap loops unroll). The spread's atomics make its
// sums run-order dependent in the last bits; the gather is deterministic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

}  // namespace

// Must match PmeCfg in torchmd_tpu_torch/ops/pme.py field by field.
struct PmeCfg {
  int natoms;
  int kx, ky, kz;
  int order;
};

namespace {

// Order-P spline weights of one axis and their wrapped grid indices. The
// scaled coordinate u = frac(x / L) * K runs to K (80 on the water box),
// where an f32 value carries ~4e-6 of rounding, which moves the weights by
// ~3e-6; u and its fractional part are therefore formed in f64 (three
// operations per axis), the weights in f32 from a fraction good to 6e-8.
template <int P>
__device__ __forceinline__ void axis_taps(float x, float L, int K, float* w, int* idx) {
  double u = (double)x / (double)L;
  u = (u - floor(u)) * (double)K;
  const double b = floor(u);
  const float frac = (float)(u - b);
  const int base = (int)b;
#pragma unroll
  for (int t = 0; t < P; ++t) {
    w[t] = fmaxf(0.f, 1.f - fabsf(frac + (float)t - 1.f));  // M_2
    idx[t] = ((base - t) % K + K) % K;
  }
#pragma unroll
  for (int k = 3; k <= P; ++k) {
    const float inv = 1.f / (float)(k - 1);
#pragma unroll
    for (int t = P - 1; t >= 0; --t) {
      const float ut = frac + (float)t;
      const float prev = t > 0 ? w[t - 1] : 0.f;
      w[t] = ut * inv * w[t] + ((float)k - ut) * inv * prev;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pme_spread_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                  const float* __restrict__ box, const PmeCfg cfg,
                  float* __restrict__ mesh) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= cfg.natoms) return;
  float wx[P], wy[P], wz[P];
  int ix[P], iy[P], iz[P];
  axis_taps<P>(pos[3 * i], box[0], cfg.kx, wx, ix);
  axis_taps<P>(pos[3 * i + 1], box[1], cfg.ky, wy, iy);
  axis_taps<P>(pos[3 * i + 2], box[2], cfg.kz, wz, iz);
  const float qi = q[i];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    const float qa = qi * wx[a];
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const float qab = qa * wy[b];
      float* row = mesh + ((size_t)ix[a] * cfg.ky + iy[b]) * cfg.kz;
#pragma unroll
      for (int c = 0; c < P; ++c) atomicAdd(row + iz[c], qab * wz[c]);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pme_gather_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                  const float* __restrict__ box, const PmeCfg cfg,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ gz, float* __restrict__ forces) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= cfg.natoms) return;
  float wx[P], wy[P], wz[P];
  int ix[P], iy[P], iz[P];
  axis_taps<P>(pos[3 * i], box[0], cfg.kx, wx, ix);
  axis_taps<P>(pos[3 * i + 1], box[1], cfg.ky, wy, iy);
  axis_taps<P>(pos[3 * i + 2], box[2], cfg.kz, wz, iz);
  const float qi = q[i];
  float fx = 0.f, fy = 0.f, fz = 0.f;
#pragma unroll
  for (int a = 0; a < P; ++a) {
    const float qa = qi * wx[a];
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const float qab = qa * wy[b];
      const size_t row = ((size_t)ix[a] * cfg.ky + iy[b]) * cfg.kz;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float w = qab * wz[c];
        const size_t g = row + iz[c];
        fx += w * __ldg(gx + g);
        fy += w * __ldg(gy + g);
        fz += w * __ldg(gz + g);
      }
    }
  }
  forces[3 * i] = -fx;
  forces[3 * i + 1] = -fy;
  forces[3 * i + 2] = -fz;
}

}  // namespace

// pos (N,3), q (N), box (3); mesh (kx,ky,kz), zeroed here, then spread.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an order other
// than 4 or 6).
extern "C" int tmd_pme_spread(const float* pos, const float* q, const float* box,
                              PmeCfg cfg, float* mesh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cells = (size_t)cfg.kx * cfg.ky * cfg.kz;
  cudaError_t err = cudaMemsetAsync(mesh, 0, sizeof(float) * cells, s);
  if (err != cudaSuccess) return (int)err;
  if (cfg.natoms == 0) return 0;
  const int blocks = (cfg.natoms + THREADS - 1) / THREADS;
  if (cfg.order == 4) pme_spread_kernel<4><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, mesh);
  else if (cfg.order == 6) pme_spread_kernel<6><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, mesh);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// pos (N,3), q (N), box (3), gx/gy/gz the (kx,ky,kz) ik derivative grids;
// forces (N,3). Returns cudaGetLastError().
extern "C" int tmd_pme_gather_ik(const float* pos, const float* q, const float* box,
                                 PmeCfg cfg, const float* gx, const float* gy,
                                 const float* gz, float* forces, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.natoms == 0) return 0;
  const int blocks = (cfg.natoms + THREADS - 1) / THREADS;
  if (cfg.order == 4) pme_gather_kernel<4><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, gx, gy, gz, forces);
  else if (cfg.order == 6) pme_gather_kernel<6><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, gx, gy, gz, forces);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
