// PME charge spreading and ik force gathering on Hopper (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_pme.py, pme_spread (_spread_kernel) and
// pme_gather_ik (_gather_kernel). The TPU kernels contract dense per-axis
// tap rows on the matrix unit (bf16-split dots); here each atom's order-P
// cardinal B-spline weights per axis come from its position (Cox-de Boor,
// tap t on grid point floor(u) - t mod K, u the scaled fractional
// coordinate), and
//   spread:  mesh[x,y,z] += q Mx My Mz        (f32 atomics)
//   gather:  F_a = -q sum Mx My Mz dphi_a[x,y,z] over the three ik grids.
//
// What bounds them on this card: the 62,500-site water box at order 4
// makes 4.0 M mesh updates (spread) or 12 M grid reads (gather) on an 80^3
// f32 mesh of 2 MB per grid, which stays in the 50 MB L2. Device memory
// moves only the positions, charges, the mesh and the grids (~8 MB) and
// the work is ~1e8 FP32 operations, so both are bound by L2 atomics / L2
// reads and latency, not by HBM or the ALUs.
//
// The spread sums in shared memory first when it is given an order of the
// atoms in space (`order`: rows of atom ids, consecutive entries close in
// space, ids >= N padding; the water box passes its cell list's slots on
// NVT and its columns' i slots on NPT): a block takes a chunk of at most
// CHUNK entries of a row, skips padding and zero charges (a TIP4P oxygen
// carries none), lists the rest in entry order with their spline weights,
// and finds the mesh footprint of their taps, per axis relative to the
// first atom so that a footprint may wrap. If the footprint fits a brick
// of BRICK floats (an 11 A cell at order 4: ~15^3 points for ~140 charged
// atoms' 64 taps each), each thread owns (x, y) lines of the brick and
// adds, in list order, the taps of the listed atoms that reach its lines:
// plain shared-memory adds, no atomics (shared float atomics were the
// bottleneck: 0.0525 ms against 0.0304 on the full box, H100). The block
// then flushes the brick's nonzero points to the mesh with global atomics,
// 16 bytes of 4 z points each where Kz % 4 == 0, else one point each:
// ~0.25 M atomics on the full box instead of the 4.0 M of a thread per
// atom. A chunk whose footprint does not fit adds its taps straight to the
// mesh. Without an order (the dense-PME path) a thread takes one atom and
// adds its taps straight to the mesh, with no list: the brick needs atoms
// close in space, which the input order does not promise. Straight to the
// mesh, the lanes of a warp take atoms 8 apart, so that the sites of one
// molecule do not meet in one instruction. The caller's memset zeroes the
// mesh in the same stream. Blocks meet in the mesh's global atomics, so
// the spread's sums are run-order dependent in the last bits.
//
// The gather takes a thread an atom in the input order, reads its P^3
// taps of the three grids straight from L2 and writes its row: no
// atomics, so the forces are deterministic. A zero-charge atom (a TIP4P
// oxygen) gets its zero row without work. A block per chunk of the
// spread's order, loading the chunk's footprint of the three grids into
// shared memory once and summing each atom's taps there, ran 28-40 %
// slower on the 62,500-site box (an H100: each tap is reused only ~3.5
// times at order 4, and the block's list, brick load and sum phases run
// one after another at one block a cell), so the gather has no order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2 * THREADS;  // order entries of one spread block at most
constexpr int BRICK = 8192;         // floats of the shared brick (32 KB)
constexpr int MAX_K = 1024;         // mesh points per axis (10-bit offsets)
constexpr int MAX_LINES = BRICK / 4;  // (x, y) lines of a brick (z extent >= order >= 4)

}  // namespace

// Must match PmeCfg in torchmd_tpu_torch/ops/pme.py field by field.
struct PmeCfg {
  int natoms;
  int kx, ky, kz;
  int order;
  // the spread's order (none: the input order): rows x width entries,
  // each row cut into nsub chunks of ceil(width / nsub) <= CHUNK entries
  int rows, width, nsub;
};

namespace {

// The scaled coordinate u = frac(x / L) * K of one axis runs to K (80 on
// the water box), where an f32 value carries ~4e-6 of rounding, which
// moves the weights by ~3e-6; u and its fractional part are therefore
// formed in f64 (three operations per axis), the weights in f32 from a
// fraction good to 6e-8. Gives floor(u) mod K and the fraction.
__device__ __forceinline__ int axis_base(float x, float L, int K, float& frac) {
  double u = (double)x / (double)L;
  u = (u - floor(u)) * (double)K;
  const double b = floor(u);
  frac = (float)(u - b);
  const int base = (int)b;
  return base >= K ? base - K : base;
}

// Order-P weights w[t] = M_P(frac + t), t = 0..P-1.
template <int P>
__device__ __forceinline__ void spline_weights(float frac, float* w) {
#pragma unroll
  for (int t = 0; t < P; ++t) w[t] = fmaxf(0.f, 1.f - fabsf(frac + (float)t - 1.f));  // M_2
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

// Order-P spline weights of one axis and their wrapped grid indices.
template <int P>
__device__ __forceinline__ void axis_taps(float x, float L, int K, float* w, int* idx) {
  float frac;
  const int base = axis_base(x, L, K, frac);
#pragma unroll
  for (int t = 0; t < P; ++t) idx[t] = ((base - t) % K + K) % K;
  spline_weights<P>(frac, w);
}

// b - ref wrapped into [-K/2, K/2): a footprint offset that may cross the
// periodic edge.
__device__ __forceinline__ int wrapped_offset(int b, int ref, int K) {
  int m = b - ref;
  if (m < 0) m += K;
  return 2 * m < K ? m : m - K;
}

// Atom of entry e (< cfg.width) of a row of the order, or N for padding.
__device__ __forceinline__ int entry_atom(const int* __restrict__ order, const PmeCfg& cfg,
                                          int row, int e) {
  const int a = order[(size_t)row * cfg.width + e];
  return (a >= 0 && a < cfg.natoms) ? a : cfg.natoms;
}

// Adds one atom's P^3 taps straight to the mesh: b its base point per
// axis (floor(u) mod K), w its 3 P weights, the charge folded into the x
// ones.
template <int P>
__device__ __forceinline__ void spread_atom(const int* b, const float* w, const int* K,
                                            float* __restrict__ mesh) {
  int ix[P], iy[P], iz[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    ix[t] = b[0] - t < 0 ? b[0] - t + K[0] : b[0] - t;
    iy[t] = b[1] - t < 0 ? b[1] - t + K[1] : b[1] - t;
    iz[t] = b[2] - t < 0 ? b[2] - t + K[2] : b[2] - t;
  }
#pragma unroll
  for (int ta = 0; ta < P; ++ta) {
#pragma unroll
    for (int tb = 0; tb < P; ++tb) {
      const float wab = w[ta] * w[P + tb];
      float* line = mesh + ((size_t)ix[ta] * K[1] + iy[tb]) * K[2];
#pragma unroll
      for (int tc = 0; tc < P; ++tc) atomicAdd(line + iz[tc], wab * w[2 * P + tc]);
    }
  }
}

// Dynamic shared memory of a spread block: the brick, per listed atom its
// packed brick or offset coordinates and its 3 P weights, the count and
// then the end of each (x, y) line's atoms, and the atoms by line.
template <int P>
constexpr size_t spread_smem_bytes() {
  return sizeof(float) * (BRICK + CHUNK + (size_t)CHUNK * 3 * P + MAX_LINES + CHUNK);
}

// In-place exclusive prefix sum of a[0..n) over the block (wsum: one int
// per warp); ends with the block in step.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = (n + THREADS - 1) / THREADS;
  const int s0 = min(n, tid * seg), s1 = min(n, s0 + seg);
  int sum = 0;
  for (int k = s0; k < s1; ++k) sum += a[k];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int k = s0; k < s1; ++k) {
    const int v = a[k];
    a[k] = run;
    run += v;
  }
  __syncthreads();
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pme_spread_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                  const float* __restrict__ box, const int* __restrict__ order,
                  const __grid_constant__ PmeCfg cfg, float* __restrict__ mesh,
                  unsigned long long* __restrict__ stats) {
  extern __shared__ float4 spread_smem[];
  float* brick = reinterpret_cast<float*>(spread_smem);      // BRICK
  int* rec_l = reinterpret_cast<int*>(brick + BRICK);         // CHUNK
  float* rec_w = reinterpret_cast<float*>(rec_l + CHUNK);     // CHUNK x 3P
  int* bins = reinterpret_cast<int*>(rec_w + CHUNK * 3 * P);  // MAX_LINES
  int* sorted = bins + MAX_LINES;                             // CHUNK
  constexpr int NW = THREADS / 32;
  __shared__ int s_first, s_flushed, s_lo[3], s_hi[3], s_ref[3], s_warp[2][NW], s_scan[NW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / cfg.nsub, sub = blockIdx.x % cfg.nsub;
  const int len = (cfg.width + cfg.nsub - 1) / cfg.nsub;
  const int e0 = sub * len, e1 = min(cfg.width, e0 + len);
  const int K[3] = {cfg.kx, cfg.ky, cfg.kz};
  const float L[3] = {box[0], box[1], box[2]};
  if (tid == 0) {
    s_first = INT_MAX;
    s_flushed = 0;
  }
  if (tid < 3) {
    s_lo[tid] = INT_MAX;
    s_hi[tid] = INT_MIN;
  }
  __syncthreads();
  // the chunk's charged atoms, their bases and fractions; the first of them
  int atom[2], base[2][3];
  float frac[2][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = e0 + tid + k * THREADS;
    atom[k] = e < e1 ? entry_atom(order, cfg, row, e) : cfg.natoms;
    if (atom[k] < cfg.natoms && __ldg(q + atom[k]) == 0.f) atom[k] = cfg.natoms;
    if (atom[k] < cfg.natoms) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        base[k][a] = axis_base(pos[3 * atom[k] + a], L[a], K[a], frac[k][a]);
      atomicMin(&s_first, e);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, atom[k] < cfg.natoms);
    if (lane == 0) s_warp[k][warp] = __popc(ballot);
  }
  __syncthreads();
  if (s_first == INT_MAX) return;  // nothing to spread
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (atom[k] < cfg.natoms && e0 + tid + k * THREADS == s_first)
      for (int a = 0; a < 3; ++a) s_ref[a] = base[k][a];
  __syncthreads();
  // the footprint of their bases around the first; the list of atoms in
  // entry order: offsets from the first (10 bits per axis) and weights
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool ok = atom[k] < cfg.natoms;
    int d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d[a] = ok ? wrapped_offset(base[k][a], s_ref[a], K[a]) : 0;
      const int lo = __reduce_min_sync(0xffffffffu, ok ? d[a] : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, ok ? d[a] : INT_MIN);
      if (lane == 0 && lo != INT_MAX) {
        atomicMin(&s_lo[a], lo);
        atomicMax(&s_hi[a], hi);
      }
    }
    int at = cnt;
    for (int w = 0; w < NW; ++w) {
      at += w < warp ? s_warp[k][w] : 0;
      cnt += s_warp[k][w];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int m = at + __popc(ballot & ((1u << lane) - 1u));
      rec_l[m] = (d[0] + 512) | ((d[1] + 512) << 10) | ((d[2] + 512) << 20);
      const float qi = __ldg(q + atom[k]);
      float* w = rec_w + (size_t)m * 3 * P;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float wa[P];
        spline_weights<P>(frac[k][a], wa);
#pragma unroll
        for (int t = 0; t < P; ++t) w[a * P + t] = a == 0 ? qi * wa[t] : wa[t];
      }
    }
  }
  __syncthreads();
  int ext[3], org[3];
  bool fits = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ext[a] = s_hi[a] - s_lo[a] + P;
    fits &= ext[a] <= K[a];
    org[a] = s_lo[a] - (P - 1);  // offset of the brick's first point
  }
  // an odd z stride: the threads of a warp own neighbouring lines, which
  // then start in distinct banks (an even one left up to 16 on a bank)
  const int zs = ext[2] | 1;
  const int vol = ext[0] * ext[1] * zs;
  fits &= vol <= BRICK;
  int flushed = 0;
  if (fits) {
    const int nlines = ext[0] * ext[1];
    // offsets -> brick coordinates of tap 0; a zeroed brick and line counts
    for (int m = tid; m < cnt; m += THREADS) {
      const int pk = rec_l[m];
      rec_l[m] = ((pk & 1023) - 512 - org[0]) | (((pk >> 10 & 1023) - 512 - org[1]) << 10) |
                 (((pk >> 20) - 512 - org[2]) << 20);
    }
    for (int k = tid; k < vol; k += THREADS) brick[k] = 0.f;
    for (int k = tid; k < nlines; k += THREADS) bins[k] = 0;
    __syncthreads();
    // the atoms by the (x, y) line of their tap 0: a counting sort
    for (int m = tid; m < cnt; m += THREADS)
      atomicAdd(&bins[(rec_l[m] & 1023) * ext[1] + (rec_l[m] >> 10 & 1023)], 1);
    __syncthreads();
    block_exclusive_scan(bins, nlines, s_scan);
    for (int m = tid; m < cnt; m += THREADS)
      sorted[atomicAdd(&bins[(rec_l[m] & 1023) * ext[1] + (rec_l[m] >> 10 & 1023)], 1)] = m;
    __syncthreads();
    // bins[b] now ends line b's atoms and bins[b - 1] starts them. Each
    // thread owns (x, y) lines of the brick and adds the taps of the atoms
    // of the P x P lines that reach it: plain adds, no atomics
    for (int line = tid; line < nlines; line += THREADS) {
      const int lx = line / ext[1], ly = line - lx * ext[1];
      float* zl = brick + line * zs - (P - 1);
      // one pass over the atoms of the lines (lx + ta, ly + tb), so that a
      // warp runs as many rounds as its busiest thread has atoms
      int ta = 0, tb = 0, b = lx * ext[1] + ly;
      int k = b == 0 ? 0 : bins[b - 1], end = bins[b];
      while (true) {
        if (k == end) {  // the next line's atoms
          if (++tb == P || ly + tb >= ext[1]) {
            tb = 0;
            if (++ta == P || lx + ta >= ext[0]) break;
          }
          b = (lx + ta) * ext[1] + ly + tb;
          k = bins[b - 1];
          end = bins[b];
          continue;
        }
        const int m = sorted[k++];
        const float* w = rec_w + (size_t)m * 3 * P;
        const float wab = w[ta] * w[P + tb];
        float* z = zl + (rec_l[m] >> 20);  // the atom's P points, tap P - 1 first
        float v[P];
#pragma unroll
        for (int t = 0; t < P; ++t) v[t] = z[t];
#pragma unroll
        for (int tc = 0; tc < P; ++tc) v[P - 1 - tc] += wab * w[2 * P + tc];
#pragma unroll
        for (int t = 0; t < P; ++t) z[t] = v[t];
      }
    }
    __syncthreads();
    int o[3];  // the brick's first mesh point
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = s_ref[a] + org[a];
      o[a] = o[a] < 0 ? o[a] + K[a] : (o[a] >= K[a] ? o[a] - K[a] : o[a]);
    }
    if (cfg.kz % 4 == 0) {
      // 16-byte atomics on aligned groups of 4 z points of a line (zeros
      // past the line's ends add nothing)
      const int g0 = o[2] >> 2, ng = ((o[2] + ext[2] - 1) >> 2) - g0 + 1;
      for (int item = tid; item < nlines * ng; item += THREADS) {
        const int line = item / ng, z4 = 4 * (g0 + item - line * ng);
        const int lx = line / ext[1], ly = line - lx * ext[1];
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lz = z4 + j - o[2];
          v[j] = lz >= 0 && lz < ext[2] ? brick[line * zs + lz] : 0.f;
        }
        if (v[0] == 0.f && v[1] == 0.f && v[2] == 0.f && v[3] == 0.f) continue;
        int gx = o[0] + lx, gy = o[1] + ly;
        gx -= gx >= cfg.kx ? cfg.kx : 0;
        gy -= gy >= cfg.ky ? cfg.ky : 0;
        const int gz = z4 >= cfg.kz ? z4 - cfg.kz : z4;
        atomicAdd(reinterpret_cast<float4*>(mesh + ((size_t)gx * cfg.ky + gy) * cfg.kz + gz),
                  make_float4(v[0], v[1], v[2], v[3]));
        ++flushed;
      }
    } else {
      const int plane = ext[1] * zs;
      for (int k = tid; k < vol; k += THREADS) {
        const float v = brick[k];
        if (v == 0.f) continue;  // the stride's padding too
        const int lx = k / plane, ly = (k - lx * plane) / zs, lz = k - lx * plane - ly * zs;
        int gx = o[0] + lx, gy = o[1] + ly, gz = o[2] + lz;
        gx -= gx >= cfg.kx ? cfg.kx : 0;
        gy -= gy >= cfg.ky ? cfg.ky : 0;
        gz -= gz >= cfg.kz ? cfg.kz : 0;
        atomicAdd(mesh + ((size_t)gx * cfg.ky + gy) * cfg.kz + gz, v);
        ++flushed;
      }
    }
  } else {
    // straight to the mesh; lane l of warp w takes atoms 8 l + w, ...
    for (int m = lane * NW + warp; m < cnt; m += THREADS) {
      const int pk = rec_l[m];
      int b[3] = {(pk & 1023) - 512, (pk >> 10 & 1023) - 512, (pk >> 20) - 512};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b[a] += s_ref[a];
        b[a] += b[a] < 0 ? K[a] : (b[a] >= K[a] ? -K[a] : 0);
      }
      spread_atom<P>(b, rec_w + (size_t)m * 3 * P, K, mesh);
    }
  }
  if (stats != nullptr) {
    // global atomic operations, brick chunks, direct chunks, charged atoms
    atomicAdd(&s_flushed, flushed);
    __syncthreads();
    if (tid == 0) {
      typedef unsigned long long u64;
      atomicAdd(stats, fits ? (u64)s_flushed : (u64)cnt * P * P * P);
      atomicAdd(stats + (fits ? 1 : 2), (u64)1);
      atomicAdd(stats + 3, (u64)cnt);
    }
  }
}

// The spread in the input order: a thread an atom, its taps straight to the
// mesh; lane l of warp w takes atom 8 l + w of the block's THREADS.
template <int P>
__global__ void __launch_bounds__(THREADS)
pme_spread_input_order(const float* __restrict__ pos, const float* __restrict__ q,
                       const float* __restrict__ box, const PmeCfg cfg,
                       float* __restrict__ mesh, unsigned long long* __restrict__ stats) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * THREADS + lane * NW + warp;
  const float qi = i < cfg.natoms ? __ldg(q + i) : 0.f;
  if (qi != 0.f) {
    const int K[3] = {cfg.kx, cfg.ky, cfg.kz};
    int b[3];
    float w[3 * P];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float frac;
      b[a] = axis_base(pos[3 * i + a], box[a], K[a], frac);
      spline_weights<P>(frac, w + a * P);
    }
#pragma unroll
    for (int t = 0; t < P; ++t) w[t] *= qi;
    spread_atom<P>(b, w, K, mesh);
  }
  if (stats != nullptr) {
    // as the order's kernel counts them: every block a direct chunk
    const int cnt = __syncthreads_count(qi != 0.f);
    if (threadIdx.x == 0) {
      typedef unsigned long long u64;
      atomicAdd(stats, (u64)cnt * P * P * P);
      atomicAdd(stats + 2, (u64)1);
      atomicAdd(stats + 3, (u64)cnt);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pme_gather_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                  const float* __restrict__ box, const PmeCfg cfg,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ gz, float* __restrict__ forces,
                  unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float qi = i < cfg.natoms ? q[i] : 0.f;
  if (stats != nullptr) {
    // charged atoms gathered, zero-charge atoms skipped
    const int charged = __syncthreads_count(qi != 0.f);
    const int atoms = __syncthreads_count(i < cfg.natoms);
    if (threadIdx.x == 0) {
      atomicAdd(stats, (unsigned long long)charged);
      atomicAdd(stats + 1, (unsigned long long)(atoms - charged));
    }
  }
  if (i >= cfg.natoms) return;
  if (qi == 0.f) {
    forces[3 * i] = forces[3 * i + 1] = forces[3 * i + 2] = 0.f;
    return;
  }
  float wx[P], wy[P], wz[P];
  int ix[P], iy[P], iz[P];
  axis_taps<P>(pos[3 * i], box[0], cfg.kx, wx, ix);
  axis_taps<P>(pos[3 * i + 1], box[1], cfg.ky, wy, iy);
  axis_taps<P>(pos[3 * i + 2], box[2], cfg.kz, wz, iz);
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

namespace {

template <int P>
cudaError_t launch_spread(int blocks, cudaStream_t s, const float* pos, const float* q,
                          const float* box, const int* order, const PmeCfg& cfg, float* mesh,
                          unsigned long long* stats) {
  static unsigned long long sized = 0;  // devices allowed beyond 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(sized >> dev & 1ull)) {
    err = cudaFuncSetAttribute(pme_spread_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)spread_smem_bytes<P>());
    if (err != cudaSuccess) return err;
    if (dev < 64) sized |= 1ull << dev;
  }
  pme_spread_kernel<P><<<blocks, THREADS, spread_smem_bytes<P>(), s>>>(pos, q, box, order, cfg,
                                                                      mesh, stats);
  return cudaGetLastError();
}

}  // namespace

// pos (N,3), q (N), box (3), order (rows, width) int32 atom ids, or null
// for the input order (rows, width and nsub unread); mesh (kx,ky,kz),
// zeroed here, then spread; stats (4 uint64, or null) gains the global
// atomics, the chunks summed in a brick and straight to the mesh, and the
// charged atoms spread. Returns cudaGetLastError() (cudaErrorInvalidValue
// for a spline order other than 4 or 6, or, with an order, chunks longer
// than CHUNK or more than MAX_K mesh points on an axis).
extern "C" int tmd_pme_spread(const float* pos, const float* q, const float* box,
                              const int* order, PmeCfg cfg, float* mesh,
                              unsigned long long* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cells = (size_t)cfg.kx * cfg.ky * cfg.kz;
  if ((cfg.order != 4 && cfg.order != 6) ||
      (order != nullptr && (cfg.nsub < 1 || (cfg.width + cfg.nsub - 1) / cfg.nsub > CHUNK ||
                            cfg.kx > MAX_K || cfg.ky > MAX_K || cfg.kz > MAX_K)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(mesh, 0, sizeof(float) * cells, s);
  if (err != cudaSuccess) return (int)err;
  if (cfg.natoms == 0) return 0;
  if (order == nullptr) {
    const int blocks = (cfg.natoms + THREADS - 1) / THREADS;
    if (cfg.order == 4) pme_spread_input_order<4><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, mesh, stats);
    else pme_spread_input_order<6><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, mesh, stats);
    return (int)cudaGetLastError();
  }
  if (cfg.rows == 0 || cfg.width == 0) return 0;
  const int blocks = cfg.rows * cfg.nsub;
  if (cfg.order == 4) err = launch_spread<4>(blocks, s, pos, q, box, order, cfg, mesh, stats);
  else err = launch_spread<6>(blocks, s, pos, q, box, order, cfg, mesh, stats);
  return (int)err;
}

// pos (N,3), q (N), box (3), gx/gy/gz the (kx,ky,kz) ik derivative grids;
// forces (N,3); stats (2 uint64, or null) gains the charged atoms gathered
// and the zero-charge atoms skipped. Returns cudaGetLastError().
extern "C" int tmd_pme_gather_ik(const float* pos, const float* q, const float* box,
                                 PmeCfg cfg, const float* gx, const float* gy,
                                 const float* gz, float* forces, unsigned long long* stats,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg.natoms == 0) return 0;
  const int blocks = (cfg.natoms + THREADS - 1) / THREADS;
  if (cfg.order == 4)
    pme_gather_kernel<4><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, gx, gy, gz, forces, stats);
  else if (cfg.order == 6)
    pme_gather_kernel<6><<<blocks, THREADS, 0, s>>>(pos, q, box, cfg, gx, gy, gz, forces, stats);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
