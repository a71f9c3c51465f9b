// Staged probe of the dense pair kernel on Hopper (sm_90a), and
// dependent-chain kernels for elemental throughputs.
//
// Replaces: scripts/bench_roofline.py, stage_kernel (called through
// build_call's pl.pallas_call): a family of kernels with the dense pair
// kernel's work, each adding one stage of its computation, so that the
// differences of their times say what each stage costs:
//   0 load    mask tile and i/j rows, the energy counts the mask
//   1 d2      + displacement and squared distance (d2 = 1 off the mask)
//   2 rsqrt   + rsqrt(d2)
//   3 math    + LJ with the switch and reaction-field Coulomb (energy)
//   4 g       + g = (dE/dr)/r (consumed as one sum, no force sums)
//   5 forces  + the per-row force sums (the production kernel's work)
//   6 mxred   forces through sum_j g dx = x_i sum_j g - sum_j g x_j (no
//             box), the two sums as one product on the tensor cores: the
//             TPU probe's question (its jnp.dot(g, Rj)) asked of Hopper
// Every pair of the (npad, npad) square is computed and masked, branch
// free, as in the Pallas kernel: the stages measure the dense op mix, not
// a cutoff walk. Rows: x, y, z, q, sigma, eps of npad atoms (i and j are
// the same rows); mask (npad, npad) int8.
//
// Layout. A prep pass packs the rows per 128-column chunk, (x, y, z, q)
// as float4 and (sigma, eps) as float2, with a pad slot every 16 rows so
// that the four column groups a warp reads at once sit in four banks; for
// mxred it also writes B of the product below in its fragment order. It
// zeroes the outputs. The stage kernel runs a persistent grid (the SM
// count times the blocks that fit on one SM). The work units (a block of
// 64 i rows, a chunk of 128 j columns) are taken in i-block order, and
// each block takes a contiguous share of their 64-column halves, so that
// shares differ by at most one half and a block flushes its rows' forces
// only when its i block changes. Each unit's mask tile (64 x 128 bytes,
// 16-byte pieces swizzled by row parity) and packed j rows are copied
// with cp.async into a two-deep ring in shared memory while the previous
// unit computes. A warp owns 16 i rows; its lane (g = lane / 4, t = lane
// % 4) holds rows g and g + 8 (R_I = 2, their i-only terms hoisted) and,
// of each 64-column half, the 16 columns 16t..16t+15: one 16-byte mask
// load a row, and each j row read from shared memory (two vector loads)
// serves two pairs. Two rows a thread rather than four keep the math
// stages within the 102 registers that five blocks an SM allow
// (MIN_BLOCKS); four rows a thread at four blocks ran slower on the H100.
//
// mxred on the tensor cores: the lane computes g of exactly the pairs
// that the A fragment of mma.sync m16n8k8 (row.col, tf32 inputs, f32
// accumulation) asks of it: rows (g, g + 8) of a 16-row tile, k = t and
// t + 4 standing for columns 16t + 2s and 16t + 2s + 1 of k-step s. No
// shuffle is needed. wgmma m64n8k8 (A from registers in the same layout
// per warp, B from shared memory) was not taken: its registers must be
// waited for before reuse, and with that wait at each k-step it ran no
// faster on the H100 than mma.sync, whose B is two registers a lane. B
// is the 8 x 8 column tile (x_hi, x_lo, y_hi, y_lo, z_hi, z_lo, 1, 0) of
// the coordinates less the chunk's centre c (the middle of its bounding box, which halves |x_j -
// c| in a random order and shrinks it in a sorted one), each split into
// TF32 hi + lo (round to nearest). Two products, A = g_hi and A = g_lo,
// then give all four of hi.hi, hi.lo, lo.hi and lo.lo in one accumulator,
// whose columns (2t, 2t + 1) lane t adds into S_x, S_y, S_z (t < 3) or
// holds S_1 = sum_j g (t = 3). Every column sees the same g_hi + g_lo, so
// the rounding of g cancels in the identity; what remains is the
// coordinates' lo rounding (2^-22 of |x_j - c|) and the accumulator's.
// Each chunk's product starts at zero; lane t < 3 adds S_t - (x_i,t -
// c_t) S_1, with S_1 shuffled from lane 3, to its row's f64 total.
//
// What bounds it on this card: FP32 issue over npad^2 pairs (~70
// instructions a pair in the math stages); the only O(N^2) bytes are the
// mask's. Energies sum per thread in f32, per block in f64, across blocks
// with one double atomicAdd; the last block to finish writes the f32
// result. Forces meet in float atomicAdd, once a row per i-block range.
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
// width CUTOFF - SWITCH rounded once, as the Pallas kernel's jnp math
// does; the switch multiplies by the width's reciprocal, as pair_terms.cuh
constexpr float CUT2 = 53.29f, SWITCH = 6.0f, WIDTH = 1.3f, INV_WIDTH = 1.f / WIDTH;
constexpr float KRF = 0.0005f, CRF = 0.2f;
constexpr float ELEC = 332.0637f;
constexpr int THREADS = 128;          // 4 warps
constexpr int MIN_BLOCKS = 5;         // blocks an SM must hold (caps registers at 102)
constexpr int WARP_ROWS = 16;         // i rows of a warp: one 16-row MMA tile
constexpr int R_I = 2;                // i rows of a thread
constexpr int BI = THREADS / 32 * WARP_ROWS;  // i rows of a work unit
constexpr int JC = 128;               // j columns of a work unit
constexpr int GROUPS = JC / 64;       // 64-column groups of a unit: the split's grain
constexpr int P_SLOTS = JC + JC / 16;         // float4 slots of a chunk (a pad every 16)
constexpr int CENTRE_SLOT = 16;               // the first pad: the chunk's centre
constexpr int S_SLOTS = JC + 2 * (JC / 16);   // float2 slots (two pads every 16)
constexpr int F_SLOTS = 2 * 8 * 32;           // float2 B fragments of a chunk
constexpr int MASK_BYTES = BI * JC;
constexpr int BUF_BYTES = MASK_BYTES + 16 * P_SLOTS + 8 * S_SLOTS;
constexpr int BUF_BYTES_MX = BUF_BYTES + 8 * F_SLOTS;
constexpr int MIN_TILE = 128, MAX_TILE = 1024;
constexpr int UNROLL = 64;
constexpr int MAX_DEVICES = 16;

__device__ __forceinline__ int slot_p(int j) { return j + (j >> 4); }
__device__ __forceinline__ int slot_s(int j) { return j + 2 * (j >> 4); }

// v rounded to TF32, to nearest with ties away from zero, on its bits:
// cvt.rna.tf32.f32 for finite v in two integer operations (ptxas expands
// the cvt into four) and ops.roofline.tf32_round's arithmetic
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// c += a (16 x 8, row) . b (8 x 8, col), tf32 inputs, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// One i row of a thread: its packed values, i-only terms hoisted.
struct IRow {
  float x, y, z, qe, s, e4;  // qe = ELEC q_i, e4 = 4 eps_i
  float xt;                  // mxred: coordinate t (lane % 4 < 3) of the row
};

// Pair (i, j) of stage STAGE (1..6, masked by m): adds its energy term to
// e and returns g (0 off the mask and beyond the cutoff); dx, dy, dz out.
template <int STAGE>
__device__ __forceinline__ float pair(const IRow& a, const float4& pj, const float2& sj, bool m,
                                      float& e, float& dx, float& dy, float& dz) {
  dx = a.x - pj.x;
  dy = a.y - pj.y;
  dz = a.z - pj.z;
  float d2 = dx * dx + dy * dy + dz * dz;
  d2 = m ? d2 : 1.f;
  if (STAGE == 1) {
    e += m ? d2 : 0.f;
    return 0.f;
  }
  const float rinv = rsqrtf(d2);
  if (STAGE == 2) {
    e += m ? rinv : 0.f;
    return 0.f;
  }
  const bool in = m && d2 <= CUT2;
  const float dist = d2 * rinv;
  const float sig = a.s + sj.x;
  const float s2 = sig * sig;
  const float s6 = s2 * s2 * s2;
  const float B = a.e4 * sj.y * s6;
  const float A = B * s6;
  const float rinv2 = rinv * rinv;
  const float rinv6 = rinv2 * rinv2 * rinv2;
  const float rinv12 = rinv6 * rinv6;
  float pot = A * rinv12 - B * rinv6;
  float dEdr = (-12.f * A * rinv12 + 6.f * B * rinv6) * rinv;
  const float t = (dist - SWITCH) * INV_WIDTH;
  const float sw = 1.f + t * t * t * (-10.f + t * (15.f - t * 6.f));
  const float dsw = t * t * (-30.f + t * (60.f - t * 30.f)) * INV_WIDTH;
  const bool in_sw = dist > SWITCH;
  dEdr = in_sw ? dEdr * sw + pot * dsw : dEdr;
  pot = in_sw ? pot * sw : pot;
  const float qq = a.qe * pj.w;
  const float pot_el = qq * (rinv + KRF * d2 - CRF);
  const float dEdr_el = qq * (2.f * KRF - rinv2 * rinv);
  e += in ? 0.5f * (pot + pot_el) : 0.f;
  const float g = in ? dEdr * rinv + dEdr_el : 0.f;
  if (STAGE == 4) e += g;
  return g;
}

__device__ __forceinline__ bool mask_byte(uint32_t w, int b) { return (w >> (8 * b)) & 0xffu; }

// Copies work unit u (i block u / nc, j chunk u % nc) into a ring buffer.
template <int STAGE>
__device__ __forceinline__ void issue_unit(unsigned char* buf, int u, int nc, int npad,
                                           const int8_t* __restrict__ mask,
                                           const float4* __restrict__ P,
                                           const float2* __restrict__ S,
                                           const float2* __restrict__ F) {
  const int ib = u / nc, c = u - ib * nc;
  const int8_t* mbase = mask + (size_t)ib * BI * npad + (size_t)c * JC;
#pragma unroll
  for (int k = 0; k < MASK_BYTES / 16 / THREADS; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int r = idx >> 3, v = idx & 7;
    cp_async16(buf + r * JC + 16 * (v ^ ((r & 1) << 2)), mbase + (size_t)r * npad + 16 * v);
  }
  unsigned char* pbuf = buf + MASK_BYTES;
  const float4* psrc = P + (size_t)c * P_SLOTS;
  for (int k = threadIdx.x; k < P_SLOTS; k += THREADS) cp_async16(pbuf + 16 * k, psrc + k);
  unsigned char* sbuf = pbuf + 16 * P_SLOTS;
  const float2* ssrc = S + (size_t)c * S_SLOTS;
  for (int k = threadIdx.x; k < S_SLOTS / 2; k += THREADS) cp_async16(sbuf + 16 * k, ssrc + 2 * k);
  if (STAGE == 6) {
    unsigned char* fbuf = sbuf + 8 * S_SLOTS;
    const float2* fsrc = F + (size_t)c * F_SLOTS;
    for (int k = threadIdx.x; k < F_SLOTS / 2; k += THREADS) cp_async16(fbuf + 16 * k, fsrc + 2 * k);
  }
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stage_kernel(const float4* __restrict__ P, const float2* __restrict__ S,
             const float2* __restrict__ F, const int8_t* __restrict__ mask, int npad,
             float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ fz,
             double* __restrict__ acc, unsigned* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double scratch[THREADS / 32];
  constexpr int BUF = STAGE == 6 ? BUF_BYTES_MX : BUF_BYTES;
  const int nc = npad / JC;
  // this block's share of the (unit, 64-column group) sequence, and the
  // units it touches
  const int work = (npad / BI) * nc * GROUPS;
  const int w0 = (int)((long long)blockIdx.x * work / gridDim.x);
  const int w1 = (int)((long long)(blockIdx.x + 1) * work / gridDim.x);
  const int u0 = w0 / GROUPS, u1 = (w1 + GROUPS - 1) / GROUPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;

  IRow rows[R_I];
  float e = 0.f;
  float ax[R_I], ay[R_I], az[R_I];
  double tot[R_I];
#pragma unroll
  for (int r = 0; r < R_I; ++r) {
    ax[r] = ay[r] = az[r] = 0.f;
    tot[r] = 0.0;
  }
  int cur_ib = -1;

  issue_unit<STAGE>(smem, u0, nc, npad, mask, P, S, F);
  cp_async_commit();
  for (int u = u0; u < u1; ++u) {
    unsigned char* buf = smem + ((u - u0) & 1) * BUF;
    if (u + 1 < u1) issue_unit<STAGE>(smem + ((u + 1 - u0) & 1) * BUF, u + 1, nc, npad, mask, P, S, F);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ib = u / nc;
    if (STAGE > 0 && ib != cur_ib) {
      cur_ib = ib;
#pragma unroll
      for (int r = 0; r < R_I; ++r) {
        const int i = ib * BI + warp * WARP_ROWS + gr + 8 * r;
        const float4 p = P[slot_p(i)];
        const float2 s = S[slot_s(i)];
        rows[r] = IRow{p.x, p.y, p.z, ELEC * p.w, s.x, 4.f * s.y,
                       tq == 0 ? p.x : tq == 1 ? p.y : p.z};
      }
    }
    const uint32_t* mtile = reinterpret_cast<const uint32_t*>(buf);
    const float4* ps = reinterpret_cast<const float4*>(buf + MASK_BYTES);
    const float2* ss = reinterpret_cast<const float2*>(buf + MASK_BYTES + 16 * P_SLOTS);
    const float2* fs = reinterpret_cast<const float2*>(buf + MASK_BYTES + 16 * P_SLOTS + 8 * S_SLOTS);
    float cacc[4] = {0.f, 0.f, 0.f, 0.f};
    const int g_end = min(w1 - u * GROUPS, GROUPS);
#pragma unroll 1
    for (int gq = max(w0 - u * GROUPS, 0); gq < g_end; ++gq) {
      // this lane's 16 mask bytes of each of its rows: columns 16t..16t+15
      // of the group, the 16-byte piece swizzled by row parity
      uint32_t w[R_I][4];
#pragma unroll
      for (int r = 0; r < R_I; ++r) {
        const int row = warp * WARP_ROWS + gr + 8 * r;
        const uint4 v = *reinterpret_cast<const uint4*>(
            mtile + (row * JC + 16 * ((4 * gq + tq) ^ ((row & 1) << 2))) / 4);
        w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
      }
      const int jbase = 64 * gq + 16 * tq;
#pragma unroll 1
      for (int sp = 0; sp < 4; ++sp) {
        // k-steps s = 2 sp and 2 sp + 1: columns jbase + 2 s (k = t) and
        // jbase + 2 s + 1 (k = t + 4), mask bytes 0..3 of word w[r][0]
#pragma unroll
        for (int sb = 0; sb < 2; ++sb) {
          const int s = 2 * sp + sb;
          const int j = jbase + 2 * s;
          const float4 pa = ps[slot_p(j)], pb = ps[slot_p(j + 1)];
          const float2 sa = ss[slot_s(j)], sb2 = ss[slot_s(j + 1)];
          float gv[R_I][2];
#pragma unroll
          for (int r = 0; r < R_I; ++r) {
            const bool ma = mask_byte(w[r][0], 2 * sb), mb = mask_byte(w[r][0], 2 * sb + 1);
            if (STAGE == 0) {
              e += (ma ? 1.f : 0.f) + (mb ? 1.f : 0.f);
              continue;
            }
            float dxa, dya, dza, dxb, dyb, dzb;
            gv[r][0] = pair<STAGE>(rows[r], pa, sa, ma, e, dxa, dya, dza);
            gv[r][1] = pair<STAGE>(rows[r], pb, sb2, mb, e, dxb, dyb, dzb);
            if (STAGE == 5) {
              ax[r] -= gv[r][0] * dxa + gv[r][1] * dxb;
              ay[r] -= gv[r][0] * dya + gv[r][1] * dyb;
              az[r] -= gv[r][0] * dza + gv[r][1] * dzb;
            }
          }
          if (STAGE == 6) {
            // A: a0 (row g, k = t), a1 (row g + 8, k = t), a2 (row g,
            // k = t + 4), a3 (row g + 8, k = t + 4)
            const float2 b = fs[(8 * gq + s) * 32 + lane];
            const uint32_t b0 = __float_as_uint(b.x), b1 = __float_as_uint(b.y);
            const float g[4] = {gv[0][0], gv[1][0], gv[0][1], gv[1][1]};
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              hi[k] = tf32_rna(g[k]);
              lo[k] = __float_as_uint(g[k] - __uint_as_float(hi[k]));
            }
            mma_tf32(cacc, hi[0], hi[1], hi[2], hi[3], b0, b1);
            mma_tf32(cacc, lo[0], lo[1], lo[2], lo[3], b0, b1);
          }
        }
#pragma unroll
        for (int r = 0; r < R_I; ++r) {
          w[r][0] = w[r][1]; w[r][1] = w[r][2]; w[r][2] = w[r][3];
        }
      }
    }
    if (STAGE == 6) {
      // accumulator c0, c1 (row g) and c2, c3 (row g + 8) hold columns
      // 2t and 2t + 1
      const float4 cen = ps[CENTRE_SLOT];
      const double ct = tq == 0 ? cen.x : tq == 1 ? cen.y : cen.z;
#pragma unroll
      for (int r = 0; r < R_I; ++r) {
        const float c0 = cacc[2 * r], c1 = cacc[2 * r + 1];
        const double s1 = __shfl_sync(0xffffffffu, c0, lane | 3);
        tot[r] += ((double)c0 + (double)c1) - ((double)rows[r].xt - ct) * s1;
      }
    }
    if (STAGE >= 5 && (u + 1 == u1 || (u + 1) / nc != ib)) {
      const int i0 = ib * BI + warp * WARP_ROWS + gr;
#pragma unroll
      for (int r = 0; r < R_I; ++r) {
        float v = (float)tot[r];
        if (STAGE == 5) {
          float a[3] = {ax[r], ay[r], az[r]};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            a[k] += __shfl_xor_sync(0xffffffffu, a[k], 1);
            a[k] += __shfl_xor_sync(0xffffffffu, a[k], 2);
          }
          v = tq == 0 ? a[0] : tq == 1 ? a[1] : a[2];
        }
        if (tq < 3) atomicAdd((tq == 0 ? fx : tq == 1 ? fy : fz) + i0 + 8 * r, v);
        ax[r] = ay[r] = az[r] = 0.f;
        tot[r] = 0.0;
      }
    }
    __syncthreads();  // the buffer is refilled by the next unit's prefetch
  }
  const double b = block_sum((double)e, scratch);
  if (threadIdx.x == 0) {
    atomicAdd(acc, b);
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1)
      out[0] = (float)atomicAdd(acc, 0.0);
  }
}

// The prep pass, a block of JC threads a chunk: rows packed, the
// chunk's centre (the middle of its bounding box) in its CENTRE_SLOT,
// outputs and scratch zeroed; for mxred the chunk's B fragments, slot k
// (group k / 256, k-step (k / 32) % 8, lane k % 32) holding B[column][n]
// of its columns 16t + 2s and 16t + 2s + 1, n = lane / 4: coordinate n / 2
// less the centre, its TF32 hi (n even) or lo (n odd); 1 at n = 6, 0 at 7.
__global__ void __launch_bounds__(JC)
prep_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, const float* __restrict__ q,
            const float* __restrict__ s, const float* __restrict__ ep, int frags,
            float4* __restrict__ P, float2* __restrict__ S, float2* __restrict__ F,
            float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ fz,
            double* __restrict__ acc, unsigned* __restrict__ ticket) {
  __shared__ float box[6][JC / 32];
  __shared__ float cen[3];
  const int c = blockIdx.x, k = c * JC + threadIdx.x;
  const float r[3] = {x[k], y[k], z[k]};
  P[c * P_SLOTS + slot_p(threadIdx.x)] = make_float4(r[0], r[1], r[2], q[k]);
  S[c * S_SLOTS + slot_s(threadIdx.x)] = make_float2(s[k], ep[k]);
  fx[k] = fy[k] = fz[k] = 0.f;
  if (k == 0) {
    acc[0] = 0.0;
    ticket[0] = 0u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = r[a], hi = r[a];
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      box[a][warp] = lo;
      box[3 + a][warp] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float lo = box[threadIdx.x][0], hi = box[3 + threadIdx.x][0];
    for (int w = 1; w < JC / 32; ++w) {
      lo = fminf(lo, box[threadIdx.x][w]);
      hi = fmaxf(hi, box[3 + threadIdx.x][w]);
    }
    cen[threadIdx.x] = 0.5f * (lo + hi);
  }
  __syncthreads();
  if (threadIdx.x == 0) P[c * P_SLOTS + CENTRE_SLOT] = make_float4(cen[0], cen[1], cen[2], 0.f);
  if (!frags) return;
  for (int kk = threadIdx.x; kk < F_SLOTS; kk += JC) {
    const int gq = kk >> 8, st = (kk >> 5) & 7, ln = kk & 31;
    const int n = ln >> 2, t = ln & 3;
    const int j = c * JC + 64 * gq + 16 * t + 2 * st;
    float v[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (n >= 6) {
        v[a] = n == 6 ? 1.f : 0.f;
        continue;
      }
      const float d = (n < 2 ? x : n < 4 ? y : z)[j + a] - cen[n >> 1];
      const float hi = __uint_as_float(tf32_rna(d));
      v[a] = n & 1 ? __uint_as_float(tf32_rna(d - hi)) : hi;
    }
    F[c * F_SLOTS + kk] = make_float2(v[0], v[1]);
  }
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

// Persistent grid of stage STAGE: the SM count times the blocks that fit
// on one SM (queried once a device), at most one block a work unit.
template <int STAGE>
cudaError_t launch_stage(const float4* P, const float2* S, const float2* F, const int8_t* mask,
                         int npad, float* fx, float* fy, float* fz, double* acc,
                         unsigned* ticket, float* out, cudaStream_t st) {
  static int fit[MAX_DEVICES], sms[MAX_DEVICES];
  const int smem = 2 * (STAGE == 6 ? BUF_BYTES_MX : BUF_BYTES);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], stage_kernel<STAGE>,
                                                          THREADS, smem);
    if (err != cudaSuccess) return err;
    if (fit[dev] < 1) return cudaErrorInvalidConfiguration;
  }
  const int work = (npad / BI) * (npad / JC) * GROUPS;
  const int grid = work < fit[dev] * sms[dev] ? work : fit[dev] * sms[dev];
  stage_kernel<STAGE><<<grid, THREADS, smem, st>>>(P, S, F, mask, npad, fx, fy, fz, acc,
                                                   ticket, out);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the prep pass's scratch for npad rows: P (float4, pad slots
// included), S (float2) and F (mxred's B fragments, float2).
extern "C" long long tmd_roofline_scratch_bytes(int npad) {
  const long long chunks = npad / JC;
  return chunks * (16LL * P_SLOTS + 8LL * S_SLOTS + 8LL * F_SLOTS);
}

// One stage (0..6, above) on rows x/y/z/q/s/ep (npad) and mask (npad,
// npad) int8; tile a multiple of 128 up to 1024 dividing npad (it only
// sets the padding: the kernel's work units are 64 x 128). Scratch:
// `scratch` (tmd_roofline_scratch_bytes(npad), 16-byte aligned), acc (1)
// f64, ticket (1) u32. Outputs: fx/fy/fz (npad), zero below the forces
// stage; out (1) the stage's energy. Returns the first CUDA error.
extern "C" int tmd_roofline_stage(int stage, const float* x, const float* y, const float* z,
                                  const float* q, const float* s, const float* ep,
                                  const int8_t* mask, int npad, int tile, void* scratch,
                                  float* fx, float* fy, float* fz, double* acc,
                                  unsigned* ticket, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage < 0 || stage > 6 || tile < MIN_TILE || tile > MAX_TILE || tile % MIN_TILE != 0 ||
      npad % tile != 0 || (reinterpret_cast<uintptr_t>(mask) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t chunks = npad / JC;
  float4* P = static_cast<float4*>(scratch);
  float2* S = reinterpret_cast<float2*>(P + chunks * P_SLOTS);
  float2* F = S + chunks * S_SLOTS;
  prep_kernel<<<npad / JC, JC, 0, st>>>(x, y, z, q, s, ep, stage == 6, P, S, F, fx, fy, fz,
                                        acc, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (stage) {
    case 0: err = launch_stage<0>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    case 1: err = launch_stage<1>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    case 2: err = launch_stage<2>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    case 3: err = launch_stage<3>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    case 4: err = launch_stage<4>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    case 5: err = launch_stage<5>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st); break;
    default: err = launch_stage<6>(P, S, F, mask, npad, fx, fy, fz, acc, ticket, out, st);
  }
  return (int)err;
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
