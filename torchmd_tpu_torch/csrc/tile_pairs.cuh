// Warp-per-tile pair walk shared by the cell-list kernel (cell.cu), the
// column kernel (column.cu) and the dense pair kernel (nonbonded.cu): the
// cluster-pair scheme of GROMACS and OpenMM with a per-lane queue in front
// of the pair math.
//
// An i tile is up to 32 atoms that sit close together (one per lane, data
// in registers), walked by NSPLIT warps of one block. They cull the same
// candidate j tiles of 32 packed slots (float4 x, y, z, q and float4
// sigma/2, sqrt|eps|, id bits, type bits, written by the kernel's prep
// pass), each with an image-shift code, and share the survivors out in
// turn:
//   - cull: a j tile whose bounding box (plus its shift) lies farther than
//     the cutoff from the i tile's box is skipped; the caller tests up to
//     32 boxes at once, one per lane, and walks the ballot's survivors;
//   - visit: warp s takes survivors s, s + NSPLIT, ... of the walk. The j
//     tile, shift added, is staged in the warp's shared memory and noted in
//     its visit list; each lane tests its atom against the 32 slots (a
//     broadcast float4 read, the distance and one compare) and appends
//     every slot inside the cutoff to its own ring in shared memory
//     (QDEPTH 16-bit entries of visit << 5 | slot, laid out [entry][lane]);
//   - drain: after each visit the warp runs rounds of the pair math, one
//     queued pair per lane per round, at least as many as the smallest
//     backlog among its atoms: those rounds keep every lane busy, where a
//     per-pair cutoff branch runs the full math for a warp with one lane
//     inside the cutoff. Rounds beyond the smallest backlog run only as far
//     as the next visit needs ring room. Callers walk neighbour cells or
//     columns in mirrored pairs (offset, then its opposite), and the
//     survivors alternate between the warps, so that the lanes' backlogs
//     grow alike and few rounds leave lanes idle.
// Each lane works through its own atom's pairs, so the i forces stay in
// registers. How the atoms meet is the WALK argument:
//   - StencilWalk (cell, column): the NSPLIT (= 2) warps add their forces
//     to the zeroed force rows with atomicAdd, and two additions onto zero
//     give the same bits in either order: forces are bitwise
//     deterministic. Exclusions are checked only for queued pairs (inside
//     the cutoff), against the lane's register copy of its atom's first
//     REG_EXCL entries; the pair math is branch-free (a self or excluded
//     pair runs with zero coefficients at d^2 = 1). StencilWalk<true> (the
//     cell kernel's NBFIX instances) reads A/B from the tables by type
//     pair, as the dense walk does.
//   - DenseWalk (dense): a warp walks a unit of candidates alone and calls
//     `take` for each survivor; no shifts; a per-pair minimum image on a
//     diagonal box (PBC; a 0 component does not wrap), which the cull
//     takes as the minimum-image gap of the two boxes; NBFIX A/B tables by
//     type; with no cutoff every slot is queued. Exclusions come per visit
//     as a 32-bit word per lane (bit k: slot k is excluded for this lane's
//     atom), applied when pairs are queued, so excluded pairs take no
//     round. The caller writes the warp's force rows.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pair_terms.cuh"

namespace tiles {

constexpr int TILE = 32;          // atoms per i or j tile: one per lane
constexpr int NSPLIT = 2;         // warps per i tile (block size NSPLIT x 32)
constexpr int QDEPTH = 128;       // per-lane ring: TILE of room after a drain
constexpr int MAX_VISITS = 128;   // visit-list entries (a full list drains)
constexpr int REG_EXCL = 8;       // exclusions held in registers
constexpr int CODE_SHIFT = 26;    // visit-list entry: shift code << 26 | slot
constexpr int SLOT_MASK = (1 << CODE_SHIFT) - 1;
constexpr int MAX_CODES = 27;
constexpr int NSTATS = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr float FAR = 1e18f;      // padding coordinate; empty-box bound

// Shared memory of one warp (9,648 bytes).
struct WarpSmem {
  float4 j[TILE];                        // the staged j tile, shift added
  float4 shift[MAX_CODES];               // image shift of each code
  int visits[MAX_VISITS];                // code << 26 | first slot per visit
  unsigned short queue[QDEPTH][TILE];    // the lanes' rings
};

// Bounding box of the active lanes' positions, in every lane.
__device__ __forceinline__ void warp_box(bool active, float x, float y, float z,
                                         float4& lo, float4& hi) {
  float lx = active ? x : FAR, ly = active ? y : FAR, lz = active ? z : FAR;
  float hx = active ? x : -FAR, hy = active ? y : -FAR, hz = active ? z : -FAR;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(FULL, lx, off));
    ly = fminf(ly, __shfl_xor_sync(FULL, ly, off));
    lz = fminf(lz, __shfl_xor_sync(FULL, lz, off));
    hx = fmaxf(hx, __shfl_xor_sync(FULL, hx, off));
    hy = fmaxf(hy, __shfl_xor_sync(FULL, hy, off));
    hz = fmaxf(hz, __shfl_xor_sync(FULL, hz, off));
  }
  lo = make_float4(lx, ly, lz, 0.f);
  hi = make_float4(hx, hy, hz, 0.f);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Counters of one call (`stats`, optional): candidate tile pairs, tile
// pairs visited, slot pairs visited (active i lanes x j slots), rounds of
// pair math, and lane-rounds that carried a queued pair.
// Per warp (lanes: per lane) they stay far below 2^32.
struct Counters {
  unsigned candidates = 0, tiles = 0, slots = 0, rounds = 0, lanes = 0;
};

// The cell and column kernels' walk: an image shift per visit, exclusions
// from a per-atom table (cfg.nexcl wide); NBFIX A/B tables by type or
// Lorentz-Berthelot rows.
template <bool NBFIX_ = false>
struct StencilWalk {
  static constexpr bool DENSE = false, PBC = false, NBFIX = NBFIX_, CUTOFF = true;
};

// The dense kernel's walk (nonbonded.cu): see the header note.
template <bool PBC_, bool NBFIX_, bool CUTOFF_>
struct DenseWalk {
  static constexpr bool DENSE = true, PBC = PBC_, NBFIX = NBFIX_, CUTOFF = CUTOFF_;
};

// Minimum image of d on a box edge b (inverse ib); b = 0: no wrap.
__device__ __forceinline__ float min_image(float d, float b, float ib) {
  return b > 0.f ? d - b * rintf(d * ib) : d;
}

// Lower bound of |x_i - x_j| over x_i in [il, ih], x_j in [jl, jh] along
// one axis, under the minimum image when b > 0. With a half-width sum h
// below b / 2 the wrapped centre distance less h is exact; otherwise the
// axis is not culled.
__device__ __forceinline__ float axis_gap(float il, float ih, float jl, float jh, float b,
                                          float ib) {
  if (b > 0.f) {
    const float h = 0.5f * ((ih - il) + (jh - jl));
    if (h >= 0.5f * b) return 0.f;
    const float c = min_image(0.5f * ((jl + jh) - (il + ih)), b, ib);
    return fmaxf(0.f, fabsf(c) - h);
  }
  return fmaxf(0.f, fmaxf(jl - ih, il - jh));
}

template <class Cfg, bool VIRIAL, int ELEC, class WALK = StencilWalk<>>
struct TileWarp {
  const Cfg& cfg;
  const float4* __restrict__ pq;
  const float4* __restrict__ aux;
  const int32_t* __restrict__ excl;
  WarpSmem& sm;
  int lane;
  int split;   // this warp's share of the survivors
  int seen = 0, nvis = 0;
  bool active;
  int nact;  // active lanes
  int i = -1;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, si = 0.f, ei = 0.f;
  int ex[REG_EXCL];
  float4 ilo, ihi;
  float cull2;
  // the lane's LJ type and the NBFIX tables (WALK::NBFIX), the box (DenseWalk)
  int ti = 0, ntypes = 0;
  const float* __restrict__ lja = nullptr;
  const float* __restrict__ ljb = nullptr;
  float bx = 0.f, by = 0.f, bz = 0.f, ibx = 0.f, iby = 0.f, ibz = 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  double elj = 0.0, eel = 0.0, wx = 0.0, wy = 0.0, wz = 0.0;
  int head = 0, tail = 0;
  Counters n;

  __device__ TileWarp(const Cfg& cfg_, const float4* pq_, const float4* aux_,
                      const int32_t* excl_, WarpSmem& sm_, bool active_, int i_,
                      float x, float y, float z, float q, float s, float e)
      : cfg(cfg_), pq(pq_), aux(aux_), excl(excl_), sm(sm_), active(active_) {
    lane = threadIdx.x & 31;
    split = threadIdx.x >> 5;
    nact = __popc(__ballot_sync(FULL, active));
    if (active) { i = i_; xi = x; yi = y; zi = z; qi = q; si = s; ei = e; }
    if constexpr (!WALK::DENSE) {
      const int ne = cfg.nexcl;
#pragma unroll
      for (int k = 0; k < REG_EXCL; ++k)
        ex[k] = (active && k < ne) ? excl[(size_t)i * ne + k] : -1;
      // culling keeps a relative margin over f32 rounding of the box gaps
      cull2 = cfg.cutoff2 * 1.00001f;
    } else {
      // and an absolute one over the rounding of the minimum image
      const float rc = sqrtf(cfg.cutoff2) * 1.00001f + 1e-3f;
      cull2 = rc * rc;
    }
    warp_box(active, xi, yi, zi, ilo, ihi);
  }

  // This lane's LJ type, the NBFIX tables (null: Lorentz-Berthelot) and,
  // for DenseWalk, the box (null without PBC).
  __device__ __forceinline__ void setup(int type, const float* a, const float* b, int nt,
                                        const float* box) {
    ti = type; lja = a; ljb = b; ntypes = nt;
    if (WALK::PBC) {
      bx = box[0]; by = box[1]; bz = box[2];
      ibx = bx > 0.f ? 1.f / bx : 0.f;
      iby = by > 0.f ? 1.f / by : 0.f;
      ibz = bz > 0.f ? 1.f / bz : 0.f;
    }
  }

  // DenseWalk: the displacement xi - p under the walk's image rule.
  __device__ __forceinline__ void displacement(float4 p, float& dx, float& dy,
                                               float& dz) const {
    dx = xi - p.x; dy = yi - p.y; dz = zi - p.z;
    if (WALK::PBC) {
      dx = min_image(dx, bx, ibx);
      dy = min_image(dy, by, iby);
      dz = min_image(dz, bz, ibz);
    }
  }

  // Is the j box [lo, hi] + sh within the cutoff of the i tile's box?
  __device__ __forceinline__ bool near(float4 lo, float4 hi, float4 sh) const {
    const float gx = fmaxf(0.f, fmaxf((lo.x + sh.x) - ihi.x, ilo.x - (hi.x + sh.x)));
    const float gy = fmaxf(0.f, fmaxf((lo.y + sh.y) - ihi.y, ilo.y - (hi.y + sh.y)));
    const float gz = fmaxf(0.f, fmaxf((lo.z + sh.z) - ihi.z, ilo.z - (hi.z + sh.z)));
    return gx * gx + gy * gy + gz * gz <= cull2;
  }

  // The 32-slot survivor mask of up to 32 candidate boxes, box k of lane
  // k < ncand at tbox[2 * (first + k)] (lo, hi).
  __device__ __forceinline__ unsigned cull(const float4* __restrict__ tbox, int first,
                                           int ncand, float4 sh) {
    bool keep = false;
    if (lane < ncand) keep = near(__ldg(tbox + 2 * (first + lane)),
                                  __ldg(tbox + 2 * (first + lane) + 1), sh);
    if (split == 0) n.candidates += ncand;
    return __ballot_sync(FULL, keep);
  }

  // DenseWalk: this lane's candidate box of a chunk of up to 32 (box k
  // of lane k < ncand at tbox[2 * (first + k stride)]).
  __device__ __forceinline__ void load_box(const float4* __restrict__ tbox, int first,
                                           int stride, int ncand, float4& lo,
                                           float4& hi) const {
    if (lane < ncand) {
      lo = __ldg(tbox + 2 * (first + lane * stride));
      hi = __ldg(tbox + 2 * (first + lane * stride) + 1);
    }
  }

  // DenseWalk: the survivor mask of a chunk of up to 32 candidates, lane
  // k < ncand holding box k (load_box), by the minimum-image gap; with no
  // cutoff every candidate survives.
  __device__ __forceinline__ unsigned cull_image(float4 lo, float4 hi, int ncand) {
    bool keep = lane < ncand;
    if (WALK::CUTOFF && keep) {
      const float gx = axis_gap(ilo.x, ihi.x, lo.x, hi.x, bx, ibx);
      const float gy = axis_gap(ilo.y, ihi.y, lo.y, hi.y, by, iby);
      const float gz = axis_gap(ilo.z, ihi.z, lo.z, hi.z, bz, ibz);
      keep = gx * gx + gy * gy + gz * gz <= cull2;
    }
    n.candidates += ncand;
    return __ballot_sync(FULL, keep);
  }

  // A survivor of the walk at packed slots [base, base + nj): if it is this
  // warp's turn, queue every slot inside the cutoff of this lane's atom,
  // then drain.
  __device__ __forceinline__ void visit(int base, int nj, int code) {
    if (seen++ % NSPLIT == split) take(base, nj, code, 0u);
  }

  // Queue every slot of [base, base + nj) inside the cutoff of this lane's
  // atom (DenseWalk: all of them without a cutoff) whose bit in `xw` is
  // clear, then drain.
  __device__ __forceinline__ void take(int base, int nj, int code, unsigned xw) {
    if (nvis == MAX_VISITS) {  // the queued entries name visits: empty them
      drain(true);
      nvis = 0;
    }
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (!WALK::DENSE) sh = sm.shift[code];
    __syncwarp();
    if (lane == 0) sm.visits[nvis] = (code << CODE_SHIFT) | base;
    if (lane < nj) {
      float4 p = __ldg(pq + base + lane);
      p.x += sh.x; p.y += sh.y; p.z += sh.z;
      sm.j[lane] = p;
    }
    __syncwarp();
    if (active) {
      const int tag = nvis << 5;
      const float c2 = cfg.cutoff2;
      for (int k = 0; k < nj; ++k) {
        const float4 p = sm.j[k];
        bool in;
        if constexpr (WALK::DENSE) {
          float dx, dy, dz;
          displacement(p, dx, dy, dz);
          in = (!WALK::CUTOFF || dx * dx + dy * dy + dz * dz <= c2) && !((xw >> k) & 1u);
        } else {
          const float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
          in = dx * dx + dy * dy + dz * dz <= c2;
        }
        if (in) {
          sm.queue[tail & (QDEPTH - 1)][lane] = (unsigned short)(tag | k);
          ++tail;
        }
      }
    }
    ++nvis;
    n.tiles += 1;
    n.slots += nact * nj;
    drain(false);
  }

  // The pair math of one queued entry: the walk gives the displacement and
  // the coefficients, the tail is shared.
  __device__ __forceinline__ void pair(int e, float& tlj, float& tel, float& vx,
                                       float& vy, float& vz) {
    const int tv = sm.visits[e >> 5];
    const int p = (tv & SLOT_MASK) + (e & 31);
    const float4 pj = __ldg(pq + p);
    const float4 aj = __ldg(aux + p);
    float dx, dy, dz, d2, A = 0.f, B = 0.f, qq;
    if constexpr (WALK::DENSE) {
      // excluded and self pairs were never queued
      displacement(pj, dx, dy, dz);
      d2 = dx * dx + dy * dy + dz * dz;
      if (cfg.lj_kind != 0) {
        if (WALK::NBFIX) {
          const int k = ti * ntypes + __float_as_int(aj.w);
          A = __ldg(lja + k);
          B = __ldg(ljb + k);
        } else {
          lb_coefficients(si, aj.x, ei, aj.y, A, B);
        }
      }
      qq = cfg.elec_factor * qi * pj.w;
    } else {
      const float4 sh = sm.shift[tv >> CODE_SHIFT];
      const int j = __float_as_int(aj.z);
      bool hit = j == i;
#pragma unroll
      for (int k = 0; k < REG_EXCL; ++k) hit |= ex[k] == j;
      for (int k = REG_EXCL; k < cfg.nexcl; ++k)
        hit |= __ldg(excl + (size_t)i * cfg.nexcl + k) == j;
      dx = xi - (pj.x + sh.x);
      dy = yi - (pj.y + sh.y);
      dz = zi - (pj.z + sh.z);
      d2 = hit ? 1.f : dx * dx + dy * dy + dz * dz;
      if (cfg.lj_kind != 0 && !hit) {
        if (WALK::NBFIX) {
          const int k = ti * ntypes + __float_as_int(aj.w);
          A = __ldg(lja + k);
          B = __ldg(ljb + k);
        } else {
          lb_coefficients(si, aj.x, ei, aj.y, A, B);
        }
      }
      qq = hit ? 0.f : cfg.elec_factor * qi * pj.w;
    }
    const float g = pair_terms<ELEC>(cfg, d2, A, B, qq, tlj, tel);
    fx -= g * dx;
    fy -= g * dy;
    fz -= g * dz;
    if (VIRIAL) {
      vx += g * dx * dx;
      vy += g * dy * dy;
      vz += g * dz * dz;
    }
  }

  // Rounds of pair math: all queued pairs (`all`), else at least the
  // smallest backlog of the active lanes and enough that every ring has
  // room for the next tile.
  __device__ __forceinline__ void drain(bool all) {
    const int cnt = tail - head;
    const int mx = __reduce_max_sync(FULL, cnt);
    int rounds = mx;
    if (!all) {
      const int mn = __reduce_min_sync(FULL, active ? cnt : INT_MAX);
      rounds = max(mn, mx - (QDEPTH - TILE));
    }
    if (rounds <= 0) return;
    float tlj = 0.f, tel = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
    const int mine = min(rounds, cnt);
#pragma unroll 2
    for (int r = 0; r < mine; ++r)
      pair(sm.queue[(head + r) & (QDEPTH - 1)][lane], tlj, tel, vx, vy, vz);
    head += mine;
    n.rounds += rounds;
    n.lanes += mine;
    elj += (double)tlj;
    eel += (double)tel;
    if (VIRIAL) {
      wx += (double)vx;
      wy += (double)vy;
      wz += (double)vz;
    }
  }

  // Drain, add this lane's force to its atom's zeroed row, and write the
  // warp's energies (times `we`) and raw virial sums g * d_a^2 to
  // part[0..np).
  __device__ __forceinline__ void finish(float* __restrict__ forces, double* __restrict__ part,
                                         double we, unsigned long long* __restrict__ stats) {
    drain(true);
    if (active) {
      atomicAdd(forces + 3 * i, fx);
      atomicAdd(forces + 3 * i + 1, fy);
      atomicAdd(forces + 3 * i + 2, fz);
    }
    put_energies(part, we, stats);
  }

  // The warp's energies (times `we`) and raw virial sums to part[0..np),
  // and its counters to `stats`; after the last drain.
  __device__ __forceinline__ void put_energies(double* __restrict__ part, double we,
                                               unsigned long long* __restrict__ stats) {
    const double a = warp_sum(elj), b = warp_sum(eel);
    double v0 = 0.0, v1 = 0.0, v2 = 0.0;
    if (VIRIAL) { v0 = warp_sum(wx); v1 = warp_sum(wy); v2 = warp_sum(wz); }
    const unsigned long long lanes = (unsigned long long)warp_sum((double)n.lanes);
    typedef unsigned long long u64;
    if (lane == 0) {
      part[0] = we * a;
      part[1] = we * b;
      if (VIRIAL) { part[2] = v0; part[3] = v1; part[4] = v2; }
      if (stats != nullptr) {
        atomicAdd(stats, (u64)n.candidates);
        atomicAdd(stats + 1, (u64)n.tiles);
        atomicAdd(stats + 2, (u64)n.slots);
        atomicAdd(stats + 3, (u64)n.rounds);
        atomicAdd(stats + 4, lanes);
      }
    }
  }
};

// Zero the partials of a warp that has no atoms.
__device__ __forceinline__ void empty_part(double* __restrict__ part, int np) {
  if ((threadIdx.x & 31) < np) part[threadIdx.x & 31] = 0.0;
}

// Sums np partials per warp over nparts warps in a fixed order; the
// result rounds to f32.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
finish_parts(const double* __restrict__ part, int nparts, int np, float* __restrict__ out) {
  __shared__ double scratch[THREADS / 32];
  for (int k = 0; k < np; ++k) {
    double a = 0.0;
    for (int p = threadIdx.x; p < nparts; p += THREADS) a += part[np * p + k];
    a = block_sum(a, scratch);
    if (threadIdx.x == 0) out[k] = (float)a;
  }
}

}  // namespace tiles
