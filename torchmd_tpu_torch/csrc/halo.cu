// Halo pair kernel on Hopper (sm_90a): one rank's owned rows against its
// owned and ghost rows, for the halo-exchange MD (parallel/halo.py).
//
// Replaces: the pair stage of torchmd_tpu/parallel/halo.py
// (energy_forces_local, :620-688), which the JAX package computes with
// pallas_nonbonded.pair_terms over a dense (Acap, Acap + ghosts) block of
// plain arrays (no pallas_call); the walk is that of the cell kernel
// #4 (torchmd_tpu/ops/pallas_cell.py:238, here cell.cu), in a halo form.
//
// Contract: every owned row i against every owned or ghost row j with
// |r_i - r_j| within the cutoff, but for the self pair, padding rows and
// the pairs of the global (N, nexcl) exclusion table (by global id). The
// ghosts arrive pre-shifted, so x is never wrapped; y is wrapped on a
// slab rank and not on a pencil rank; z always. Pair terms are those of
// pair_terms.cuh (LJ with the switch, repulsion or repulsioncg, NBFIX A/B
// by type pair or Lorentz-Berthelot rows, Coulomb plain / reaction field
// / Ewald erfc). Energies carry 0.5 (each pair is seen from both of its
// owners); forces are complete on the owned rows.
//
// What bounds it: the pair math (FP32 issue), as for the cell kernel;
// the layout of the rows is O(M) bytes. So the call goes from the raw
// rows (M, 4) [id, x, y, z] to forces in six device operations, with no
// host work between them and nothing read back:
//   - a memset zeroes the per-cell counters;
//   - halo_bin (a thread a row) bins the row into a cell of edge >= the
//     cutoff over the rank's region: on a wrapped axis the box, cut in
//     floor(L / cutoff) cells, the coordinate wrapped into [0, L); on an
//     unwrapped axis the slab or pencil widened by the ghost reach, cells
//     clamped at its ends (a clamped row lies beyond the last cell edge,
//     so its partners within the cutoff are in that cell); its 4x4x4
//     Morton sub-cell; it counts the cell's rows and owned rows with
//     atomics and zeroes its force row. The last block to finish scans the
//     counts into each cell's first row, first tile (32-row tiles) and
//     first walk tile (the tiles holding owned rows);
//   - halo_scatter (a thread a row) drops the row's index into its cell's
//     bucket by an atomic cursor, in no particular order;
//   - halo_cellprep (a block a cell) sorts the bucket in shared memory by
//     (ghost, Morton code, row index), so the layout is the same whatever
//     the atomics did; writes the packed float4 rows (x, y, z, q and
//     sigma/2, sqrt|eps|, id, LJ type: tile_pairs.cuh's layout), each
//     slot's row, the padding of the cell's last tile, each tile's tight
//     box and cell (a warp a tile) and the cell's walk tiles. A cell of
//     more than PREP_CAP rows is ranked from device memory instead (no row
//     is dropped) and raises the caller's overflow flag to its count;
//   - halo_kernel: one block of two warps per walk tile (a tile holding
//     owned rows); owned rows take i lanes; the warps walk the tiles of
//     the 27 neighbour cells with tile_pairs.cuh's StencilWalk (cull by
//     box, per-lane queues, pair math on full warps), a neighbour past
//     an unwrapped end is skipped, a wrapped one takes its image shift
//     (with fewer than 3 cells on an axis the same cell recurs under
//     other shifts: with a box edge of at least twice the cutoff at most
//     one image of a pair lies inside it); each lane adds its atom's force
//     to its owned row (two atomic additions onto zero: deterministic);
//   - tile_pairs.cuh's finish_parts adds the warps' f64 energies in a
//     fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_pairs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PREP_THREADS = 256;
constexpr int FIN_THREADS = 256;
constexpr int SUB = 4;           // sub-cells per cell edge (Morton order)
constexpr int PREP_CAP = 1024;   // rows a cell's prep block sorts in shared memory

}  // namespace

// Must match HaloCfg in torchmd_tpu_torch/ops/halo.py field by field.
struct HaloCfg {
  int natoms;     // the padding id
  int nrows;      // rows of the call (owned first)
  int nown;       // rows [0, nown) are owned
  int ncx, ncy, ncz;
  int wrapx, wrapy, wrapz;
  int ntiles;     // layout tiles (upper bound: ncells + ceil(nrows / 32))
  int nwalk;      // walk blocks (upper bound: ncells + ceil(nown / 32))
  int nexcl;      // width of the exclusion table
  int ntypes;     // side of the NBFIX tables (0: Lorentz-Berthelot rows)
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_switch;
  float bx, by, bz;     // box: the wrap and the image shift of a wrapped axis
  float ibx, iby, ibz;  // 1 / box, rounded to f32 (the wrap multiplies by it)
  float ox, oy, oz;     // the grid's origin per axis
  float sx, sy, sz;     // its cells per A
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

// Byte offsets of the scratch arrays; ops/halo.py reads the tiles back
// through them (halo_tiles).
enum Carve {
  PQ, AUX, TBOX, ROWOF, TILE_CELL, COUNTS, OWNED, TSTART, WSTART,  // read back
  RPOS, PART, RCODE, BUCKET, DONE, CSTART, CURSOR, WLIST, BYTES
};

namespace {

void offsets(const HaloCfg& cfg, long long* off) {
  const long long slots = (long long)cfg.ntiles * tiles::TILE;
  const long long ncells = (long long)cfg.ncx * cfg.ncy * cfg.ncz;
  long long at = 0;
  auto take = [&](Carve k, long long bytes) {
    off[k] = at;
    at += (bytes + 15) / 16 * 16;
  };
  take(PQ, 16 * slots);
  take(AUX, 16 * slots);
  take(TBOX, 32LL * cfg.ntiles);
  take(RPOS, 16LL * cfg.nrows);
  take(PART, 16LL * tiles::NSPLIT * cfg.nwalk);
  // the memset's region: COUNTS, OWNED, DONE, adjacent
  take(COUNTS, 4 * ncells);
  take(OWNED, 4 * ncells);
  take(DONE, 4);
  take(ROWOF, 4 * slots);
  take(TILE_CELL, 4LL * cfg.ntiles);
  take(RCODE, 4LL * cfg.nrows);
  take(BUCKET, 4LL * cfg.nrows);
  take(CSTART, 4 * (ncells + 1));
  take(TSTART, 4 * (ncells + 1));
  take(WSTART, 4 * (ncells + 1));
  take(CURSOR, 4 * ncells);
  take(WLIST, 4LL * cfg.nwalk);
  off[BYTES] = at;
}

struct Scratch {
  float4 *pq, *aux, *tbox, *rpos;
  double* part;
  int32_t *counts, *owned, *done, *rowof, *tile_cell, *rcode, *bucket, *cstart, *tstart,
      *wstart, *cursor, *wlist;
  size_t zero_bytes;  // COUNTS .. DONE
};

Scratch carve(const HaloCfg& cfg, void* scratch) {
  long long off[BYTES + 1];
  offsets(cfg, off);
  char* b = static_cast<char*>(scratch);
  auto i32 = [&](Carve k) { return reinterpret_cast<int32_t*>(b + off[k]); };
  auto f4 = [&](Carve k) { return reinterpret_cast<float4*>(b + off[k]); };
  return Scratch{f4(PQ), f4(AUX), f4(TBOX), f4(RPOS),
                 reinterpret_cast<double*>(b + off[PART]), i32(COUNTS), i32(OWNED), i32(DONE),
                 i32(ROWOF), i32(TILE_CELL), i32(RCODE), i32(BUCKET), i32(CSTART), i32(TSTART),
                 i32(WSTART), i32(CURSOR), i32(WLIST),
                 (size_t)(off[DONE] + 4 - off[COUNTS])};
}

// Morton index of a sub-cell (2 bits per axis, x lowest).
__device__ __forceinline__ int morton(int a, int b, int c) {
  return (a & 1) | ((b & 1) << 1) | ((c & 1) << 2) | ((a & 2) << 2) | ((b & 2) << 3) |
         ((c & 2) << 4);
}

// The binned coordinate: on a wrapped axis x - L floor(x / L), with the
// division a product by the f32 reciprocal; the rounding is spelled out
// so that ops/halo.py's plain version gives the same bits.
__device__ __forceinline__ float binned(float x, int wrap, float box, float ibox) {
  return wrap ? __fsub_rn(x, __fmul_rn(box, floorf(__fmul_rn(x, ibox)))) : x;
}

// The cell of a binned coordinate along one axis, clamped into [0, nc),
// and its sub-cell.
__device__ __forceinline__ int axis_cell(float x, float o, float s, int nc, int& sub) {
  const float f = __fmul_rn(__fsub_rn(x, o), s);
  const float c = fminf(fmaxf(floorf(f), 0.f), (float)(nc - 1));
  sub = min(max((int)__fmul_rn(__fsub_rn(f, c), (float)SUB), 0), SUB - 1);
  return (int)c;
}

__device__ __forceinline__ int3 operator+(int3 a, int3 b) {
  return make_int3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ int3 operator-(int3 a, int3 b) {
  return make_int3(a.x - b.x, a.y - b.y, a.z - b.z);
}

// One block: each cell's first row (cstart, and the scatter's cursor),
// first tile (tstart) and first walk tile (wstart), from the counts; the
// totals at index ncells.
__device__ void scan_cells(int ncells, const int32_t* counts, const int32_t* owned,
                           int32_t* cstart, int32_t* tstart, int32_t* wstart,
                           int32_t* cursor) {
  __shared__ int3 warp_tot[THREADS / 32];
  __shared__ int3 carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = make_int3(0, 0, 0);
  __syncthreads();
  for (int base = 0; base < ncells; base += THREADS) {
    const int c = base + threadIdx.x;
    int3 v = make_int3(0, 0, 0);
    if (c < ncells) {
      // written by other blocks' atomics: read from L2
      const int n = __ldcg(counts + c), o = __ldcg(owned + c);
      v = make_int3(n, (n + tiles::TILE - 1) / tiles::TILE, (o + tiles::TILE - 1) / tiles::TILE);
    }
    int3 s = v;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int3 t = make_int3(__shfl_up_sync(tiles::FULL, s.x, off),
                               __shfl_up_sync(tiles::FULL, s.y, off),
                               __shfl_up_sync(tiles::FULL, s.z, off));
      if (lane >= off) s = s + t;
    }
    if (lane == 31) warp_tot[warp] = s;
    __syncthreads();
    int3 pre = carry;
    for (int w = 0; w < warp; ++w) pre = pre + warp_tot[w];
    const int3 first = pre + s - v;
    if (c < ncells) {
      cstart[c] = first.x;
      cursor[c] = first.x;
      tstart[c] = first.y;
      wstart[c] = first.z;
    }
    __syncthreads();
    if (threadIdx.x == THREADS - 1) carry = pre + s;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    cstart[ncells] = carry.x;
    tstart[ncells] = carry.y;
    wstart[ncells] = carry.z;
  }
}

// A thread a row: its binned position and global id (rpos), its code
// cell * 128 + ghost * 64 + Morton (-1: padding, no cell), the cell's
// counts, and its force row zeroed (owned rows; forces may be null). The
// last block to finish runs scan_cells.
__global__ void __launch_bounds__(THREADS)
halo_bin(const float* __restrict__ rows, const __grid_constant__ HaloCfg cfg,
         Scratch sc, float* __restrict__ forces) {
  __shared__ bool last;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r < cfg.nrows) {
    if (forces != nullptr && r < cfg.nown) {
      forces[3 * r] = 0.f;
      forces[3 * r + 1] = 0.f;
      forces[3 * r + 2] = 0.f;
    }
    const int id = (int)rows[4 * r];
    const float x = binned(rows[4 * r + 1], cfg.wrapx, cfg.bx, cfg.ibx);
    const float y = binned(rows[4 * r + 2], cfg.wrapy, cfg.by, cfg.iby);
    const float z = binned(rows[4 * r + 3], cfg.wrapz, cfg.bz, cfg.ibz);
    int code = -1;
    if (id < cfg.natoms) {
      int ux, uy, uz;
      const int cx = axis_cell(x, cfg.ox, cfg.sx, cfg.ncx, ux);
      const int cy = axis_cell(y, cfg.oy, cfg.sy, cfg.ncy, uy);
      const int cz = axis_cell(z, cfg.oz, cfg.sz, cfg.ncz, uz);
      const int c = (cx * cfg.ncy + cy) * cfg.ncz + cz;
      const bool ghost = r >= cfg.nown;
      code = c * 128 + (ghost ? 64 : 0) + morton(ux, uy, uz);
      atomicAdd(sc.counts + c, 1);
      if (!ghost) atomicAdd(sc.owned + c, 1);
    }
    sc.rpos[r] = make_float4(x, y, z, __int_as_float(id));
    sc.rcode[r] = code;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sc.done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_cells(cfg.ncx * cfg.ncy * cfg.ncz, sc.counts, sc.owned, sc.cstart, sc.tstart,
             sc.wstart, sc.cursor);
}

// A thread a row: its index into its cell's bucket.
__global__ void __launch_bounds__(THREADS)
halo_scatter(int nrows, Scratch sc) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= nrows) return;
  const int code = sc.rcode[r];
  if (code >= 0) sc.bucket[atomicAdd(sc.cursor + (code >> 7), 1)] = r;
}

// The sort key of bucket entry k: (ghost, Morton) above the row index,
// distinct.
__device__ __forceinline__ long long bucket_key(const Scratch& sc, int base, int k) {
  const int r = sc.bucket[base + k];
  return ((long long)(sc.rcode[r] & 127) << 32) | r;
}

// A block a cell: its rows in (ghost, Morton, row) order packed into its
// tiles, the last tile's padding, each tile's box and cell, its walk
// tiles.
__global__ void __launch_bounds__(PREP_THREADS)
halo_cellprep(const float* __restrict__ q, const float* __restrict__ sig,
              const float* __restrict__ eps, const int32_t* __restrict__ types,
              const __grid_constant__ HaloCfg cfg, Scratch sc, int32_t* __restrict__ overflow) {
  __shared__ long long key[PREP_CAP];
  const int c = blockIdx.x;
  const int cnt = sc.counts[c], base = sc.cstart[c];
  const int t0 = sc.tstart[c], ntc = sc.tstart[c + 1] - t0;
  const bool fits = cnt <= PREP_CAP;
  if (!fits && threadIdx.x == 0 && overflow != nullptr) atomicMax(overflow, cnt);
  if (fits)
    for (int k = threadIdx.x; k < cnt; k += PREP_THREADS) key[k] = bucket_key(sc, base, k);
  __syncthreads();
  for (int k = threadIdx.x; k < cnt; k += PREP_THREADS) {
    const long long mine = fits ? key[k] : bucket_key(sc, base, k);
    int rank = 0;
    if (fits) {
      for (int m = 0; m < cnt; ++m) rank += key[m] < mine;
    } else {
      for (int m = 0; m < cnt; ++m) rank += bucket_key(sc, base, m) < mine;
    }
    const int r = (int)(mine & 0xffffffffLL);
    const float4 p = sc.rpos[r];
    const int i = __float_as_int(p.w);
    const int slot = t0 * tiles::TILE + rank;
    sc.pq[slot] = make_float4(p.x, p.y, p.z, q[i]);
    sc.aux[slot] = make_float4(sig[i], eps[i], __int_as_float(i),
                               __int_as_float(types != nullptr ? types[i] : 0));
    sc.rowof[slot] = r;
  }
  for (int k = cnt + threadIdx.x; k < ntc * tiles::TILE; k += PREP_THREADS) {
    const int slot = t0 * tiles::TILE + k;
    sc.pq[slot] = make_float4(tiles::FAR, tiles::FAR, tiles::FAR, 0.f);
    sc.aux[slot] = make_float4(0.f, 0.f, __int_as_float(cfg.natoms), 0.f);
    sc.rowof[slot] = -1;
  }
  const int w0 = sc.wstart[c], nw = sc.wstart[c + 1] - w0;
  for (int k = threadIdx.x; k < nw; k += PREP_THREADS) sc.wlist[w0 + k] = t0 + k;
  __syncthreads();  // the block's packed rows, for the boxes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < ntc; t += PREP_THREADS / 32) {
    const bool active = t * tiles::TILE + lane < cnt;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) p = sc.pq[(t0 + t) * tiles::TILE + lane];
    float4 lo, hi;
    tiles::warp_box(active, p.x, p.y, p.z, lo, hi);
    if (lane == 0) {
      sc.tbox[2 * (t0 + t)] = lo;
      sc.tbox[2 * (t0 + t) + 1] = hi;
      sc.tile_cell[t0 + t] = c;
    }
  }
}

// Neighbour cell index along one axis and its image shift; -1 past an
// unwrapped end.
__device__ __forceinline__ int neighbour(int c, int nc, bool wrap, float box,
                                         float& shift) {
  shift = 0.f;
  if (c < 0) {
    if (!wrap) return -1;
    c += nc; shift = -box;
  } else if (c >= nc) {
    if (!wrap) return -1;
    c -= nc; shift = box;
  }
  return c;
}

template <int ELEC, bool NBFIX>
__global__ void __launch_bounds__(tiles::NSPLIT * 32)
halo_kernel(Scratch sc, const int32_t* __restrict__ excl, const float* __restrict__ lj_a,
            const float* __restrict__ lj_b, const __grid_constant__ HaloCfg cfg,
            float* __restrict__ forces, unsigned long long* __restrict__ stats) {
  __shared__ tiles::WarpSmem smem[tiles::NSPLIT];
  constexpr int NP = 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncells = cfg.ncx * cfg.ncy * cfg.ncz;
  double* wpart = sc.part + NP * (tiles::NSPLIT * blockIdx.x + w);
  if ((int)blockIdx.x >= sc.wstart[ncells]) {
    tiles::empty_part(wpart, NP);
    return;
  }
  const int t = sc.wlist[blockIdx.x];
  const int c = sc.tile_cell[t];
  const int ti = t - sc.tstart[c];
  const int nown_c = sc.owned[c];
  const int cz = c % cfg.ncz;
  const int cy = (c / cfg.ncz) % cfg.ncy;
  const int cx = c / (cfg.ncz * cfg.ncy);
  tiles::WarpSmem& sm = smem[w];
  int nbr = -1;  // lane o < 27: the neighbour cell of stencil offset o, or -1
  if (lane < 27) {
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nx = neighbour(cx + lane / 9 - 1, cfg.ncx, cfg.wrapx, cfg.bx, sh.x);
    const int ny = neighbour(cy + (lane / 3) % 3 - 1, cfg.ncy, cfg.wrapy, cfg.by, sh.y);
    const int nz = neighbour(cz + lane % 3 - 1, cfg.ncz, cfg.wrapz, cfg.bz, sh.z);
    if (nx >= 0 && ny >= 0 && nz >= 0) nbr = (nx * cfg.ncy + ny) * cfg.ncz + nz;
    sm.shift[lane] = sh;
  }
  __syncwarp();

  const int slot = t * tiles::TILE + lane;
  const bool active = ti * tiles::TILE + lane < nown_c;
  float4 pi = make_float4(0.f, 0.f, 0.f, 0.f), ai = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) { pi = sc.pq[slot]; ai = sc.aux[slot]; }
  tiles::TileWarp<HaloCfg, false, ELEC, tiles::StencilWalk<NBFIX>> tw(
      cfg, sc.pq, sc.aux, excl, sm, active, __float_as_int(ai.z), pi.x, pi.y, pi.z, pi.w,
      ai.x, ai.y);
  if (NBFIX) tw.setup(__float_as_int(ai.w), lj_a, lj_b, cfg.ntypes, nullptr);
  for (int oo = 0; oo < 27; ++oo) {
    // the self cell, then offsets 0, 26, 1, 25, ...: opposite cells in turn
    const int o = oo == 0 ? 13 : ((oo & 1) ? (oo - 1) / 2 : 26 - (oo - 1) / 2);
    const int nc = __shfl_sync(tiles::FULL, nbr, o);
    if (nc < 0) continue;
    const int tj0 = sc.tstart[nc], cnt_j = sc.counts[nc];
    const int ntj = (cnt_j + tiles::TILE - 1) / tiles::TILE;
    const float4 sh = sm.shift[o];
    for (int k0 = 0; k0 < ntj; k0 += 32) {
      unsigned keep = tw.cull(sc.tbox, tj0 + k0, min(32, ntj - k0), sh);
      while (keep) {
        const int k = k0 + __ffs(keep) - 1;
        keep &= keep - 1;
        tw.visit((tj0 + k) * tiles::TILE, min(tiles::TILE, cnt_j - k * tiles::TILE), o);
      }
    }
  }
  tw.drain(true);
  if (active) {
    const int r = sc.rowof[slot];
    atomicAdd(forces + 3 * r, tw.fx);
    atomicAdd(forces + 3 * r + 1, tw.fy);
    atomicAdd(forces + 3 * r + 2, tw.fz);
  }
  tw.put_energies(wpart, 0.5, stats);
}

struct PairArgs {
  const int32_t* excl;
  const float *lj_a, *lj_b;
  float* forces;
  unsigned long long* stats;
};

template <int ELEC, bool NBFIX>
void launch_kernel(cudaStream_t s, const HaloCfg& cfg, const Scratch& sc, const PairArgs& a) {
  halo_kernel<ELEC, NBFIX><<<cfg.nwalk, tiles::NSPLIT * 32, 0, s>>>(
      sc, a.excl, a.lj_a, a.lj_b, cfg, a.forces, a.stats);
}

template <bool NBFIX>
void launch_pairs(cudaStream_t s, const HaloCfg& cfg, const Scratch& sc, const PairArgs& a) {
  switch (cfg.elec_kind) {
    case 0: launch_kernel<0, NBFIX>(s, cfg, sc, a); break;
    case 1: launch_kernel<1, NBFIX>(s, cfg, sc, a); break;
    case 2: launch_kernel<2, NBFIX>(s, cfg, sc, a); break;
    default: launch_kernel<3, NBFIX>(s, cfg, sc, a);
  }
}

inline int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

bool valid(const HaloCfg& cfg) {
  const long long ncells = (long long)cfg.ncx * cfg.ncy * cfg.ncz;
  return cfg.nrows >= 1 && cfg.nown >= 0 && cfg.nown <= cfg.nrows && cfg.ncx >= 1 &&
         cfg.ncy >= 1 && cfg.ncz >= 1 && ncells * 128 < INT_MAX &&
         cfg.ntiles >= ncells + (cfg.nrows + tiles::TILE - 1) / tiles::TILE &&
         cfg.nwalk >= ncells + (cfg.nown + tiles::TILE - 1) / tiles::TILE &&
         (long long)cfg.ntiles * tiles::TILE <= tiles::SLOT_MASK;
}

// memset, bin (with the scan), scatter, cell prep.
cudaError_t prep(const float* rows, const float* q, const float* sig, const float* eps,
                 const int32_t* types, const HaloCfg& cfg, const Scratch& sc,
                 int32_t* overflow, float* forces, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(sc.counts, 0, sc.zero_bytes, s);
  if (err != cudaSuccess) return err;
  halo_bin<<<blocks(cfg.nrows), THREADS, 0, s>>>(rows, cfg, sc, forces);
  halo_scatter<<<blocks(cfg.nrows), THREADS, 0, s>>>(cfg.nrows, sc);
  halo_cellprep<<<cfg.ncx * cfg.ncy * cfg.ncz, PREP_THREADS, 0, s>>>(q, sig, eps, types, cfg,
                                                                     sc, overflow);
  return cudaGetLastError();
}

}  // namespace

// Byte offsets of the scratch arrays (the Carve order) and, last, the
// scratch size.
extern "C" void tmd_halo_carve(HaloCfg cfg, long long* off) { offsets(cfg, off); }

// rows (nrows, 4) f32 [global id, x, y, z] (id natoms: padding), the
// first nown owned; q/sig/eps (natoms) f32 and types (natoms) int32 by
// global id, excl (natoms, nexcl) int32 (natoms = empty), lj_a/lj_b the
// NBFIX tables or null; scratch of tmd_halo_carve's size (16-byte
// aligned); overflow (1 int32, or null) is raised to the row count of a
// cell over PREP_CAP (never lowered). Outputs: forces (nown, 3), energies
// (2) as [lj-family, electrostatics], both written whole; stats (5
// uint64, or null) gains the walk's counters (tile_pairs.cuh Counters).
// Returns cudaGetLastError().
extern "C" int tmd_halo_energy_forces(
    const float* rows, const float* q, const float* sig, const float* eps,
    const int32_t* types, const int32_t* excl, const float* lj_a, const float* lj_b,
    HaloCfg cfg, void* scratch, int32_t* overflow, float* forces, float* energies,
    unsigned long long* stats, void* stream) {
  if (!valid(cfg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(cfg, scratch);
  cudaError_t err = prep(rows, q, sig, eps, types, cfg, sc, overflow, forces, s);
  if (err != cudaSuccess) return (int)err;
  const PairArgs a{excl, lj_a, lj_b, forces, stats};
  if (lj_a != nullptr) launch_pairs<true>(s, cfg, sc, a);
  else launch_pairs<false>(s, cfg, sc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiles::finish_parts<FIN_THREADS><<<1, FIN_THREADS, 0, s>>>(
      sc.part, tiles::NSPLIT * cfg.nwalk, 2, energies);
  return (int)cudaGetLastError();
}

// The prep pass alone (tests): the layout into `scratch`.
extern "C" int tmd_halo_prep(const float* rows, const float* q, const float* sig,
                             const float* eps, const int32_t* types, HaloCfg cfg,
                             void* scratch, int32_t* overflow, void* stream) {
  if (!valid(cfg)) return (int)cudaErrorInvalidValue;
  return (int)prep(rows, q, sig, eps, types, cfg, carve(cfg, scratch), overflow, nullptr,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
