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
// Layout: ops/halo.py bins the rows (torch ops) into cells of edge >=
// the cutoff over the rank's region: on a wrapped axis the box, cut in
// floor(L / cutoff) cells, with coordinates wrapped into [0, L); on an
// unwrapped axis the slab or pencil widened by the ghost reach on both
// sides, with cells clamped at its ends (a clamped row lies beyond the
// last cell edge, so its partners within the cutoff are in that cell).
// Each cell's rows are sorted owned first, then along a Morton curve of
// 4x4x4 sub-cells; cell c's rows take the tiles [tstart[c], tstart[c+1])
// of 32 slots. Here:
//   - halo_pack (a thread per sorted row) writes the packed float4 rows
//     (x, y, z, q and sigma/2, sqrt|eps|, id, LJ type: tile_pairs.cuh's
//     layout) and each slot's table row; halo_boxes (a thread per tile)
//     the tile boxes and the tile's cell;
//   - halo_kernel: one block of two warps per tile whose rows include
//     owned ones; owned rows take i lanes; the warps walk the tiles of
//     the 27 neighbour cells with tile_pairs.cuh's StencilWalk (cull by
//     box, per-lane queues, pair math on full warps), a neighbour past
//     an unwrapped end is skipped, a wrapped one takes its image shift
//     (with fewer than 3 cells on an axis the same cell recurs under
//     other shifts: with a box edge of at least twice the cutoff at most
//     one image of a pair lies inside it);
//   - each lane adds its atom's force to its owned row (two atomic
//     additions onto zero: deterministic), energies sum per warp in f64
//     and tile_pairs.cuh's finish_parts adds them in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_pairs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FIN_THREADS = 256;

}  // namespace

// Must match HaloCfg in torchmd_tpu_torch/ops/halo.py field by field.
struct HaloCfg {
  int natoms;     // the padding id
  int nrows;      // rows of the call (owned first)
  int nown;       // rows [0, nown) are owned
  int ncx, ncy, ncz;
  int wrapx, wrapy, wrapz;
  int ntiles;     // tiles of the layout (upper bound: ncells + ceil(nrows / 32))
  int nexcl;      // width of the exclusion table
  int ntypes;     // side of the NBFIX tables (0: Lorentz-Berthelot rows)
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_switch;
  float bx, by, bz;  // box: the image shift of a wrapped axis
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

// One thread per sorted row s (cell-major, owned first, Morton order):
// its slot is the cell's first tile's, plus its rank within the cell.
__global__ void __launch_bounds__(THREADS)
halo_pack(const float* __restrict__ xyz, const int32_t* __restrict__ ids,
          const int32_t* __restrict__ order, const int32_t* __restrict__ cell_sorted,
          const int32_t* __restrict__ cstart, const int32_t* __restrict__ tstart,
          const float* __restrict__ q, const float* __restrict__ sig,
          const float* __restrict__ eps, const int32_t* __restrict__ types,
          const __grid_constant__ HaloCfg cfg, float4* __restrict__ pq,
          float4* __restrict__ aux, int32_t* __restrict__ rowof) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= cfg.nrows) return;
  const int c = cell_sorted[s];
  if (c < 0) return;  // padding rows sort last
  const int r = order[s];
  const int slot = tstart[c] * tiles::TILE + (s - cstart[c]);
  const int i = ids[r];
  pq[slot] = make_float4(xyz[3 * r], xyz[3 * r + 1], xyz[3 * r + 2], q[i]);
  aux[slot] = make_float4(sig[i], eps[i], __int_as_float(i),
                          __int_as_float(types != nullptr ? types[i] : 0));
  rowof[slot] = r;
}

// Padding of every slot (rows of empty slots stay so).
__global__ void __launch_bounds__(THREADS)
halo_clear(int nslots, int natoms, float4* __restrict__ pq, float4* __restrict__ aux) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= nslots) return;
  pq[s] = make_float4(tiles::FAR, tiles::FAR, tiles::FAR, 0.f);
  aux[s] = make_float4(0.f, 0.f, __int_as_float(natoms), 0.f);
}

// One thread per tile: its bounding box over its rows and its cell (-1
// past the last cell's tiles), by a binary search of tstart.
__global__ void __launch_bounds__(THREADS)
halo_boxes(const float4* __restrict__ pq, const float4* __restrict__ aux,
           const int32_t* __restrict__ tstart, const __grid_constant__ HaloCfg cfg,
           float4* __restrict__ tbox, int32_t* __restrict__ tile_cell) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= cfg.ntiles) return;
  const int ncells = cfg.ncx * cfg.ncy * cfg.ncz;
  int lo = 0, hi = ncells;  // the last c with tstart[c] <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tstart[mid] <= t) lo = mid; else hi = mid;
  }
  tile_cell[t] = t < tstart[ncells] ? lo : -1;
  float4 blo = make_float4(tiles::FAR, tiles::FAR, tiles::FAR, 0.f);
  float4 bhi = make_float4(-tiles::FAR, -tiles::FAR, -tiles::FAR, 0.f);
  for (int k = t * tiles::TILE; k < (t + 1) * tiles::TILE; ++k) {
    if (__float_as_int(aux[k].z) >= cfg.natoms) continue;
    const float4 p = pq[k];
    blo.x = fminf(blo.x, p.x); blo.y = fminf(blo.y, p.y); blo.z = fminf(blo.z, p.z);
    bhi.x = fmaxf(bhi.x, p.x); bhi.y = fmaxf(bhi.y, p.y); bhi.z = fmaxf(bhi.z, p.z);
  }
  tbox[2 * t] = blo;
  tbox[2 * t + 1] = bhi;
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
halo_kernel(const float4* __restrict__ pq, const float4* __restrict__ aux,
            const float4* __restrict__ tbox, const int32_t* __restrict__ rowof,
            const int32_t* __restrict__ tile_cell, const int32_t* __restrict__ tstart,
            const int32_t* __restrict__ counts, const int32_t* __restrict__ owned,
            const int32_t* __restrict__ excl, const float* __restrict__ lj_a,
            const float* __restrict__ lj_b, const __grid_constant__ HaloCfg cfg,
            float* __restrict__ forces, double* __restrict__ part) {
  __shared__ tiles::WarpSmem smem[tiles::NSPLIT];
  constexpr int NP = 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  double* wpart = part + NP * (tiles::NSPLIT * t + w);
  const int c = tile_cell[t];
  const int ti = c < 0 ? 0 : t - tstart[c];
  const int nown_c = c < 0 ? 0 : owned[c];
  if (ti * tiles::TILE >= nown_c) {
    tiles::empty_part(wpart, NP);
    return;
  }
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
  if (active) { pi = pq[slot]; ai = aux[slot]; }
  tiles::TileWarp<HaloCfg, false, ELEC, tiles::StencilWalk<NBFIX>> tw(
      cfg, pq, aux, excl, sm, active, __float_as_int(ai.z), pi.x, pi.y, pi.z, pi.w, ai.x,
      ai.y);
  if (NBFIX) tw.setup(__float_as_int(ai.w), lj_a, lj_b, cfg.ntypes, nullptr);
  for (int oo = 0; oo < 27; ++oo) {
    // the self cell, then offsets 0, 26, 1, 25, ...: opposite cells in turn
    const int o = oo == 0 ? 13 : ((oo & 1) ? (oo - 1) / 2 : 26 - (oo - 1) / 2);
    const int nc = __shfl_sync(tiles::FULL, nbr, o);
    if (nc < 0) continue;
    const int t0 = tstart[nc], cnt_j = counts[nc];
    const int ntj = (cnt_j + tiles::TILE - 1) / tiles::TILE;
    const float4 sh = sm.shift[o];
    for (int k0 = 0; k0 < ntj; k0 += 32) {
      unsigned keep = tw.cull(tbox, t0 + k0, min(32, ntj - k0), sh);
      while (keep) {
        const int k = k0 + __ffs(keep) - 1;
        keep &= keep - 1;
        tw.visit((t0 + k) * tiles::TILE, min(tiles::TILE, cnt_j - k * tiles::TILE), o);
      }
    }
  }
  tw.drain(true);
  if (active) {
    const int r = rowof[slot];
    atomicAdd(forces + 3 * r, tw.fx);
    atomicAdd(forces + 3 * r + 1, tw.fy);
    atomicAdd(forces + 3 * r + 2, tw.fz);
  }
  tw.put_energies(wpart, 0.5, nullptr);
}

struct PairArgs {
  const float4 *pq, *aux, *tbox;
  const int32_t *rowof, *tile_cell, *tstart, *counts, *owned, *excl;
  const float *lj_a, *lj_b;
  float* forces;
  double* part;
};

template <int ELEC, bool NBFIX>
void launch_kernel(cudaStream_t s, const HaloCfg& cfg, const PairArgs& a) {
  halo_kernel<ELEC, NBFIX><<<cfg.ntiles, tiles::NSPLIT * 32, 0, s>>>(
      a.pq, a.aux, a.tbox, a.rowof, a.tile_cell, a.tstart, a.counts, a.owned, a.excl,
      a.lj_a, a.lj_b, cfg, a.forces, a.part);
}

template <bool NBFIX>
void launch_pairs(cudaStream_t s, const HaloCfg& cfg, const PairArgs& a) {
  switch (cfg.elec_kind) {
    case 0: launch_kernel<0, NBFIX>(s, cfg, a); break;
    case 1: launch_kernel<1, NBFIX>(s, cfg, a); break;
    case 2: launch_kernel<2, NBFIX>(s, cfg, a); break;
    default: launch_kernel<3, NBFIX>(s, cfg, a);
  }
}

inline int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// Scratch of a call, in bytes: packed rows (2 float4 per slot), the tile
// boxes (2 float4), the per-warp energy partials (2 doubles per warp,
// NSPLIT warps a tile), each slot's table row and each tile's cell.
extern "C" long long tmd_halo_scratch_bytes(HaloCfg cfg) {
  const long long slots = (long long)cfg.ntiles * tiles::TILE;
  return 32 * slots + 32LL * cfg.ntiles + 16LL * tiles::NSPLIT * cfg.ntiles + 4 * slots +
         4LL * cfg.ntiles;
}

// xyz (nrows, 3) the binned coordinates (wrapped axes in [0, L)), ids
// (nrows) int32 global ids (natoms: padding); order (nrows) the rows in
// (cell, owned first, Morton) order and cell_sorted (nrows) their cells
// (-1: padding, last); cstart (ncells + 1) each cell's first sorted row,
// tstart (ncells + 1) its first tile, counts (ncells) its rows, owned
// (ncells) its owned rows; q/sig/eps (natoms) f32 and types (natoms)
// int32 by global id, excl (natoms, nexcl) int32 (natoms = empty),
// lj_a/lj_b the NBFIX tables or null; scratch of
// tmd_halo_scratch_bytes(cfg) bytes (16-byte aligned). Outputs: forces
// (nown, 3), zeroed first; energies (2) as [lj-family, electrostatics].
// Returns cudaGetLastError().
extern "C" int tmd_halo_energy_forces(
    const float* xyz, const int32_t* ids, const int32_t* order, const int32_t* cell_sorted,
    const int32_t* cstart, const int32_t* tstart, const int32_t* counts,
    const int32_t* owned, const float* q, const float* sig, const float* eps,
    const int32_t* types, const int32_t* excl, const float* lj_a, const float* lj_b,
    HaloCfg cfg, void* scratch, float* forces, float* energies, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slots = (long long)cfg.ntiles * tiles::TILE;
  if (cfg.nrows < 1 || cfg.nown < 0 || cfg.nown > cfg.nrows || cfg.ntiles < 1 ||
      slots > tiles::SLOT_MASK || cfg.ncx < 1 || cfg.ncy < 1 || cfg.ncz < 1)
    return (int)cudaErrorInvalidValue;
  float4* pq = static_cast<float4*>(scratch);
  float4* aux = pq + slots;
  float4* tbox = aux + slots;
  double* part = reinterpret_cast<double*>(tbox + 2 * cfg.ntiles);
  int32_t* rowof = reinterpret_cast<int32_t*>(part + 2 * tiles::NSPLIT * cfg.ntiles);
  int32_t* tile_cell = rowof + slots;
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.nown, s);
  if (err != cudaSuccess) return (int)err;
  halo_clear<<<blocks(slots), THREADS, 0, s>>>((int)slots, cfg.natoms, pq, aux);
  halo_pack<<<blocks(cfg.nrows), THREADS, 0, s>>>(xyz, ids, order, cell_sorted, cstart,
                                                  tstart, q, sig, eps, types, cfg, pq, aux,
                                                  rowof);
  halo_boxes<<<blocks(cfg.ntiles), THREADS, 0, s>>>(pq, aux, tstart, cfg, tbox, tile_cell);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const PairArgs a{pq, aux, tbox, rowof, tile_cell, tstart, counts, owned, excl,
                   lj_a, lj_b, forces, part};
  if (lj_a != nullptr) launch_pairs<true>(s, cfg, a);
  else launch_pairs<false>(s, cfg, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiles::finish_parts<FIN_THREADS><<<1, FIN_THREADS, 0, s>>>(
      part, tiles::NSPLIT * cfg.ntiles, 2, energies);
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
