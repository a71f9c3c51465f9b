// Cell-list nonbonded energy and forces on Hopper (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_cell.py, pallas_cell_energy_forces with
// its kernel _kernel (27-stencil ghost-cell pair blocks; the per-pair math
// is pallas_nonbonded.pair_terms, here pair_terms.cuh shared with
// nonbonded.cu and column.cu). Same contract as
// neighbors.cell_nonbonded_energy_forces: the pairs of each cell's atoms
// with the atoms of its 27 neighbour cells (cell edge >= cutoff + skin),
// the periodic image as a per-neighbour-cell shift of the anchored
// positions, exclusions from a padded per-atom list, the cutoff on d^2, LJ
// with the switch or repulsion or repulsioncg (Lorentz-Berthelot from
// per-atom rows, or NBFIX A/B tables by type pair) plus Coulomb plain /
// reaction field / Ewald erfc. Energies carry 0.5 (every pair is seen
// from both cells).
//
// What bounds it on this card: FP32 issue. Only ~7 % of the slot pairs of
// neighbouring cells lie inside the cutoff (the 62,500-site water box:
// 3.05e8 slot pairs for 2.1e7 ordered pairs inside it), and a warp whose
// lanes test the cutoff one pair each runs the full pair math (~100
// operations with erfc) whenever one lane is inside. Device memory moves
// O(N) bytes. So the walk is tile_pairs.cuh's:
//   - a prep pass (one block per cell) orders each cell's atoms along a
//     Morton curve over 4x4x4 sub-cells, writes them as packed float4 rows
//     (x, y, z, q and sigma/2, sqrt|eps|, id, LJ type) in that order, and the
//     bounding box of every 32-atom tile; the cell list itself is not
//     touched;
//   - one block of two warps per i tile walks the tiles of the 27
//     neighbour cells (the self cell, then opposite offsets in turn), culls
//     those whose boxes lie beyond the cutoff, shares the survivors out
//     between its warps, queues each lane's pairs inside the cutoff and
//     runs the pair math on full warps;
//   - each lane owns its atom's share of the force, which meets the other
//     warp's in two atomic additions onto zero: deterministic forces;
//   - energies (and with VIRIAL the raw per-axis sums g * d_a^2) sum per
//     warp in f64, and a finishing kernel adds the warps in a fixed order.
// The VIRIAL instance (MTK barostat; pallas_cell.py's with_virial) returns
// the raw sums: the caller applies the -0.5.
// A slab (the spatially sharded path; the JAX package's slab of cell
// columns, torchmd_tpu/neighbors.py:340-380) is the cell range [cell0,
// cell1): cells are x-major, so a slab of x columns is contiguous, and
// the launch takes that range's i tiles only (blockIdx.x offset by the
// range's first tile), their energy partials and their finishing sum.
// Forces of atoms outside the slab stay zero, so the ranks' slabs sum to
// the full call. The NBFIX instances read A/B
// from the (ntypes, ntypes) tables by the packed rows' types.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_pairs.cuh"

namespace {

constexpr int MAX_CAPACITY = 1024;
constexpr int PREP_THREADS = 256;
constexpr int FIN_THREADS = 256;
constexpr int SUB = 4;            // sub-cells per cell edge for the Morton order

}  // namespace

// Must match CellCfg in torchmd_tpu_torch/ops/cell.py field by field.
struct CellCfg {
  int natoms;
  int capacity;
  int ncx, ncy, ncz;
  int nexcl;      // width of the exclusion table
  int ntypes;     // side of the NBFIX tables (0: Lorentz-Berthelot rows)
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_switch;
  int cell0, cell1;  // the slab's cells [cell0, cell1) (all: 0, ncells)
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

__device__ __forceinline__ int tiles_per_cell(const CellCfg& cfg) {
  return (cfg.capacity + tiles::TILE - 1) / tiles::TILE;
}

// Morton index of a sub-cell (2 bits per axis, x lowest).
__device__ __forceinline__ int morton(int a, int b, int c) {
  return (a & 1) | ((b & 1) << 1) | ((c & 1) << 2) | ((a & 2) << 2) | ((b & 2) << 3) |
         ((c & 2) << 4);
}

// Sub-cell coordinate of x along an axis of `nc` cells per box edge:
// trunc((x * (nc / box) - cell) * SUB), clamped; the rounding is spelled
// out so that ops/cell.py's plain version gives the same integers.
__device__ __forceinline__ int sub_cell(float x, float scale, int cell) {
  const float f = __fmul_rn(__fsub_rn(__fmul_rn(x, scale), (float)cell), (float)SUB);
  return min(max((int)f, 0), SUB - 1);
}

// One block per cell: the cell's atoms in Morton order of their sub-cells
// (ties by slot), packed, and each 32-slot tile's bounding box.
__global__ void __launch_bounds__(PREP_THREADS)
cell_prep(const float* __restrict__ pos, const float* __restrict__ q,
          const float* __restrict__ sig, const float* __restrict__ eps,
          const int32_t* __restrict__ types, const int32_t* __restrict__ slots,
          const int32_t* __restrict__ counts, const float* __restrict__ box,
          const __grid_constant__ CellCfg cfg, float4* __restrict__ pq,
          float4* __restrict__ aux, float4* __restrict__ tbox) {
  extern __shared__ float4 prep_smem[];
  const int cap = cfg.capacity;
  float4* sorted = prep_smem;                              // (cap) positions
  int* key = reinterpret_cast<int*>(sorted + cap);         // (cap)
  const int c = blockIdx.x;
  const int cz = c % cfg.ncz;
  const int cy = (c / cfg.ncz) % cfg.ncy;
  const int cx = c / (cfg.ncz * cfg.ncy);
  const int cnt = min(counts[c], cap);
  const float scx = (float)cfg.ncx / box[0];
  const float scy = (float)cfg.ncy / box[1];
  const float scz = (float)cfg.ncz / box[2];
  for (int k = threadIdx.x; k < cnt; k += PREP_THREADS) {
    const int i = slots[c * cap + k];
    const int m = morton(sub_cell(pos[3 * i], scx, cx), sub_cell(pos[3 * i + 1], scy, cy),
                         sub_cell(pos[3 * i + 2], scz, cz));
    key[k] = (m << 10) | k;  // distinct: k < 1024
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cnt; k += PREP_THREADS) {
    const int mine = key[k];
    int rank = 0;
    for (int m = 0; m < cnt; ++m) rank += key[m] < mine;
    const int i = slots[c * cap + k];
    const float4 p = make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], q[i]);
    pq[c * cap + rank] = p;
    aux[c * cap + rank] = make_float4(sig[i], eps[i], __int_as_float(i),
                                      __int_as_float(types != nullptr ? types[i] : 0));
    sorted[rank] = p;
  }
  __syncthreads();
  const int tpc = tiles_per_cell(cfg);
  for (int t = threadIdx.x; t < tpc; t += PREP_THREADS) {
    float4 lo = make_float4(tiles::FAR, tiles::FAR, tiles::FAR, 0.f);
    float4 hi = make_float4(-tiles::FAR, -tiles::FAR, -tiles::FAR, 0.f);
    for (int k = t * tiles::TILE; k < min(cnt, (t + 1) * tiles::TILE); ++k) {
      const float4 p = sorted[k];
      lo.x = fminf(lo.x, p.x); lo.y = fminf(lo.y, p.y); lo.z = fminf(lo.z, p.z);
      hi.x = fmaxf(hi.x, p.x); hi.y = fmaxf(hi.y, p.y); hi.z = fmaxf(hi.z, p.z);
    }
    tbox[2 * (c * tpc + t)] = lo;
    tbox[2 * (c * tpc + t) + 1] = hi;
  }
}

// Neighbour cell index along one axis and the image shift of its atoms.
__device__ __forceinline__ int wrap_cell(int c, int nc, float box, float& shift) {
  shift = 0.f;
  if (c < 0) { c += nc; shift = -box; }
  else if (c >= nc) { c -= nc; shift = box; }
  return c;
}

template <bool VIRIAL, int ELEC, bool NBFIX>
__global__ void __launch_bounds__(tiles::NSPLIT * 32)
cell_kernel(const float4* __restrict__ pq, const float4* __restrict__ aux,
            const float4* __restrict__ tbox, const int32_t* __restrict__ counts,
            const int32_t* __restrict__ excl, const float* __restrict__ lj_a,
            const float* __restrict__ lj_b, const float* __restrict__ box,
            const __grid_constant__ CellCfg cfg, float* __restrict__ forces,
            double* __restrict__ part,
            unsigned long long* __restrict__ stats) {
  __shared__ tiles::WarpSmem smem[tiles::NSPLIT];
  constexpr int NP = VIRIAL ? 5 : 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpc = tiles_per_cell(cfg);
  const int gt = cfg.cell0 * tpc + blockIdx.x;  // this block's i tile
  const int c = gt / tpc, ti = gt % tpc;
  const int cap = cfg.capacity;
  const int cnt_i = min(counts[c], cap);
  double* wpart = part + NP * (tiles::NSPLIT * gt + w);
  if (ti * tiles::TILE >= cnt_i) {
    tiles::empty_part(wpart, NP);
    return;
  }
  const int cz = c % cfg.ncz;
  const int cy = (c / cfg.ncz) % cfg.ncy;
  const int cx = c / (cfg.ncz * cfg.ncy);
  const float bx = box[0], by = box[1], bz = box[2];
  tiles::WarpSmem& sm = smem[w];
  int nbr = 0;  // lane o < 27: the neighbour cell of stencil offset o
  if (lane < 27) {
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nx = wrap_cell(cx + lane / 9 - 1, cfg.ncx, bx, sh.x);
    const int ny = wrap_cell(cy + (lane / 3) % 3 - 1, cfg.ncy, by, sh.y);
    const int nz = wrap_cell(cz + lane % 3 - 1, cfg.ncz, bz, sh.z);
    nbr = (nx * cfg.ncy + ny) * cfg.ncz + nz;
    sm.shift[lane] = sh;
  }
  __syncwarp();

  const int slot = c * cap + ti * tiles::TILE + lane;
  const bool active = ti * tiles::TILE + lane < cnt_i;
  float4 pi = make_float4(0.f, 0.f, 0.f, 0.f), ai = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) { pi = pq[slot]; ai = aux[slot]; }
  tiles::TileWarp<CellCfg, VIRIAL, ELEC, tiles::StencilWalk<NBFIX>> tw(
      cfg, pq, aux, excl, sm, active, __float_as_int(ai.z), pi.x, pi.y, pi.z, pi.w, ai.x,
      ai.y);
  if (NBFIX) tw.setup(__float_as_int(ai.w), lj_a, lj_b, cfg.ntypes, nullptr);
  for (int oo = 0; oo < 27; ++oo) {
    // the self cell, then offsets 0, 26, 1, 25, ...: opposite cells in turn
    const int o = oo == 0 ? 13 : ((oo & 1) ? (oo - 1) / 2 : 26 - (oo - 1) / 2);
    const int nc = __shfl_sync(tiles::FULL, nbr, o);
    const int cnt_j = min(__ldg(counts + nc), cap);
    const float4 sh = sm.shift[o];
    unsigned keep = tw.cull(tbox, nc * tpc, (cnt_j + tiles::TILE - 1) / tiles::TILE, sh);
    while (keep) {
      const int t = __ffs(keep) - 1;
      keep &= keep - 1;
      tw.visit(nc * cap + t * tiles::TILE, min(tiles::TILE, cnt_j - t * tiles::TILE), o);
    }
  }
  tw.finish(forces, wpart, 0.5, stats);
}

}  // namespace

// Scratch of a call, in bytes: packed rows (2 x ncells x capacity float4),
// tile boxes (2 x ncells x tiles-per-cell float4) and the per-warp
// partials (5 doubles per warp, NSPLIT warps per i tile).
extern "C" long long tmd_cell_scratch_bytes(CellCfg cfg) {
  const long long ncells = (long long)cfg.ncx * cfg.ncy * cfg.ncz;
  const long long tpc = (cfg.capacity + tiles::TILE - 1) / tiles::TILE;
  return 16 * (2 * ncells * cfg.capacity + 2 * ncells * tpc) +
         8 * 5 * tiles::NSPLIT * ncells * tpc;
}

namespace {

void carve(const CellCfg& cfg, void* scratch, float4*& pq, float4*& aux, float4*& tbox,
           double*& part) {
  const long long ncells = (long long)cfg.ncx * cfg.ncy * cfg.ncz;
  const long long tpc = (cfg.capacity + tiles::TILE - 1) / tiles::TILE;
  pq = static_cast<float4*>(scratch);
  aux = pq + ncells * cfg.capacity;
  tbox = aux + ncells * cfg.capacity;
  part = reinterpret_cast<double*>(tbox + 2 * ncells * tpc);
}

// Inputs of the pair kernel.
struct PairArgs {
  const float4 *pq, *aux, *tbox;
  const int32_t *counts, *excl;
  const float *lj_a, *lj_b, *box;
  float* forces;
  double* part;
  unsigned long long* stats;
};

template <bool VIRIAL, int ELEC, bool NBFIX>
void launch_kernel(int ntiles, cudaStream_t s, const CellCfg& cfg, const PairArgs& a) {
  cell_kernel<VIRIAL, ELEC, NBFIX><<<ntiles, tiles::NSPLIT * 32, 0, s>>>(
      a.pq, a.aux, a.tbox, a.counts, a.excl, a.lj_a, a.lj_b, a.box, cfg, a.forces, a.part,
      a.stats);
}

// The pair kernel's instance for the virial flag, the electrostatics kind
// and the NBFIX tables.
template <bool VIRIAL, bool NBFIX>
void launch_pairs(int ntiles, cudaStream_t s, const CellCfg& cfg, const PairArgs& a) {
  switch (cfg.elec_kind) {
    case 0: launch_kernel<VIRIAL, 0, NBFIX>(ntiles, s, cfg, a); break;
    case 1: launch_kernel<VIRIAL, 1, NBFIX>(ntiles, s, cfg, a); break;
    case 2: launch_kernel<VIRIAL, 2, NBFIX>(ntiles, s, cfg, a); break;
    default: launch_kernel<VIRIAL, 3, NBFIX>(ntiles, s, cfg, a);
  }
}

cudaError_t prep(const float* pos, const float* q, const float* sig, const float* eps,
                 const int32_t* types, const int32_t* slots, const int32_t* counts,
                 const float* box, const CellCfg& cfg, float4* pq, float4* aux, float4* tbox,
                 cudaStream_t s) {
  const int ncells = cfg.ncx * cfg.ncy * cfg.ncz;
  const size_t smem = (sizeof(float4) + sizeof(int)) * (size_t)cfg.capacity;
  cell_prep<<<ncells, PREP_THREADS, smem, s>>>(pos, q, sig, eps, types, slots, counts, box,
                                               cfg, pq, aux, tbox);
  return cudaGetLastError();
}

}  // namespace

// pos (N,3) anchored positions, q/sig/eps (N), types (N) int32 LJ types,
// slots (ncells, capacity) int32 with slot k < counts[c] occupied, counts
// (ncells) int32, excl (N, nexcl) int32 (N = empty), lj_a/lj_b the
// (ntypes, ntypes) NBFIX tables or null (Lorentz-Berthelot from sig/eps),
// box (3); scratch of
// tmd_cell_scratch_bytes(cfg) bytes (16-byte aligned); i atoms those of
// the cells [cfg.cell0, cfg.cell1). Outputs: forces (N,3), zeroed first so
// an atom that a capacity overflow dropped from its cell, or one outside
// the slab, reads 0 (the caller redoes an overflowed step); energies (np) as
// [lj-family, electrostatics] and, with `virial`, the raw sums g * d_a^2
// for a = x, y, z; stats (5 uint64, or null) gains the walk's counters
// (tile_pairs.cuh Counters). Returns cudaGetLastError().
extern "C" int tmd_cell_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* types, const int32_t* slots, const int32_t* counts, const int32_t* excl,
    const float* lj_a, const float* lj_b, const float* box, CellCfg cfg, int virial,
    void* scratch, float* forces, float* energies, unsigned long long* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncells = cfg.ncx * cfg.ncy * cfg.ncz;
  if (cfg.capacity < 1 || cfg.capacity > MAX_CAPACITY ||
      (long long)ncells * cfg.capacity > tiles::SLOT_MASK || cfg.cell0 < 0 ||
      cfg.cell1 <= cfg.cell0 || cfg.cell1 > ncells)
    return (int)cudaErrorInvalidValue;
  float4 *pq, *aux, *tbox;
  double* part;
  carve(cfg, scratch, pq, aux, tbox, part);
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
  if (err != cudaSuccess) return (int)err;
  err = prep(pos, q, sig, eps, types, slots, counts, box, cfg, pq, aux, tbox, s);
  if (err != cudaSuccess) return (int)err;
  const int tpc = (cfg.capacity + tiles::TILE - 1) / tiles::TILE;
  const int ntiles = (cfg.cell1 - cfg.cell0) * tpc;  // the slab's i tiles
  const PairArgs a{pq, aux, tbox, counts, excl, lj_a, lj_b, box, forces, part, stats};
  const bool nbfix = lj_a != nullptr;
  if (virial) {
    if (nbfix) launch_pairs<true, true>(ntiles, s, cfg, a);
    else launch_pairs<true, false>(ntiles, s, cfg, a);
  } else {
    if (nbfix) launch_pairs<false, true>(ntiles, s, cfg, a);
    else launch_pairs<false, false>(ntiles, s, cfg, a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int np = virial ? 5 : 2;
  tiles::finish_parts<FIN_THREADS><<<1, FIN_THREADS, 0, s>>>(
      part + (size_t)np * tiles::NSPLIT * cfg.cell0 * tpc, tiles::NSPLIT * ntiles, np,
      energies);
  return (int)cudaGetLastError();
}

// The prep pass alone (tests): packed rows and tile boxes into `scratch`.
extern "C" int tmd_cell_prep(const float* pos, const float* q, const float* sig,
                             const float* eps, const int32_t* types, const int32_t* slots,
                             const int32_t* counts, const float* box, CellCfg cfg,
                             void* scratch, void* stream) {
  if (cfg.capacity < 1 || cfg.capacity > MAX_CAPACITY) return (int)cudaErrorInvalidValue;
  float4 *pq, *aux, *tbox;
  double* part;
  carve(cfg, scratch, pq, aux, tbox, part);
  return (int)prep(pos, q, sig, eps, types, slots, counts, box, cfg, pq, aux, tbox,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
