// Column-pair nonbonded energy, forces and per-axis virial on Hopper
// (sm_90a).
//
// Replaces: torchmd_tpu/ops/pallas_column.py, column_pair_call with its
// kernel _kernel, together with what its caller columns.column_energy_forces
// does around it (the per-slot force scatter and the -0.5 on the virial
// stays with the Python wrapper). The contract is ops/column.py's, on the
// JAX package's layout: islot (ncol, C) z-sorted atoms per (x, y) column,
// jslot (ncol, CE) the same plus z ghosts with jzshift in units of Lz, and
// wstart (ncol, 9, NB) the start (in 128-slot units) of each IBLK-wide i
// block's W-slot window in each of the 3x3 neighbour columns, which covers
// every partner within cutoff + skin. A pair counts when both ids are
// below N, i != j, j is not excluded for i and d^2 <= cutoff^2; energies
// and the returned raw virial sums g * d_a^2 are those of the half-stencil
// sum (self offset at weight 1/2 on the energies, directed offsets at 1).
// The per-pair math is pair_terms.cuh, shared with nonbonded.cu and cell.cu.
//
// What bounds it on this card: FP32 issue, as for cell.cu: the windows hold
// 2.86e8 slot pairs for 1.05e7 unordered pairs inside the cutoff (the
// 62,500-site water box), and a lane-per-pair cutoff branch runs the full
// pair math for most warp steps. So the walk is tile_pairs.cuh's:
//   - a prep pass packs every extended slot (z ghost shift added) as float4
//     rows (x, y, z, q and sigma/2, sqrt|eps|, id; padding at 1e18 A) and
//     the bounding box of every 32 consecutive slots: tiles of a z-sorted
//     column are thin slabs, which the culling cuts by z;
//   - one block of two warps per 32 consecutive i slots of a column (lane
//     k the slot's atom) walks, for each of the 9 neighbour columns (the
//     self column, then opposite offsets in turn), the j tiles of the union
//     of its (one or two) i blocks' windows, culls by box, shares the
//     survivors out between its warps, queues each lane's pairs inside the
//     cutoff and runs the pair math on full warps;
//   - the whole 3x3 stencil, not the half stencil with Newton's third law:
//     every ordered pair once, each lane the owner of its atom's share of
//     the force (each atom sits in one i slot), which meets the other
//     warp's in two atomic additions onto zero, so forces are bitwise
//     deterministic; the energies carry 1/2 and the raw virial sums equal
//     the half stencil's weighted ones;
//   - energies and virial sums sum per warp in f64 and a finishing kernel
//     adds the warps in a fixed order.
// The VIRIAL template flag carries the virial sums; without it they cost
// nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tile_pairs.cuh"

namespace {

constexpr int STRIDE = 128;       // window starts are in units of 128 slots
constexpr int PREP_THREADS = 128;
constexpr int FIN_THREADS = 256;

}  // namespace

// Must match ColumnCfg in torchmd_tpu_torch/ops/column.py field by field.
struct ColumnCfg {
  int natoms;
  int ncx, ncy;
  int C, CE, W, NB, iblk;
  int nexcl;      // width of the exclusion table
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_switch;
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

__device__ __host__ __forceinline__ int tiles_per_column(const ColumnCfg& cfg) {
  return (cfg.C + tiles::TILE - 1) / tiles::TILE;
}

// One thread per extended slot, one warp per 32-slot tile: packed rows
// with the z ghost shift added, and the tile's bounding box.
__global__ void __launch_bounds__(PREP_THREADS)
column_prep(const float* __restrict__ pos, const float* __restrict__ q,
            const float* __restrict__ sig, const float* __restrict__ eps,
            const int32_t* __restrict__ jslot, const float* __restrict__ jzshift,
            const float* __restrict__ box, const __grid_constant__ ColumnCfg cfg,
            float4* __restrict__ pq, float4* __restrict__ aux, float4* __restrict__ tbox) {
  const int s = blockIdx.x * PREP_THREADS + threadIdx.x;  // ncol * CE, a multiple of 128
  const int j = jslot[s];
  const bool valid = j < cfg.natoms;
  float4 p = make_float4(tiles::FAR, tiles::FAR, tiles::FAR, 0.f);
  float4 a = make_float4(0.f, 0.f, __int_as_float(cfg.natoms), 0.f);
  if (valid) {
    p = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2] + jzshift[s] * box[2], q[j]);
    a = make_float4(sig[j], eps[j], __int_as_float(j), 0.f);
  }
  pq[s] = p;
  aux[s] = a;
  float4 lo, hi;
  tiles::warp_box(valid, p.x, p.y, p.z, lo, hi);
  if ((threadIdx.x & 31) == 0) {
    tbox[2 * (s / tiles::TILE)] = lo;
    tbox[2 * (s / tiles::TILE) + 1] = hi;
  }
}

template <bool VIRIAL, int ELEC>
__global__ void __launch_bounds__(tiles::NSPLIT * 32)
column_kernel(const float* __restrict__ pos, const float* __restrict__ q,
              const float* __restrict__ sig, const float* __restrict__ eps,
              const int32_t* __restrict__ excl, const int32_t* __restrict__ islot,
              const int32_t* __restrict__ wstart, const float* __restrict__ box,
              const float4* __restrict__ pq, const float4* __restrict__ aux,
              const float4* __restrict__ tbox, const __grid_constant__ ColumnCfg cfg,
              float* __restrict__ forces, double* __restrict__ part,
              unsigned long long* __restrict__ stats) {
  __shared__ tiles::WarpSmem smem[tiles::NSPLIT];
  constexpr int NP = VIRIAL ? 5 : 2;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gt = blockIdx.x;  // this block's i tile
  const int tpc = tiles_per_column(cfg);
  const int c = gt / tpc, ti = gt % tpc;
  const int n = cfg.natoms;
  const int k0 = ti * tiles::TILE;
  const int i = k0 + lane < cfg.C ? islot[c * cfg.C + k0 + lane] : n;
  const bool active = i < n;
  double* wpart = part + NP * (tiles::NSPLIT * gt + w);
  if (!__any_sync(tiles::FULL, active)) {
    tiles::empty_part(wpart, NP);
    return;
  }
  const float bx = box[0], by = box[1];
  const int cx = c / cfg.ncy, cy = c % cfg.ncy;
  tiles::WarpSmem& sm = smem[w];
  int nbr = 0;  // lane o9 < 9: the neighbour column of offset o9
  if (lane < 9) {
    const int tx = cx + lane / 3 - 1, ty = cy + lane % 3 - 1;
    sm.shift[lane] = make_float4(tx < 0 ? -bx : (tx >= cfg.ncx ? bx : 0.f),
                                 ty < 0 ? -by : (ty >= cfg.ncy ? by : 0.f), 0.f, 0.f);
    nbr = ((tx + cfg.ncx) % cfg.ncx) * cfg.ncy + (ty + cfg.ncy) % cfg.ncy;
  }
  __syncwarp();
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, si = 0.f, ei = 0.f;
  if (active) {
    xi = pos[3 * i]; yi = pos[3 * i + 1]; zi = pos[3 * i + 2];
    qi = q[i]; si = sig[i]; ei = eps[i];
  }
  tiles::TileWarp<ColumnCfg, VIRIAL, ELEC> tw(cfg, pq, aux, excl, sm, active, i, xi, yi, zi,
                                        qi, si, ei);
  // the (one or two) i blocks this tile's slots fall in
  const int b0 = k0 / cfg.iblk;
  const int b1 = min(k0 + tiles::TILE - 1, cfg.C - 1) / cfg.iblk;
  const int jtiles = cfg.CE / tiles::TILE;
  for (int oo = 0; oo < 9; ++oo) {
    // the self column, then offsets 0, 8, 1, 7, ...: opposite columns in turn
    const int o9 = oo == 0 ? 4 : ((oo & 1) ? (oo - 1) / 2 : 8 - (oo - 1) / 2);
    const int cj = __shfl_sync(tiles::FULL, nbr, o9);
    const int* ws = wstart + (c * 9 + o9) * cfg.NB;
    const int w0 = ws[b0];
    const int w1 = b1 != b0 ? ws[b1] : -1;
    int lo = INT_MAX, hi = 0;  // the union of the valid blocks' windows
    if (w0 >= 0) { lo = w0 * STRIDE; hi = w0 * STRIDE + cfg.W; }
    if (w1 >= 0) { lo = min(lo, w1 * STRIDE); hi = max(hi, w1 * STRIDE + cfg.W); }
    if (hi == 0) continue;
    const float4 sh = sm.shift[o9];
    for (int t0 = lo / tiles::TILE; t0 < hi / tiles::TILE; t0 += tiles::TILE) {
      unsigned keep = tw.cull(tbox, cj * jtiles + t0, min(tiles::TILE, hi / tiles::TILE - t0),
                              sh);
      while (keep) {
        const int t = t0 + __ffs(keep) - 1;
        keep &= keep - 1;
        tw.visit(cj * cfg.CE + t * tiles::TILE, tiles::TILE, o9);
      }
    }
  }
  tw.finish(forces, wpart, 0.5, stats);
}

void carve(const ColumnCfg& cfg, void* scratch, float4*& pq, float4*& aux, float4*& tbox,
           double*& part) {
  const long long slots = (long long)cfg.ncx * cfg.ncy * cfg.CE;
  pq = static_cast<float4*>(scratch);
  aux = pq + slots;
  tbox = aux + slots;
  part = reinterpret_cast<double*>(tbox + 2 * (slots / tiles::TILE));
}

// The pair kernel's instance for the virial flag and electrostatics kind.
template <bool VIRIAL>
void launch_pairs(int ntiles, cudaStream_t s, const float* pos, const float* q,
                  const float* sig, const float* eps, const int32_t* excl,
                  const int32_t* islot, const int32_t* wstart, const float* box,
                  const float4* pq, const float4* aux, const float4* tbox,
                  const ColumnCfg& cfg, float* forces, double* part,
                  unsigned long long* stats) {
  constexpr int threads = tiles::NSPLIT * 32;
  switch (cfg.elec_kind) {
    case 0:
      column_kernel<VIRIAL, 0><<<ntiles, threads, 0, s>>>(
          pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox, cfg, forces, part, stats);
      break;
    case 1:
      column_kernel<VIRIAL, 1><<<ntiles, threads, 0, s>>>(
          pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox, cfg, forces, part, stats);
      break;
    case 2:
      column_kernel<VIRIAL, 2><<<ntiles, threads, 0, s>>>(
          pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox, cfg, forces, part, stats);
      break;
    default:
      column_kernel<VIRIAL, 3><<<ntiles, threads, 0, s>>>(
          pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox, cfg, forces, part, stats);
  }
}

cudaError_t prep(const float* pos, const float* q, const float* sig, const float* eps,
                 const int32_t* jslot, const float* jzshift, const float* box,
                 const ColumnCfg& cfg, float4* pq, float4* aux, float4* tbox,
                 cudaStream_t s) {
  const int slots = cfg.ncx * cfg.ncy * cfg.CE;
  column_prep<<<slots / PREP_THREADS, PREP_THREADS, 0, s>>>(pos, q, sig, eps, jslot, jzshift,
                                                           box, cfg, pq, aux, tbox);
  return cudaGetLastError();
}

bool valid_cfg(const ColumnCfg& cfg) {
  return cfg.iblk >= 1 && cfg.W >= STRIDE && cfg.W % STRIDE == 0 && cfg.CE % STRIDE == 0 &&
         cfg.C >= cfg.iblk && (long long)cfg.ncx * cfg.ncy * cfg.CE <= tiles::SLOT_MASK;
}

}  // namespace

// Scratch of a call, in bytes: packed rows (2 x ncol x CE float4), j tile
// boxes (2 x ncol x CE / 32 float4) and the per-warp partials (5 doubles
// per warp, NSPLIT warps per i tile).
extern "C" long long tmd_column_scratch_bytes(ColumnCfg cfg) {
  const long long slots = (long long)cfg.ncx * cfg.ncy * cfg.CE;
  const long long itiles = (long long)cfg.ncx * cfg.ncy * tiles_per_column(cfg);
  return 16 * (2 * slots + 2 * (slots / tiles::TILE)) + 8 * 5 * tiles::NSPLIT * itiles;
}

// pos (N,3) anchored positions, q/sig/eps (N), excl (N, nexcl) int32 (N =
// empty), islot (ncol, C), jslot (ncol, CE) int32 (N = padding), jzshift
// (ncol, CE) in units of Lz, wstart (ncol, 9, NB) int32 in units of 128
// slots (-1 = skip), box (3); scratch of tmd_column_scratch_bytes(cfg)
// bytes (16-byte aligned). Outputs: forces (N,3), zeroed first; out (5) as
// [lj-family energy, electrostatic energy] and, with `virial`, the
// weighted raw sums g * d_a^2 for a = x, y, z (the caller applies -0.5);
// stats (5 uint64, or null) gains the walk's counters (tile_pairs.cuh
// Counters). Returns cudaGetLastError().
extern "C" int tmd_column_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* excl, const int32_t* islot, const int32_t* jslot,
    const float* jzshift, const int32_t* wstart, const float* box, ColumnCfg cfg,
    int virial, void* scratch, float* forces, float* out, unsigned long long* stats,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_cfg(cfg)) return (int)cudaErrorInvalidValue;
  float4 *pq, *aux, *tbox;
  double* part;
  carve(cfg, scratch, pq, aux, tbox, part);
  cudaError_t err = cudaMemsetAsync(forces, 0, sizeof(float) * 3 * (size_t)cfg.natoms, s);
  if (err != cudaSuccess) return (int)err;
  err = prep(pos, q, sig, eps, jslot, jzshift, box, cfg, pq, aux, tbox, s);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = cfg.ncx * cfg.ncy * tiles_per_column(cfg);
  if (virial)
    launch_pairs<true>(ntiles, s, pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox, cfg,
                       forces, part, stats);
  else
    launch_pairs<false>(ntiles, s, pos, q, sig, eps, excl, islot, wstart, box, pq, aux, tbox,
                        cfg, forces, part, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiles::finish_parts<FIN_THREADS><<<1, FIN_THREADS, 0, s>>>(
      part, tiles::NSPLIT * ntiles, virial ? 5 : 2, out);
  return (int)cudaGetLastError();
}

// The prep pass alone (tests): packed rows and j tile boxes into `scratch`.
extern "C" int tmd_column_prep(const float* pos, const float* q, const float* sig,
                               const float* eps, const int32_t* jslot, const float* jzshift,
                               const float* box, ColumnCfg cfg, void* scratch, void* stream) {
  if (!valid_cfg(cfg)) return (int)cudaErrorInvalidValue;
  float4 *pq, *aux, *tbox;
  double* part;
  carve(cfg, scratch, pq, aux, tbox, part);
  return (int)prep(pos, q, sig, eps, jslot, jzshift, box, cfg, pq, aux, tbox,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
