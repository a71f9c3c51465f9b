// Dense all-pairs nonbonded energy and forces on Hopper (sm_90a): a culled
// walk over 32-atom tiles in the caller's order, on the tile walk of
// tile_pairs.cuh (shared with cell.cu and column.cu; the per-pair term
// math is pair_terms.cuh).
//
// Replaces: torchmd_tpu/ops/pallas_nonbonded.py, pallas_nonbonded_energy_forces
// with its kernels _kernel_tri (the Newton-half schedule) and _kernel (the
// full square); the per-pair math is pair_terms. Same inputs (per-atom
// charge, sigma/2 and sqrt|eps| rows or NBFIX A/B tables by type, the
// exclusions of the int8 mask), same outputs (0.5-weighted
// lj/electrostatics energies, forces (N, 3)), same branches: LJ with the
// polynomial switch, repulsion A/r^12, repulsioncg B/r^6, Coulomb plain /
// reaction field / Ewald erfc, a cutoff or none, and a minimum-image wrap
// on a diagonal box where a 0 component means no wrap on that axis.
//
// What bounds it on this card: the pairs inside the cutoff. A protein's
// atoms in sequence order are already in space order: on thrombin (4,676
// atoms, cutoff 7.3 A) 32-atom tiles span ~8 x 8 x 8 A, and 6,567 of the
// 21,609 ordered tile pairs (30 %) have box gaps within the cutoff (6.6 M
// slot pairs of the 21.9 M of the square, 565 k non-excluded ordered pairs
// inside it). The function needs ~0.28 M unordered pairs' ~60 f32
// operations each (~0.25 us of the FP32 peak) and ~0.2 MB of rows, forces
// and exclusion words, so the kernel is bound by instruction throughput
// and latency: culling, testing slots, the pair math, and its two
// launches. Two launches a call:
//   - pair_prep packs float4 rows (x, y, z, q and sigma/2, sqrt|eps|, id,
//     type) and the bounding box of every 32-atom tile, and zeroes the
//     walk's counters;
//   - pair_walk: persistent warps take units of work from a counter; a unit
//     is one i tile against up to UNIT candidate j tiles, every upt-th of
//     the row, so that the dense j range around the i tile (neighbours in
//     sequence) spreads over upt units. A warp culls its candidates by box
//     (under the minimum image with PBC; nothing is culled without a
//     cutoff), queues each lane's in-cutoff, non-excluded slots of every
//     survivor and runs the pair math on full warps (tile_pairs.cuh's
//     DenseWalk);
//   - exclusions: the (N, N) mask is not read. prepare_nb_data turns it
//     once per topology into a 32-bit word per i atom for each tile pair
//     that holds an exclusion (CSR by i tile, j tiles ascending); a warp
//     walks its survivors in ascending j and advances a cursor through its
//     i tile's list, so excluded pairs are never queued;
//   - each unit writes its force rows and energies to its own partials; the
//     last unit of an i tile to arrive (an atomic counter after a fence)
//     sums the tile's partials in unit order, and the last tile the tiles'
//     energies in a fixed order: no float atomics, and forces and energies
//     are bitwise deterministic.
//   - a replica axis: one call takes R conformations of one topology
//     (pos (R, N, 3), a box per replica or none) and gives R force arrays
//     and R energy pairs, as the vmapped Pallas call does for a replica
//     ladder (torchmd_tpu/integrator.py:547). The prep pass takes the
//     replica on blockIdx.y and packs each replica's rows and tile boxes
//     (the per-atom sigma, eps, id and type rows once: they are the
//     topology's); the walk's units of work run over all R replicas from
//     one counter, each with its replica's rows, box, partials and arrival
//     counters. The exclusion words and type tables are shared. A
//     replica's unit decomposition and summation order are those of a
//     one-replica call, so its forces and energies equal that call's bit
//     for bit.
//   - a row range (the spatially sharded path, torchmd_tpu/parallel/
//     spatial.py:64-77, rowblock_energy_forces): the i tiles [it0, it1)
//     against all atoms. The prep pass still packs every tile (the j
//     side is all atoms); the walk's counter runs over the range's units
//     only, each with the unit index, partials and arrival counter of
//     the full call, and the forces come out for the range's rows. A
//     range's rows equal the same rows of the full call bit for bit (the
//     same units, summed in the same order); its energies are the
//     range's tiles' sums.
// Not built: Newton's third law (3,355 unordered tile pairs on thrombin
// instead of 6,567 ordered ones), which needs a second owner of each force
// row. Each (PBC, NBFIX, cutoff, electrostatics kind) has its own
// instance, so that a loop carries only its own code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_pairs.cuh"

namespace {

constexpr int PREP_THREADS = 128;
constexpr int WARPS = tiles::NSPLIT;  // warps per walk block
constexpr int UNIT = 8;               // candidate j tiles per unit of work (<= 32)
constexpr int BLOCKS_PER_SM = 8;      // persistent walk blocks per SM
constexpr int ROW = 3 * tiles::TILE;  // force components of one tile

}  // namespace

// Must match PairCfg in torchmd_tpu_torch/ops/nonbonded.py field by field.
struct PairCfg {
  int natoms;
  int ntypes;
  int lj_kind;    // 0 none, 1 lj, 2 repulsion, 3 repulsioncg
  int elec_kind;  // 0 none, 1 coulomb, 2 reaction field, 3 ewald
  int use_cutoff;
  int use_switch;
  int pbc;        // read by the host entry only (template flag)
  int nrep;       // replicas of the call (>= 1)
  int it0, it1;   // the i tiles [it0, it1) (all: 0, ceil(natoms / 32))
  float cutoff2;
  float switch_dist;
  float inv_switch_width;
  float krf;
  float crf;
  float ewald_alpha;
  float elec_factor;
};

namespace {

__host__ __device__ __forceinline__ int num_tiles(int n) {
  return (n + tiles::TILE - 1) / tiles::TILE;
}

__host__ __device__ __forceinline__ int units_per_tile(int T) { return (T + UNIT - 1) / UNIT; }

// Scratch layout of one call of R replicas.
struct Scratch {
  float4* pq;      // (R, T * 32) x, y, z, q
  float4* aux;     // (T * 32) sigma/2, sqrt|eps|, id bits, type bits
  float4* tbox;    // (R, 2 T) tile boxes lo, hi
  double* epart;   // (R, units, 2) per-unit energies
  double* etile;   // (R, T, 2) per-tile energies
  float* fpart;    // (R, units, 96) per-unit force rows
  int* counters;   // (R (T + 1) + 1) per replica: arrivals per i tile and
                   // tiles finished; then the next unit of all replicas
};

long long carve(const PairCfg& cfg, void* base, Scratch* s) {
  const long long R = cfg.nrep;
  const long long T = num_tiles(cfg.natoms);
  const long long units = T * units_per_tile((int)T);
  char* p = static_cast<char*>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* q = p == nullptr ? nullptr : p + off;
    off += (bytes + 15) / 16 * 16;
    return q;
  };
  char* pq = take(16 * R * T * tiles::TILE);
  char* aux = take(16 * T * tiles::TILE);
  char* tbox = take(16 * 2 * R * T);
  char* epart = take(8 * 2 * R * units);
  char* etile = take(8 * 2 * R * T);
  char* fpart = take(4 * (long long)ROW * R * units);
  char* counters = take(4 * (R * (T + 1) + 1));
  if (s != nullptr) {
    s->pq = reinterpret_cast<float4*>(pq);
    s->aux = reinterpret_cast<float4*>(aux);
    s->tbox = reinterpret_cast<float4*>(tbox);
    s->epart = reinterpret_cast<double*>(epart);
    s->etile = reinterpret_cast<double*>(etile);
    s->fpart = reinterpret_cast<float*>(fpart);
    s->counters = reinterpret_cast<int*>(counters);
  }
  return off;
}

// One warp per tile and replica (blockIdx.y): packed rows, the tile's
// box; the replica-0 blocks write the shared aux rows, block (0, 0)
// zeroes the walk's counters.
__global__ void __launch_bounds__(PREP_THREADS)
pair_prep(const float* __restrict__ pos, const float* __restrict__ q,
          const float* __restrict__ sig, const float* __restrict__ eps,
          const int32_t* __restrict__ types, const __grid_constant__ PairCfg cfg,
          float4* __restrict__ pq, float4* __restrict__ aux, float4* __restrict__ tbox,
          int* __restrict__ counters) {
  const int n = cfg.natoms, T = num_tiles(n), rr = blockIdx.y;
  if (blockIdx.x == 0 && rr == 0)
    for (int k = threadIdx.x; k <= cfg.nrep * (T + 1); k += PREP_THREADS) counters[k] = 0;
  const int t = blockIdx.x * (PREP_THREADS / 32) + (threadIdx.x >> 5);
  if (t >= T) return;
  const int lane = threadIdx.x & 31, i = t * tiles::TILE + lane;
  const bool active = i < n;
  pos += (size_t)rr * 3 * n;
  pq += (size_t)rr * T * tiles::TILE;
  tbox += (size_t)rr * 2 * T;
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f), a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    p = make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], q[i]);
    a = make_float4(sig[i], eps[i], __int_as_float(i),
                    __int_as_float(types != nullptr ? types[i] : 0));
  }
  pq[i] = p;
  if (rr == 0) aux[i] = a;
  float4 lo, hi;
  tiles::warp_box(active, p.x, p.y, p.z, lo, hi);
  if (lane == 0) {
    tbox[2 * t] = lo;
    tbox[2 * t + 1] = hi;
  }
}

// Persistent warps take units of work from a counter: a unit is one i
// tile of the range [it0, it1) of one replica against up to UNIT
// candidate j tiles, every upt-th of them; replica r owns counter values
// [r runits, (r + 1) runits), runits = (it1 - it0) upt. The last unit of
// an i tile to finish sums the tile's force rows in unit order, the last
// tile of the range its energies.
template <bool PBC, bool NBFIX, bool CUTOFF, int ELEC>
__global__ void __launch_bounds__(WARPS * 32)
pair_walk(const float4* __restrict__ pq_all, const float4* __restrict__ aux,
          const float4* __restrict__ tbox_all, const int32_t* __restrict__ xstart,
          const int32_t* __restrict__ xtile, const uint32_t* __restrict__ xbits,
          const float* __restrict__ lj_a, const float* __restrict__ lj_b,
          const float* __restrict__ box_all, const __grid_constant__ PairCfg cfg,
          float* __restrict__ fpart_all, double* __restrict__ epart_all,
          double* __restrict__ etile_all, int* __restrict__ counters_all,
          float* __restrict__ forces_all, float* __restrict__ energies_all,
          unsigned long long* __restrict__ stats) {
  __shared__ tiles::WarpSmem smem[WARPS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = cfg.natoms, T = num_tiles(n), upt = units_per_tile(T), units = T * upt;
  const int nt = cfg.it1 - cfg.it0, runits = nt * upt;
  const int nrows = min(n, cfg.it1 * tiles::TILE) - cfg.it0 * tiles::TILE;
  int* const next = counters_all + (size_t)cfg.nrep * (T + 1);
  while (true) {
    int u = 0;
    if (lane == 0) u = atomicAdd(next, 1);
    u = __shfl_sync(tiles::FULL, u, 0);
    if (u >= cfg.nrep * runits) break;
    // the replica's rows, box, partials, counters and outputs; u becomes
    // the full call's unit index
    const int rep = u / runits;
    u = u - rep * runits + cfg.it0 * upt;
    const float4* __restrict__ pq = pq_all + (size_t)rep * T * tiles::TILE;
    const float4* __restrict__ tbox = tbox_all + (size_t)rep * 2 * T;
    const float* __restrict__ box = PBC ? box_all + 3 * rep : box_all;
    float* __restrict__ fpart = fpart_all + (size_t)rep * units * ROW;
    double* __restrict__ epart = epart_all + (size_t)rep * 2 * units;
    double* __restrict__ etile = etile_all + (size_t)rep * 2 * T;
    int* __restrict__ counters = counters_all + (size_t)rep * (T + 1);
    float* __restrict__ forces = forces_all + (size_t)rep * 3 * nrows;
    float* __restrict__ energies = energies_all + 2 * rep;
    // unit r of tile it: candidates r, r + upt, r + 2 upt, ... (<= UNIT),
    // so that the dense j range around the i tile spreads over the units
    const int it = u / upt, r = u - it * upt;
    const int ncand = (T - r + upt - 1) / upt;
    const int i = it * tiles::TILE + lane;
    const float4 pi = pq[i], ai = aux[i];
    tiles::TileWarp<PairCfg, false, ELEC, tiles::DenseWalk<PBC, NBFIX, CUTOFF>> tw(
        cfg, pq, aux, nullptr, smem[w], i < n, i, pi.x, pi.y, pi.z, pi.w, ai.x, ai.y);
    tw.setup(__float_as_int(ai.w), lj_a, lj_b, cfg.ntypes, box);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    tw.load_box(tbox, r, upt, ncand, lo, hi);
    unsigned keep = tw.cull_image(lo, hi, ncand);
    int xp = xstart[it];
    const int xend = xstart[it + 1];
    while (keep) {
      const int jt = r + (__ffs(keep) - 1) * upt;
      keep &= keep - 1;
      // this lane's exclusion word for tile jt: the cursor only moves on
      while (xp < xend && __ldg(xtile + xp) < jt) ++xp;
      unsigned xw = 0u;
      if (xp < xend && __ldg(xtile + xp) == jt) xw = __ldg(xbits + (size_t)tiles::TILE * xp + lane);
      if (jt == it) xw |= 1u << lane;
      tw.take(jt * tiles::TILE, min(tiles::TILE, n - jt * tiles::TILE), 0, xw);
    }
    tw.drain(true);
    float* row = fpart + (size_t)u * ROW;
    row[3 * lane] = tw.fx;
    row[3 * lane + 1] = tw.fy;
    row[3 * lane + 2] = tw.fz;
    tw.put_energies(epart + 2 * (size_t)u, 0.5, stats);

    // the i tile's last unit sums its partials in unit order
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(counters + it, 1) == upt - 1;
    if (!__shfl_sync(tiles::FULL, last, 0)) continue;
    __threadfence();
    const float* tile_rows = fpart + (size_t)it * upt * ROW;
    for (int k = lane; k < ROW && it * tiles::TILE + k / 3 < n; k += 32) {
      float s = 0.f;
      for (int v = 0; v < upt; ++v) s += __ldcg(tile_rows + (size_t)v * ROW + k);
      forces[(size_t)(it - cfg.it0) * ROW + k] = s;
    }
    // lane l sums units l, l + 32, ...; then a fixed shuffle tree
    const double* ep = epart + 2 * (size_t)it * upt;
    double a = 0.0, b = 0.0;
    for (int v = lane; v < upt; v += 32) {
      a += __ldcg(ep + 2 * v);
      b += __ldcg(ep + 2 * v + 1);
    }
    a = tiles::warp_sum(a);
    b = tiles::warp_sum(b);
    if (lane == 0) {
      etile[2 * it] = a;
      etile[2 * it + 1] = b;
    }
    // the range's last tile sums the tiles' energies in a fixed order
    __threadfence();
    __syncwarp();
    if (lane == 0) last = atomicAdd(counters + T, 1) == nt - 1;
    if (!__shfl_sync(tiles::FULL, last, 0)) continue;
    __threadfence();
    a = b = 0.0;
    for (int t = cfg.it0 + lane; t < cfg.it1; t += 32) {
      a += __ldcg(etile + 2 * t);
      b += __ldcg(etile + 2 * t + 1);
    }
    a = tiles::warp_sum(a);
    b = tiles::warp_sum(b);
    if (lane == 0) {
      energies[0] = (float)a;
      energies[1] = (float)b;
    }
  }
}

struct WalkArgs {
  const float4 *pq, *aux, *tbox;
  const int32_t *xstart, *xtile;
  const uint32_t* xbits;
  const float *lj_a, *lj_b, *box;
  float* fpart;
  double *epart, *etile;
  int* counters;
  float *forces, *energies;
  unsigned long long* stats;
};

template <bool PBC, bool NBFIX, bool CUTOFF, int ELEC>
void launch_walk(dim3 grid, cudaStream_t s, const PairCfg& cfg, const WalkArgs& a) {
  pair_walk<PBC, NBFIX, CUTOFF, ELEC><<<grid, WARPS * 32, 0, s>>>(
      a.pq, a.aux, a.tbox, a.xstart, a.xtile, a.xbits, a.lj_a, a.lj_b, a.box, cfg, a.fpart,
      a.epart, a.etile, a.counters, a.forces, a.energies, a.stats);
}

// one instance per electrostatics kind (pair_terms.cuh)
template <bool PBC, bool NBFIX, bool CUTOFF>
void launch_elec(dim3 grid, cudaStream_t s, const PairCfg& cfg, const WalkArgs& a) {
  switch (cfg.elec_kind) {
    case 0: launch_walk<PBC, NBFIX, CUTOFF, 0>(grid, s, cfg, a); break;
    case 1: launch_walk<PBC, NBFIX, CUTOFF, 1>(grid, s, cfg, a); break;
    case 2: launch_walk<PBC, NBFIX, CUTOFF, 2>(grid, s, cfg, a); break;
    default: launch_walk<PBC, NBFIX, CUTOFF, 3>(grid, s, cfg, a);
  }
}

template <bool PBC, bool NBFIX>
void launch_cutoff(dim3 grid, cudaStream_t s, const PairCfg& cfg, const WalkArgs& a) {
  if (cfg.use_cutoff) launch_elec<PBC, NBFIX, true>(grid, s, cfg, a);
  else launch_elec<PBC, NBFIX, false>(grid, s, cfg, a);
}

// Persistent blocks of the walk: BLOCKS_PER_SM per SM of the current
// device, no more than the units of work of the R replicas' nt tiles
// need.
cudaError_t walk_grid(int T, int nt, int R, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long units = (long long)R * nt * units_per_tile(T);
  long long blocks = (units + WARPS - 1) / WARPS;
  if (blocks > (long long)BLOCKS_PER_SM * sms) blocks = (long long)BLOCKS_PER_SM * sms;
  *grid = dim3((unsigned)(blocks < 1 ? 1 : blocks));
  return cudaSuccess;
}

}  // namespace

// Scratch of a call, in bytes (16-byte aligned pieces).
extern "C" long long tmd_pair_scratch_bytes(PairCfg cfg) { return carve(cfg, nullptr, nullptr); }

// pos (R,N,3) for R = cfg.nrep replicas and the i tiles [cfg.it0, cfg.it1),
// q/sig/eps (N), types (N) int32, lj_a/lj_b (T,T) or null
// (null: Lorentz-Berthelot from sig/eps), the exclusions as xstart
// (ceil(N/32) + 1), xtile (X) and xbits (X, 32) (ops/nonbonded.py
// tile_exclusions), box (R,3) or null (no PBC); scratch of
// tmd_pair_scratch_bytes(cfg) bytes. Outputs: forces (R,M,3) of the
// range's M = min(N, 32 it1) - 32 it0 rows (M = N for the full range),
// energies (R,2) as [lj-family, electrostatics] of those rows; stats (5 uint64, or null) gains the
// walk's counters (tile_pairs.cuh Counters). Returns cudaGetLastError().
extern "C" int tmd_pair_energy_forces(
    const float* pos, const float* q, const float* sig, const float* eps,
    const int32_t* types, const float* lj_a, const float* lj_b, const int32_t* xstart,
    const int32_t* xtile, const uint32_t* xbits, const float* box, PairCfg cfg,
    void* scratch, float* forces, float* energies, unsigned long long* stats,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = cfg.natoms;
  if (n < 1 || (long long)num_tiles(n) * tiles::TILE > tiles::SLOT_MASK || cfg.nrep < 1 ||
      cfg.nrep > 65535 || cfg.it0 < 0 || cfg.it1 <= cfg.it0 || cfg.it1 > num_tiles(n) ||
      (long long)cfg.nrep * num_tiles(n) * units_per_tile(num_tiles(n)) > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  Scratch sc;
  carve(cfg, scratch, &sc);
  const int T = num_tiles(n);
  const int prep_blocks = (T + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32);
  pair_prep<<<dim3(prep_blocks, cfg.nrep), PREP_THREADS, 0, s>>>(pos, q, sig, eps, types, cfg, sc.pq, sc.aux,
                                                 sc.tbox, sc.counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const WalkArgs a{sc.pq, sc.aux, sc.tbox, xstart, xtile, xbits, lj_a, lj_b, box,
                   sc.fpart, sc.epart, sc.etile, sc.counters, forces, energies, stats};
  dim3 grid;
  err = walk_grid(T, cfg.it1 - cfg.it0, cfg.nrep, &grid);
  if (err != cudaSuccess) return (int)err;
  const bool nbfix = lj_a != nullptr;
  if (cfg.pbc) {
    if (nbfix) launch_cutoff<true, true>(grid, s, cfg, a);
    else launch_cutoff<true, false>(grid, s, cfg, a);
  } else {
    if (nbfix) launch_cutoff<false, true>(grid, s, cfg, a);
    else launch_cutoff<false, false>(grid, s, cfg, a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tmd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
