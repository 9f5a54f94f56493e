// Native geometry core — C++ implementation of the decomposition math.
//
// The reference implements all of this in C++ (getSplits common.h:579-589,
// cudecompGetPencilInfoVersioned src/cudecomp.cc:1317-1379,
// cudecompGetShiftedRank :1710-1755).  This library is the JAX rebuild's
// native equivalent: a small C-ABI shared object used by the Python layer
// (via ctypes) for the hot host-side paths — autotuner candidate sweeps
// evaluate pencil geometry for many (pdims x layout) configurations — with
// the pure-Python implementation kept as the portable fallback and
// correctness oracle (tests/test_native.py checks bit-identical parity).
//
// Build: make -C csrc  (or the auto-build in cudecomp_tpu/utils/native.py)

#include <cstdint>
#include <algorithm>

extern "C" {

// Split n into p chunks, remainder to the lowest chunks; `excess` is added
// to the last populated chunk (the gdims_dist tack-on).
void cd_get_splits(int64_t n, int32_t p, int64_t excess, int64_t* out) {
  if (p <= 0) return;
  int64_t base = n / p;
  int64_t rem = n % p;
  for (int32_t i = 0; i < p; ++i) out[i] = base + (i < rem ? 1 : 0);
  if (excess != 0) {
    int64_t idx = std::min<int64_t>(n, p) - 1;
    if (idx >= 0) out[idx] += excess;
  }
}

void cd_get_split_offsets(int64_t n, int32_t p, int64_t* out) {
  if (p <= 0) return;
  int64_t base = n / p;
  int64_t rem = n % p;
  for (int32_t i = 0; i < p; ++i) out[i] = i * base + std::min<int64_t>(i, rem);
}

// Pencil info for pencil `axis` at process-grid coords (pr, pc).
// order[i] = global axis stored in array dim i (C-order, dim 2 contiguous).
// shape/lo/hi are written in memory order; shape includes 2*halo + padding
// while lo/hi are the interior global bounds (hi inclusive).
// Returns 0 on success, nonzero on invalid arguments.
int32_t cd_pencil_info(const int64_t gdims[3], const int64_t gdims_dist[3],
                       const int32_t pdims[2], const int32_t order[3],
                       int32_t axis, int32_t pr, int32_t pc,
                       const int32_t halo[3], const int32_t pad[3],
                       int64_t shape[3], int64_t lo[3], int64_t hi[3],
                       int64_t* size) {
  if (axis < 0 || axis > 2) return 1;
  if (pr < 0 || pr >= pdims[0] || pc < 0 || pc >= pdims[1]) return 2;
  // order must be a permutation of {0,1,2}: an out-of-range value would
  // write past the inv[] stack buffer below instead of erroring
  {
    int32_t seen = 0;
    for (int i = 0; i < 3; ++i) {
      if (order[i] < 0 || order[i] > 2) return 3;
      seen |= 1 << order[i];
    }
    if (seen != 0b111) return 3;
  }
  int32_t inv[3];
  for (int i = 0; i < 3; ++i) inv[order[i]] = i;
  const int32_t coords[2] = {pr, pc};
  int64_t sz = 1;
  int j = 0;
  for (int i = 0; i < 3; ++i) {
    int ord = inv[i];
    if (i != axis) {
      int64_t nd = gdims_dist[i];
      int64_t d = nd / pdims[j];
      int64_t mod = nd % pdims[j];
      int64_t s = d + (coords[j] < mod ? 1 : 0);
      if (coords[j] == std::min<int64_t>(pdims[j], nd) - 1) {
        s += gdims[i] - nd;
      }
      shape[ord] = s;
      lo[ord] = coords[j] * d + std::min<int64_t>(coords[j], mod);
      j++;
    } else {
      shape[ord] = gdims[i];
      lo[ord] = 0;
    }
    hi[ord] = lo[ord] + shape[ord] - 1;
    shape[ord] += 2 * static_cast<int64_t>(halo[i]) + pad[i];
    sz *= shape[ord];
  }
  *size = sz;
  return 0;
}

// rank_order: 0 = row-major (rank = pr*Pc + pc), 1 = col-major.
static void coords_of_rank(const int32_t pdims[2], int32_t rank_order,
                           int32_t rank, int32_t* pr, int32_t* pc) {
  if (rank_order == 0) {
    *pr = rank / pdims[1];
    *pc = rank % pdims[1];
  } else {
    *pr = rank % pdims[0];
    *pc = rank / pdims[0];
  }
}

static int32_t rank_of_coords(const int32_t pdims[2], int32_t rank_order,
                              int32_t pr, int32_t pc) {
  return rank_order == 0 ? pr * pdims[1] + pc : pc * pdims[0] + pr;
}

// Mirrors cudecompGetShiftedRank (src/cudecomp.cc:1710-1755).
// Returns the neighbor's global rank, -1 for off-domain (non-periodic),
// or -2 for invalid arguments.
int32_t cd_shifted_rank(const int32_t pdims[2], int32_t rank_order,
                        int32_t axis, int32_t dim, int32_t displacement,
                        int32_t periodic, int32_t rank) {
  if (axis < 0 || axis > 2 || dim < 0 || dim > 2) return -2;
  if (rank < 0 || rank >= pdims[0] * pdims[1]) return -2;
  if (displacement == 0) return rank;
  if (dim == axis) return periodic ? rank : -1;
  // first non-axis dim -> pdims[0], second -> pdims[1]
  int pd = 0;
  for (int i = 0; i < 3; ++i) {
    if (i == axis) continue;
    if (i == dim) break;
    pd++;
  }
  int32_t coords[2];
  coords_of_rank(pdims, rank_order, rank, &coords[0], &coords[1]);
  int32_t shifted = coords[pd] + displacement;
  int32_t n = pdims[pd];
  if (!periodic && (shifted < 0 || shifted >= n)) return -1;
  coords[pd] = ((shifted % n) + n) % n;
  return rank_of_coords(pdims, rank_order, coords[0], coords[1]);
}

}  // extern "C"
