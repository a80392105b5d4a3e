// The port's host runtime: the two host-side data-plane functions that the
// host-resident tiers run on the CPU, compiled with g++ -fopenmp into a
// shared library with a plain C interface (kernels/build.py) and driven
// through ctypes (utils/native.py), which validates every argument before
// a pointer reaches this file.
//
//  - dg_gather_rows     out[i] = base[ids[i]] for rows of row_bytes bytes:
//                       the staging hot path of host_tier.HostFeatureStore
//                       and of the host-resident full-graph walk.  ctypes
//                       releases the GIL for the call.
//  - dg_extract_subcsc  the compacted adjacency rows of a node set: the hot
//                       sub-CSC of host_tier.HostCSCStore and each hop's
//                       staged miss rows.
//
// Counterparts of dist_gnn_tpu's csrc/graph_build.cc (same semantics); the
// port keeps its own copy and never loads that library.

#include <cstdint>
#include <cstring>

extern "C" {

// Parallel row gather.  Rows whose id lies outside [0, num_rows) are left
// as they are in out (the caller pre-zeroes out and pre-masks ids).
// Returns 0, or 1 for a non-positive row size.
int dg_gather_rows(int64_t num_ids, const int64_t* ids, const uint8_t* base,
                   int64_t num_rows, int64_t row_bytes, uint8_t* out) {
  if (row_bytes <= 0) return 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < num_ids; ++i) {
    int64_t r = ids[i];
    if (r < 0 || r >= num_rows) continue;
    std::memcpy(out + i * row_bytes, base + r * row_bytes, row_bytes);
  }
  return 0;
}

// Compact the adjacency rows of nids into a sub-CSR.  sub_indptr (length
// num_rows + 1) already holds the exclusive scan of the rows' degrees;
// row i's neighbours (and probs, when both pointers are set) are copied
// to [sub_indptr[i], sub_indptr[i + 1]).  Returns 0.
int dg_extract_subcsc(int64_t num_rows, const int32_t* nids,
                      const int64_t* indptr, const int32_t* indices,
                      const float* probs, const int64_t* sub_indptr,
                      int32_t* sub_indices, float* sub_probs) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < num_rows; ++i) {
    int64_t lo = indptr[nids[i]];
    int64_t hi = indptr[nids[i] + 1];
    int64_t out = sub_indptr[i];
    std::memcpy(sub_indices + out, indices + lo, sizeof(int32_t) * (hi - lo));
    if (probs && sub_probs)
      std::memcpy(sub_probs + out, probs + lo, sizeof(float) * (hi - lo));
  }
  return 0;
}

}  // extern "C"
