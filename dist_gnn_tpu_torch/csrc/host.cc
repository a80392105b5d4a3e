// The port's host runtime: the host-side data-plane functions of graph
// construction and of the host-resident tiers, compiled with g++ -fopenmp
// into a shared library with a plain C interface (kernels/build.py) and
// driven through ctypes (utils/native.py), which validates every argument
// before a pointer reaches this file.
//
//  - dg_gather_rows     out[i] = base[ids[i]] for rows of row_bytes bytes:
//                       the staging hot path of host_tier.HostFeatureStore
//                       and of the host-resident full-graph walk.  ctypes
//                       releases the GIL for the call.
//  - dg_extract_subcsc  the compacted adjacency rows of a node set: the hot
//                       sub-CSC of host_tier.HostCSCStore and each hop's
//                       staged miss rows.
//  - dg_build_csc       CSC (row = destination) from an edge list: a
//                       serial counting sort (graph.HostGraph.from_coo).
//  - dg_build_alias     per-row Walker alias tables for weighted sampling
//                       (graph.HostGraph.build_alias_tables, the hot sub-CSC
//                       of a weighted host_tier.HostCSCStore).
//
// Counterparts of dist_gnn_tpu's csrc/graph_build.cc (same semantics); the
// port keeps its own copy and never loads that library.

#include <algorithm>
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

// Build the CSC (row = dst) of an edge list.  out_indptr [num_nodes + 1]
// must be zeroed; edges whose dst lies outside [0, num_nodes) are skipped
// (the caller rejects them first).  A serial counting sort: degrees, their
// scan, then each edge in edge-list order to its row's next slot, so
// within a row edges keep their edge-list order by construction: the same
// arrays as numpy's argsort(dst, kind="stable").  probs and out_probs may
// both be null.  Returns 0, or 1 for num_nodes <= 0.
int dg_build_csc(int64_t num_edges, int64_t num_nodes, const int32_t* dst,
                 const int32_t* src, const float* probs, int64_t* out_indptr,
                 int32_t* out_indices, float* out_probs) {
  if (num_nodes <= 0) return 1;
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t d = dst[e];
    if (d >= 0 && d < num_nodes) ++out_indptr[d + 1];
  }
  for (int64_t i = 0; i < num_nodes; ++i) out_indptr[i + 1] += out_indptr[i];
  int64_t* cursor = new int64_t[num_nodes];
  std::memcpy(cursor, out_indptr, sizeof(int64_t) * num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t d = dst[e];
    if (d < 0 || d >= num_nodes) continue;
    const int64_t pos = cursor[d]++;
    out_indices[pos] = src[e];
    if (probs && out_probs) out_probs[pos] = probs[e];
  }
  delete[] cursor;
  return 0;
}

// Per-row Walker alias tables.  For each row's span [indptr[r],
// indptr[r + 1]) of weights w, writes prob[e] (an acceptance threshold in
// [0, 1]) and alias[e] (an offset within the row) such that drawing j
// uniform in [0, deg) and taking j if u < prob[j], else alias[j], draws
// edge j with probability w_j / sum(w).  The two-stack build of
// dist_gnn_tpu's dg_build_alias, expression for expression, so the tables
// are equal bit for bit: the total is summed in double in row order, each
// scaled weight is the float product w * deg (float times an integer is a
// float product in C++) over the double total, and the numerical leftovers
// of either stack get prob 1 and alias themselves.  A row whose weights
// sum to <= 0 gets prob 1 and alias itself everywhere.  Returns 0.
int dg_build_alias(int64_t num_rows, const int64_t* indptr,
                   const float* weights, float* prob, int32_t* alias) {
  int64_t max_deg = 0;
  for (int64_t r = 0; r < num_rows; ++r)
    max_deg = std::max<int64_t>(max_deg, indptr[r + 1] - indptr[r]);
#pragma omp parallel
  {
    int32_t* small = new int32_t[max_deg > 0 ? max_deg : 1];
    int32_t* large = new int32_t[max_deg > 0 ? max_deg : 1];
    double* scaled = new double[max_deg > 0 ? max_deg : 1];
#pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < num_rows; ++r) {
      const int64_t lo = indptr[r], hi = indptr[r + 1];
      const int64_t d = hi - lo;
      if (d == 0) continue;
      double total = 0;
      for (int64_t e = lo; e < hi; ++e) total += weights[e];
      if (total <= 0) {
        for (int64_t e = lo; e < hi; ++e) {
          prob[e] = 1.0f;
          alias[e] = static_cast<int32_t>(e - lo);
        }
        continue;
      }
      int64_t ns = 0, nl = 0;
      for (int64_t e = lo; e < hi; ++e) {
        scaled[e - lo] = weights[e] * d / total;
        if (scaled[e - lo] < 1.0)
          small[ns++] = static_cast<int32_t>(e - lo);
        else
          large[nl++] = static_cast<int32_t>(e - lo);
      }
      while (ns > 0 && nl > 0) {
        const int32_t s = small[--ns];
        const int32_t l = large[--nl];
        prob[lo + s] = static_cast<float>(scaled[s]);
        alias[lo + s] = l;
        scaled[l] = scaled[l] - (1.0 - scaled[s]);
        if (scaled[l] < 1.0)
          small[ns++] = l;
        else
          large[nl++] = l;
      }
      while (nl > 0) {
        const int32_t l = large[--nl];
        prob[lo + l] = 1.0f;
        alias[lo + l] = l;
      }
      while (ns > 0) {  // numerical leftovers
        const int32_t s = small[--ns];
        prob[lo + s] = 1.0f;
        alias[lo + s] = s;
      }
    }
    delete[] small;
    delete[] large;
    delete[] scaled;
  }
  return 0;
}

}  // extern "C"
