// graphpack — native host-side graph packing for lanczosnet_tpu.
//
// Replaces the data pipeline's per-graph Python work (the role of the
// reference's utils/data_helper.py collate/preprocess path, SURVEY.md
// §2.1/§3.5) with one multithreaded C++ pass: variable-size per-graph
// dense multi-edge-type adjacency blocks -> fixed-shape padded batch
// arrays with normalized operator stacks
//     channel 0   = normalized merged-graph operator
//     channels 1+ = per-edge-type normalized operators
// matching lanczosnet_tpu/ops/normalize.py:build_operator_stack bit-for
// -bit in float32 (zero-degree guard, masked padding rows/cols).
//
// Exposed as a plain C ABI consumed via ctypes (lanczosnet_tpu/data/
// native.py); no Python.h dependency.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One graph: read adj [E, n, n] (row-major, flat), write padded outputs.
void pack_one(
    const float* adj, const int32_t* atom, int n, int num_edge, int n_max,
    int kind /*0=sym,1=row*/,
    int32_t* atom_out,    // [n_max]
    float* ops_out,       // [E+1, n_max, n_max]
    float* mask_out) {    // [n_max]
  const int ec = num_edge + 1;
  std::memset(ops_out, 0, sizeof(float) * ec * n_max * n_max);
  std::memset(atom_out, 0, sizeof(int32_t) * n_max);
  std::memset(mask_out, 0, sizeof(float) * n_max);
  for (int i = 0; i < n; ++i) {
    atom_out[i] = atom[i];
    mask_out[i] = 1.0f;
  }

  // merged adjacency into channel 0 scratch, per-type into 1..E
  // ops_out layout: channel c at ops_out + c*n_max*n_max
  for (int e = 0; e < num_edge; ++e) {
    const float* a = adj + (size_t)e * n * n;
    float* dst = ops_out + (size_t)(e + 1) * n_max * n_max;
    float* merged = ops_out;  // channel 0
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        const float v = a[(size_t)i * n + j];
        dst[(size_t)i * n_max + j] = v;
        merged[(size_t)i * n_max + j] += v;
      }
    }
  }

  // normalize every channel independently (degree from that channel)
  std::vector<float> scale(n);
  for (int c = 0; c < ec; ++c) {
    float* m = ops_out + (size_t)c * n_max * n_max;
    for (int i = 0; i < n; ++i) {
      double deg = 0.0;
      for (int j = 0; j < n; ++j) deg += m[(size_t)i * n_max + j];
      if (kind == 0) {  // symmetric: D^{-1/2} A D^{-1/2}
        scale[i] = deg > 1e-12 ? 1.0f / std::sqrt((float)deg) : 0.0f;
      } else {  // row-stochastic: D^{-1} A
        scale[i] = deg > 1e-12 ? 1.0f / (float)deg : 0.0f;
      }
    }
    if (kind == 0) {
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          m[(size_t)i * n_max + j] *= scale[i] * scale[j];
    } else {
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) m[(size_t)i * n_max + j] *= scale[i];
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, <0 on error (-1: a graph exceeds n_max).
int graphpack_pack(
    int num_graphs,
    const int32_t* n_nodes,      // [G]
    const int32_t* atom_flat,    // [sum n] concatenated atom types
    const int64_t* atom_off,     // [G+1] offsets into atom_flat
    const float* adj_flat,       // concatenated per-graph [E, n, n] blocks
    const int64_t* adj_off,      // [G+1] offsets into adj_flat
    int num_edge,                // E (raw edge types)
    int n_max,
    int kind,                    // 0 = sym, 1 = row
    int num_threads,
    int32_t* atom_out,           // [G, n_max]
    float* ops_out,              // [G, E+1, n_max, n_max]
    float* mask_out) {           // [G, n_max]
  for (int g = 0; g < num_graphs; ++g)
    if (n_nodes[g] > n_max) return -1;

  const size_t ops_stride = (size_t)(num_edge + 1) * n_max * n_max;
  int nt = num_threads > 0
               ? num_threads
               : (int)std::max(1u, std::thread::hardware_concurrency());
  nt = std::min(nt, num_graphs > 0 ? num_graphs : 1);

  std::atomic<int> next(0);
  auto worker = [&]() {
    int g;
    while ((g = next.fetch_add(1)) < num_graphs) {
      pack_one(adj_flat + adj_off[g], atom_flat + atom_off[g], n_nodes[g],
               num_edge, n_max, kind, atom_out + (size_t)g * n_max,
               ops_out + (size_t)g * ops_stride, mask_out + (size_t)g * n_max);
    }
  };
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

int graphpack_version() { return 1; }

}  // extern "C"
