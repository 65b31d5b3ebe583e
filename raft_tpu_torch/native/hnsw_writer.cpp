// Native hnswlib-format writer of the PyTorch port (reference analog:
// neighbors/detail/cagra/cagra_serialize.cuh serialize_to_hnswlib).
//
// Writes a base-layer-only hnswlib HierarchicalNSW index file from a
// fixed-degree kNN graph + row-major dataset, streaming row by row so the
// interleaved element blocks (links | vector | label) never materialize in
// memory — the kind of buffered host IO the reference keeps in C++, kept in
// C++ here too. Exposed via a C ABI for the ctypes binding in
// raft_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// returns 0 on success, negative errno-style codes on failure
int raft_torch_write_hnsw(const char* path,
                          uint64_t n,
                          uint32_t dim,
                          uint32_t degree,
                          const uint32_t* graph,   // (n, degree) row-major
                          const float* data,       // (n, dim) row-major
                          uint64_t entrypoint) {
  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) { return -1; }

  auto w = [&](const void* p, size_t bytes) {
    return std::fwrite(p, 1, bytes, f) == bytes;
  };

  bool ok = true;
  const uint64_t offset_level_0 = 0;
  const uint64_t max_element = n;
  const uint64_t curr_element_count = n;
  // per element: [links_count u32][degree x u32][dim x f32][label u64]
  const uint64_t size_data_per_element =
      static_cast<uint64_t>(degree) * 4 + 4 + static_cast<uint64_t>(dim) * 4 + 8;
  const uint64_t label_offset = size_data_per_element - 8;
  const uint64_t offset_data = static_cast<uint64_t>(degree) * 4 + 4;
  // 0, not the reference's 1: a base-layer-only index with max_level=0
  // skips upper-level traversal in STOCK hnswlib (the reference's 1 only
  // works with its patched base_layer_only loader)
  const int32_t max_level = 0;
  const int32_t entry = static_cast<int32_t>(entrypoint);
  const uint64_t max_m = degree / 2;
  const uint64_t max_m0 = degree;
  const uint64_t m = degree / 2;
  const double mult = 0.42424242;  // unused by base-layer-only search
  const uint64_t ef_construction = 500;

  ok = ok && w(&offset_level_0, 8) && w(&max_element, 8) &&
       w(&curr_element_count, 8) && w(&size_data_per_element, 8) &&
       w(&label_offset, 8) && w(&offset_data, 8) && w(&max_level, 4) &&
       w(&entry, 4) && w(&max_m, 8) && w(&max_m0, 8) && w(&m, 8) &&
       w(&mult, 8) && w(&ef_construction, 8);

  const int32_t degree_i = static_cast<int32_t>(degree);
  for (uint64_t i = 0; ok && i < n; ++i) {
    ok = ok && w(&degree_i, 4);
    ok = ok && w(graph + i * degree, static_cast<size_t>(degree) * 4);
    ok = ok && w(data + i * dim, static_cast<size_t>(dim) * 4);
    ok = ok && w(&i, 8);
  }
  const int32_t zero = 0;
  for (uint64_t i = 0; ok && i < n; ++i) { ok = ok && w(&zero, 4); }

  if (std::fclose(f) != 0) { return -3; }
  return ok ? 0 : -2;
}

}  // extern "C"
