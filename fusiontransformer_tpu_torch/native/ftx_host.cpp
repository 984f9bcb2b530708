// Native host data plane of the port (C++, single-threaded).
//
// The port's own copy of the JAX package's ``native/ftx_host.cpp``: the
// per-scan work of the request and loader paths that runs on the host, not
// the card.  ``ftx_quantize`` is the voxel quantize of ``preprocess``
// (``data/quantize.py::sparse_quantize``), ``ftx_slot_triples`` the ks3
// neighbour join of the group-pooled slot maps
// (``ops/host_slots.py::scan_slot_triples``); ``ftx_map_labels``,
// ``ftx_project_frustum`` and ``ftx_inbounds_mask`` are the label mapping,
// frustum projection and range filter of the dataset preprocessing.
//
// Built at first use by ``native/__init__.py``:
//   g++ -O3 -shared -fPIC ftx_host.cpp -o libftx_host_<hash>.so
// There is no numpy fallback: a failed build raises.  The numpy versions
// (``sparse_quantize_ref``, ``scan_slot_triples_ref``) are the plain
// references the tests hold these against, bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Sort-based unique over (x, y, z) int32 voxel coords.
//
// Outputs:
//   unique_idx [n]  — index of one representative point per occupied voxel,
//                     in lexicographic voxel order (only first n_unique valid)
//   inverse    [n]  — for each input point, the slot of its voxel
// Returns n_unique.
int32_t ftx_quantize(const int32_t* coords, int32_t n,
                     int32_t* unique_idx, int32_t* inverse) {
  std::vector<int64_t> keys(n);
  for (int32_t i = 0; i < n; ++i) {
    const int64_t x = coords[3 * i + 0];
    const int64_t y = coords[3 * i + 1];
    const int64_t z = coords[3 * i + 2];
    keys[i] = (x << 40) | (y << 20) | z;  // 0 <= coords < 2^20: the caller checks
  }
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (keys[a] != keys[b]) return keys[a] < keys[b];
    return a < b;  // stable: first occurrence is the representative
  });

  int32_t n_unique = 0;
  int64_t prev = INT64_MIN;
  for (int32_t r = 0; r < n; ++r) {
    const int32_t i = order[r];
    if (keys[i] != prev) {
      unique_idx[n_unique] = i;
      prev = keys[i];
      ++n_unique;
    }
    inverse[i] = n_unique - 1;
  }
  return n_unique;
}

// Map raw labels through a lookup table (vectorized learning_map).
void ftx_map_labels(const int64_t* labels, int32_t n, const int64_t* lut,
                    int32_t lut_size, int64_t* out) {
  for (int32_t i = 0; i < n; ++i) {
    const int64_t l = labels[i];
    out[i] = (l >= 0 && l < lut_size) ? lut[l] : 0;
  }
}

// KITTI pinhole projection + frustum cull.
//
// points [n, 3] float32, proj = P2 @ Tr flattened [3, 4] row-major.
// Outputs keep [n] (0/1) and rowcol [n, 2] float32 (row, col), written for
// kept points only.
int32_t ftx_project_frustum(const float* points, int32_t n, const float* proj,
                            float img_w, float img_h, uint8_t* keep,
                            float* rowcol) {
  int32_t n_keep = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float x = points[3 * i + 0];
    const float y = points[3 * i + 1];
    const float z = points[3 * i + 2];
    keep[i] = 0;
    if (x <= 0.f) continue;  // only points in front of the vehicle
    const float u = proj[0] * x + proj[1] * y + proj[2] * z + proj[3];
    const float v = proj[4] * x + proj[5] * y + proj[6] * z + proj[7];
    const float w = proj[8] * x + proj[9] * y + proj[10] * z + proj[11];
    if (w <= 0.f) continue;
    const float px = u / w;
    const float py = v / w;
    if (px <= 0.f || px >= img_w || py <= 0.f || py >= img_h) continue;
    keep[i] = 1;
    rowcol[2 * i + 0] = py;
    rowcol[2 * i + 1] = px;
    ++n_keep;
  }
  return n_keep;
}

// In-bounds mask for scaled voxel coords (the dataloader's receptive-field
// filter, reference semantic_kitti_dataloader.py:225).
int32_t ftx_inbounds_mask(const float* coords, int32_t n, float full_scale,
                          uint8_t* keep) {
  int32_t n_keep = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float x = coords[3 * i + 0];
    const float y = coords[3 * i + 1];
    const float z = coords[3 * i + 2];
    const bool ok = x >= 0.f && y >= 0.f && z >= 0.f && x < full_scale &&
                    y < full_scale && z < full_scale;
    keep[i] = ok ? 1 : 0;
    n_keep += ok;
  }
  return n_keep;
}

// ks=3 live-neighbor triples for one scan's level (the host-built
// group-pooled slot maps' hot loop, ops/host_slots.py).  `keys` holds the
// level's UNIQUE sorted 36-bit Morton codes (bit 3i+2 <- x_i, matching
// ops/keys.py); for every voxel and each of the 27 kernel taps whose
// neighbor exists, emits (dst, tap, src) with src found by binary search.
// ~26 n log2(n) compares: a cache-friendly host loop over the sorted keys.
// Output arrays must hold 27*n entries; returns the triple count.
// 12-bit dilation: bit i -> bit 3i (byte -> nibble -> pair -> single).
static inline int64_t part1by2_64(int64_t v) {
  v &= 0xFFFLL;
  v = (v | (v << 16)) & 0x0F0000FFLL;
  v = (v | (v << 8)) & 0x0F00F00FLL;
  v = (v | (v << 4)) & 0xC30C30C3LL;
  v = (v | (v << 2)) & 0x249249249LL;
  return v;
}

static inline int64_t compact1by2_64(int64_t v) {
  v &= 0x249249249LL;
  v = (v | (v >> 2)) & 0xC30C30C3LL;
  v = (v | (v >> 4)) & 0x0F00F00FLL;
  v = (v | (v >> 8)) & 0x0F0000FFLL;
  v = (v | (v >> 16)) & 0xFFFLL;
  return v;
}

int32_t ftx_slot_triples(const int64_t* keys, int32_t n, int32_t limit,
                         int32_t* dst, int32_t* tap, int32_t* src) {
  int32_t m = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    const int64_t x = compact1by2_64(k >> 2);
    const int64_t y = compact1by2_64(k >> 1);
    const int64_t z = compact1by2_64(k);
    int32_t t = 0;
    for (int32_t dx = -1; dx <= 1; ++dx) {
      for (int32_t dy = -1; dy <= 1; ++dy) {
        for (int32_t dz = -1; dz <= 1; ++dz, ++t) {
          if (t == 13) {  // center tap: always self
            dst[m] = i; tap[m] = 13; src[m] = i; ++m;
            continue;
          }
          const int64_t qx = x + dx, qy = y + dy, qz = z + dz;
          if (qx < 0 || qx >= limit || qy < 0 || qy >= limit ||
              qz < 0 || qz >= limit)
            continue;
          const int64_t qk = (part1by2_64(qx) << 2) |
                             (part1by2_64(qy) << 1) | part1by2_64(qz);
          const int64_t* p = std::lower_bound(keys, keys + n, qk);
          if (p != keys + n && *p == qk) {
            dst[m] = i; tap[m] = t;
            src[m] = static_cast<int32_t>(p - keys);
            ++m;
          }
        }
      }
    }
  }
  return m;
}

}  // extern "C"
