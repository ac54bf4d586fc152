// Native host-side runtime pieces, C ABI for ctypes.
//
// The reference implements its whole runtime in a native language (Rust);
// this build keeps the compute path in XLA/Pallas and implements the
// host-side runtime — acceleration-structure build (reference src/bvh.rs)
// and image encoding (reference tests/test.rs:55-85) — natively here.
//
// rt_build_bvh mirrors accel/bvh.py's NumPy builder EXACTLY (same median
// split over bbox minima, same largest-centroid-extent axis, same stable
// sort, same leaf padding), so the Python tests can assert array equality
// between the two builders.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  const double* lo;         // [P, 3]
  const double* hi;         // [P, 3]
  std::vector<double> cent; // [P, 3]
  int leaf_size;
  std::vector<float> node_min, node_max;
  std::vector<int32_t> node_left, node_right, node_count;
  std::vector<int32_t> order;

  int emit(std::vector<int32_t>& ids, int begin, int end) {
    int nid = static_cast<int>(node_count.size());
    node_min.insert(node_min.end(), {0, 0, 0});
    node_max.insert(node_max.end(), {0, 0, 0});
    node_left.push_back(0);
    node_right.push_back(0);
    node_count.push_back(0);
    double bmin[3] = {1e300, 1e300, 1e300};
    double bmax[3] = {-1e300, -1e300, -1e300};
    for (int i = begin; i < end; ++i) {
      const int p = ids[i];
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], lo[3 * p + a]);
        bmax[a] = std::max(bmax[a], hi[3 * p + a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      node_min[3 * nid + a] = static_cast<float>(bmin[a]);
      node_max[3 * nid + a] = static_cast<float>(bmax[a]);
    }
    const int n = end - begin;
    if (n <= leaf_size) {
      node_left[nid] = static_cast<int32_t>(order.size());
      node_count[nid] = n;
      for (int i = begin; i < end; ++i) order.push_back(ids[i]);
      while (order.size() % leaf_size) order.push_back(-1);
    } else {
      double cmin[3] = {1e300, 1e300, 1e300};
      double cmax[3] = {-1e300, -1e300, -1e300};
      for (int i = begin; i < end; ++i) {
        const int p = ids[i];
        for (int a = 0; a < 3; ++a) {
          cmin[a] = std::min(cmin[a], cent[3 * p + a]);
          cmax[a] = std::max(cmax[a], cent[3 * p + a]);
        }
      }
      int axis = 0;
      double best = cmax[0] - cmin[0];
      for (int a = 1; a < 3; ++a) {
        const double e = cmax[a] - cmin[a];
        if (e > best) { best = e; axis = a; }
      }
      const double* l = lo;
      std::stable_sort(ids.begin() + begin, ids.begin() + end,
                       [l, axis](int32_t x, int32_t y) {
                         return l[3 * x + axis] < l[3 * y + axis];
                       });
      const int mid = begin + n / 2;
      const int left = emit(ids, begin, mid);
      const int right = emit(ids, mid, end);
      node_left[nid] = left;
      node_right[nid] = right;
    }
    return nid;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output buffers must hold >= 2*P+1 nodes and
// 2*P + leaf_size order slots; actual sizes written to out_nn / out_no.
int rt_build_bvh(const double* lo, const double* hi, int P, int leaf_size,
                 float* node_min, float* node_max, int32_t* node_left,
                 int32_t* node_right, int32_t* node_count, int32_t* order,
                 int32_t* out_nn, int32_t* out_no) {
  if (P <= 0 || leaf_size <= 0) return 1;
  Builder b;
  b.lo = lo;
  b.hi = hi;
  b.leaf_size = leaf_size;
  b.cent.resize(3 * P);
  for (int p = 0; p < 3 * P; ++p) b.cent[p] = 0.5 * (lo[p] + hi[p]);
  std::vector<int32_t> ids(P);
  for (int p = 0; p < P; ++p) ids[p] = p;
  b.emit(ids, 0, P);
  const int nn = static_cast<int>(b.node_count.size());
  const int no = static_cast<int>(b.order.size());
  if (nn > 2 * P + 1 || no > 2 * P + leaf_size) return 2;
  std::memcpy(node_min, b.node_min.data(), sizeof(float) * 3 * nn);
  std::memcpy(node_max, b.node_max.data(), sizeof(float) * 3 * nn);
  std::memcpy(node_left, b.node_left.data(), sizeof(int32_t) * nn);
  std::memcpy(node_right, b.node_right.data(), sizeof(int32_t) * nn);
  std::memcpy(node_count, b.node_count.data(), sizeof(int32_t) * nn);
  std::memcpy(order, b.order.data(), sizeof(int32_t) * no);
  *out_nn = nn;
  *out_no = no;
  return 0;
}

// ASCII P3 encoder, byte-identical to utils/image_io.to_ppm (reference
// output format tests/test.rs:59,72-79: header, (255.99*c) truncation,
// one "r g b\n" line per pixel, trailing newline). img: float32 [ny,nx,3]
// already gamma-corrected and clamped to [0,1]. Returns bytes written,
// or -1 if cap is too small.
long rt_encode_ppm(const float* img, int nx, int ny, char* out, long cap) {
  long w = std::snprintf(out, cap, "P3\n%d %d\n255\n", nx, ny);
  if (w < 0 || w >= cap) return -1;
  const long npix = static_cast<long>(nx) * ny;
  for (long i = 0; i < npix; ++i) {
    if (cap - w < 16) return -1;
    for (int c = 0; c < 3; ++c) {
      float v = img[3 * i + c];
      v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
      const int q = static_cast<int>(255.99f * v);
      w += std::snprintf(out + w, cap - w, c < 2 ? "%d " : "%d\n", q);
    }
  }
  return w;
}

}  // extern "C"
