// qaray_tpu_torch native host library: the port's own copy of the JAX
// package's native/qaray_native.cpp (the reference's host-side C++: its
// cyBVH builder, tinyobjloader and lodepng), behind a plain C ABI read
// through ctypes (qaray_tpu_torch/native.py): the mean-split and binned
// SAH BVH builders, node for node the trees of the numpy builders in
// qaray_tpu_torch/scene/bvh.py, a triangle-OBJ parser and a zlib PNG
// encoder.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -o <lib> qaray_native.cpp -lz,
// done by qaray_tpu_torch/native.py on first use into build/native/.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build (mean-split, widest-axis spatial median, 3-axis fallback,
// half-split last resort; leaves hold <= max_leaf elements).
// Matches qaray_tpu/scene/bvh.py:build_bvh node-for-node: same traversal
// order (explicit LIFO stack, right child pushed after left so it pops
// first... see python: stack.append(lchild); stack.append(rchild) -> rchild
// pops first). We replicate the python pop order exactly so node indices
// agree and tests can compare arrays bitwise.
// ---------------------------------------------------------------------------

struct BvhOut {
  std::vector<float> bounds;  // [N, 6]
  std::vector<int32_t> left, right, count;
  std::vector<int32_t> elems;
};

static BvhOut *g_last_bvh = nullptr;

// method: 0 = mean-split (reference cyBVH policy), 1 = binned SAH (16 bins,
// widest centroid axis; node-for-node identical to
// qaray_tpu/scene/bvh.py:_build_bvh_sah_numpy — double-precision bin bounds
// and costs match the float64 NumPy path bitwise).
int qn_bvh_build(const float *tri_verts, int num_tris, int max_leaf,
                 int method, int *out_num_nodes, int *out_num_elems) {
  auto *out = new BvhOut();

  if (num_tris == 0) {
    out->bounds.assign(6, 0.f);
    out->left.assign(1, -1);
    out->right.assign(1, 0);
    out->count.assign(1, 0);
    delete g_last_bvh;
    g_last_bvh = out;
    *out_num_nodes = 1;
    *out_num_elems = 0;
    return 0;
  }

  std::vector<float> tmin(num_tris * 3), tmax(num_tris * 3), tctr(num_tris * 3);
  for (int i = 0; i < num_tris; ++i) {
    for (int k = 0; k < 3; ++k) {
      float a = tri_verts[i * 9 + 0 + k];
      float b = tri_verts[i * 9 + 3 + k];
      float c = tri_verts[i * 9 + 6 + k];
      float lo = std::min(a, std::min(b, c));
      float hi = std::max(a, std::max(b, c));
      tmin[i * 3 + k] = lo;
      tmax[i * 3 + k] = hi;
      tctr[i * 3 + k] = 0.5f * (lo + hi);
    }
  }

  struct Task {
    int node;
    std::vector<int64_t> ids;
  };

  auto new_node = [&]() {
    out->bounds.insert(out->bounds.end(), 6, 0.f);
    out->left.push_back(-1);
    out->right.push_back(0);
    out->count.push_back(0);
    return (int)out->left.size() - 1;
  };

  std::vector<Task> stack;
  {
    Task root;
    root.node = new_node();
    root.ids.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) root.ids[i] = i;
    stack.push_back(std::move(root));
  }

  while (!stack.empty()) {
    Task task = std::move(stack.back());
    stack.pop_back();
    const auto &ids = task.ids;
    int node = task.node;

    float bmin[3] = {1e30f, 1e30f, 1e30f};
    float bmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t id : ids) {
      for (int k = 0; k < 3; ++k) {
        bmin[k] = std::min(bmin[k], tmin[id * 3 + k]);
        bmax[k] = std::max(bmax[k], tmax[id * 3 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      out->bounds[node * 6 + k] = bmin[k];
      out->bounds[node * 6 + 3 + k] = bmax[k];
    }

    if ((int)ids.size() <= max_leaf) {
      out->left[node] = -1;
      out->right[node] = (int)out->elems.size();
      out->count[node] = (int)ids.size();
      for (int64_t id : ids) out->elems.push_back((int32_t)id);
      continue;
    }

    std::vector<int64_t> ids_l, ids_r;
    bool split = false;

    if (method == 1) {
      // --- binned SAH on the widest *centroid* axis ---
      constexpr int kBins = 16;
      float cmin[3] = {1e30f, 1e30f, 1e30f};
      float cmax[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t id : ids) {
        for (int k = 0; k < 3; ++k) {
          cmin[k] = std::min(cmin[k], tctr[id * 3 + k]);
          cmax[k] = std::max(cmax[k], tctr[id * 3 + k]);
        }
      }
      int axis = 0;
      float best_ext = cmax[0] - cmin[0];
      for (int k = 1; k < 3; ++k) {
        float e = cmax[k] - cmin[k];
        if (e > best_ext) {
          best_ext = e;
          axis = k;
        }
      }
      if (best_ext > 1e-12f) {
        double scale = kBins * (1.0 - 1e-6) / (double)best_ext;
        std::vector<int> bidx(ids.size());
        long long cnt[kBins] = {0};
        double binmin[kBins][3], binmax[kBins][3];
        for (int b = 0; b < kBins; ++b)
          for (int k = 0; k < 3; ++k) {
            binmin[b][k] = 1e300;
            binmax[b][k] = -1e300;
          }
        for (size_t i = 0; i < ids.size(); ++i) {
          int64_t id = ids[i];
          // float32 subtraction first, then double multiply — matches
          // (centers - cmin) * scale in the NumPy path exactly.
          float rel = tctr[id * 3 + axis] - cmin[axis];
          int b = (int)((double)rel * scale);
          bidx[i] = b;
          cnt[b]++;
          for (int k = 0; k < 3; ++k) {
            binmin[b][k] = std::min(binmin[b][k], (double)tmin[id * 3 + k]);
            binmax[b][k] = std::max(binmax[b][k], (double)tmax[id * 3 + k]);
          }
        }
        auto half_area = [](const double *lo, const double *hi) {
          double e0 = std::max(hi[0] - lo[0], 0.0);
          double e1 = std::max(hi[1] - lo[1], 0.0);
          double e2 = std::max(hi[2] - lo[2], 0.0);
          return e0 * e1 + e1 * e2 + e2 * e0;
        };
        double lmin[kBins][3], lmax[kBins][3], rmin[kBins][3], rmax[kBins][3];
        long long lcnt[kBins], rcnt[kBins];
        for (int k = 0; k < 3; ++k) {
          lmin[0][k] = binmin[0][k];
          lmax[0][k] = binmax[0][k];
          rmin[kBins - 1][k] = binmin[kBins - 1][k];
          rmax[kBins - 1][k] = binmax[kBins - 1][k];
        }
        lcnt[0] = cnt[0];
        rcnt[kBins - 1] = cnt[kBins - 1];
        for (int b = 1; b < kBins; ++b) {
          lcnt[b] = lcnt[b - 1] + cnt[b];
          for (int k = 0; k < 3; ++k) {
            lmin[b][k] = std::min(lmin[b - 1][k], binmin[b][k]);
            lmax[b][k] = std::max(lmax[b - 1][k], binmax[b][k]);
          }
        }
        for (int b = kBins - 2; b >= 0; --b) {
          rcnt[b] = rcnt[b + 1] + cnt[b];
          for (int k = 0; k < 3; ++k) {
            rmin[b][k] = std::min(rmin[b + 1][k], binmin[b][k]);
            rmax[b][k] = std::max(rmax[b + 1][k], binmax[b][k]);
          }
        }
        double best_cost = 1e300;
        int best = -1;
        for (int k = 0; k < kBins - 1; ++k) {
          if (lcnt[k] == 0 || rcnt[k + 1] == 0) continue;
          double c = (double)lcnt[k] * half_area(lmin[k], lmax[k]) +
                     (double)rcnt[k + 1] * half_area(rmin[k + 1], rmax[k + 1]);
          if (c < best_cost) {
            best_cost = c;
            best = k;
          }
        }
        if (best >= 0) {
          for (size_t i = 0; i < ids.size(); ++i) {
            if (bidx[i] <= best)
              ids_l.push_back(ids[i]);
            else
              ids_r.push_back(ids[i]);
          }
          split = true;
        }
      }
    } else {
      // Widest-axis first, argsort(-extent) tie order matches numpy argsort
      // (stable on equal extents: axis index order).
      float extent[3] = {bmax[0] - bmin[0], bmax[1] - bmin[1],
                         bmax[2] - bmin[2]};
      int axes[3] = {0, 1, 2};
      std::stable_sort(axes, axes + 3,
                       [&](int a, int b) { return extent[a] > extent[b]; });

      for (int ai = 0; ai < 3 && !split; ++ai) {
        int axis = axes[ai];
        float mid = 0.5f * (bmin[axis] + bmax[axis]);
        ids_l.clear();
        ids_r.clear();
        for (int64_t id : ids) {
          if (tctr[id * 3 + axis] < mid)
            ids_l.push_back(id);
          else
            ids_r.push_back(id);
        }
        if (!ids_l.empty() && !ids_r.empty()) split = true;
      }
    }
    if (!split) {
      size_t half = ids.size() / 2;
      ids_l.assign(ids.begin(), ids.begin() + half);
      ids_r.assign(ids.begin() + half, ids.end());
    }

    int lchild = new_node();
    int rchild = new_node();
    out->left[node] = lchild;
    out->right[node] = rchild;
    // Python appends (lchild, ids_l) then (rchild, ids_r); rchild pops first.
    stack.push_back({lchild, std::move(ids_l)});
    stack.push_back({rchild, std::move(ids_r)});
  }

  delete g_last_bvh;
  g_last_bvh = out;
  *out_num_nodes = (int)out->left.size();
  *out_num_elems = (int)out->elems.size();
  return 0;
}

int qn_bvh_fetch(float *bounds, int32_t *left, int32_t *right, int32_t *count,
                 int32_t *elems) {
  if (!g_last_bvh) return -1;
  const BvhOut &b = *g_last_bvh;
  memcpy(bounds, b.bounds.data(), b.bounds.size() * sizeof(float));
  memcpy(left, b.left.data(), b.left.size() * sizeof(int32_t));
  memcpy(right, b.right.data(), b.right.size() * sizeof(int32_t));
  memcpy(count, b.count.data(), b.count.size() * sizeof(int32_t));
  memcpy(elems, b.elems.data(), b.elems.size() * sizeof(int32_t));
  delete g_last_bvh;
  g_last_bvh = nullptr;
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encode via zlib (replacement for vendored lodepng; 8-bit grey or RGB).
// ---------------------------------------------------------------------------

static void put32(std::vector<unsigned char> &v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void chunk(std::vector<unsigned char> &png, const char tag[4],
                  const unsigned char *data, size_t len) {
  put32(png, (uint32_t)len);
  size_t start = png.size();
  png.insert(png.end(), tag, tag + 4);
  png.insert(png.end(), data, data + len);
  uint32_t crc =
      crc32(0, png.data() + start, (uInt)(png.size() - start));
  put32(png, crc);
}

int qn_png_write(const char *path, const unsigned char *data, int w, int h,
                 int comps) {
  if (comps != 1 && comps != 3) return -1;
  size_t stride = (size_t)w * comps;
  std::vector<unsigned char> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: none
    memcpy(&raw[y * (stride + 1) + 1], data + y * stride, stride);
  }
  uLongf zlen = compressBound((uLong)raw.size());
  std::vector<unsigned char> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -2;
  z.resize(zlen);

  std::vector<unsigned char> png;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                       '\n'};
  png.insert(png.end(), sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff;
  ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;
  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff;
  ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;
  ihdr[7] = h & 0xff;
  ihdr[8] = 8;                        // bit depth
  ihdr[9] = comps == 1 ? 0 : 2;       // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // compression/filter/interlace
  chunk(png, "IHDR", ihdr, 13);
  chunk(png, "IDAT", z.data(), z.size());
  chunk(png, "IEND", nullptr, 0);

  FILE *f = fopen(path, "wb");
  if (!f) return -3;
  fwrite(png.data(), 1, png.size(), f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Triangle-OBJ fast path: counts pass + fill pass (v/vn/vt + f with fan
// triangulation, negative indices). Mirrors qaray_tpu/scene/obj_loader.py's
// geometry handling; material assignment stays in python (MTL files are
// small and irregular).
// ---------------------------------------------------------------------------

struct ObjOut {
  std::vector<float> v, vn, vt;
  std::vector<int32_t> f_v, f_vt, f_vn;
};

static ObjOut *g_last_obj = nullptr;

static void parse_index_triple(const char *tok, int nv, int nvt, int nvn,
                               int32_t *out) {
  long a = 0, b = 0, c = 0;
  int have_b = 0, have_c = 0;
  const char *p = tok;
  a = strtol(p, (char **)&p, 10);
  if (*p == '/') {
    ++p;
    if (*p != '/') {
      b = strtol(p, (char **)&p, 10);
      have_b = 1;
    }
    if (*p == '/') {
      ++p;
      c = strtol(p, (char **)&p, 10);
      have_c = 1;
    }
  }
  out[0] = a > 0 ? (int32_t)(a - 1) : (int32_t)(nv + a);
  out[1] = have_b ? (b > 0 ? (int32_t)(b - 1) : (int32_t)(nvt + b)) : -1;
  out[2] = have_c ? (c > 0 ? (int32_t)(c - 1) : (int32_t)(nvn + c)) : -1;
}

int qn_obj_load(const char *path, int *out_nv, int *out_nvn, int *out_nvt,
                int *out_nf) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  auto *out = new ObjOut();
  char line[4096];
  std::vector<int32_t> tri(3 * 3);
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        out->v.push_back(x);
        out->v.push_back(y);
        out->v.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 'n' && line[2] == ' ') {
      float x, y, z;
      if (sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
        out->vn.push_back(x);
        out->vn.push_back(y);
        out->vn.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 't' && line[2] == ' ') {
      float u, w;
      if (sscanf(line + 3, "%f %f", &u, &w) >= 1) {
        out->vt.push_back(u);
        out->vt.push_back(w);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      int nv = (int)(out->v.size() / 3);
      int nvt = (int)(out->vt.size() / 2);
      int nvn = (int)(out->vn.size() / 3);
      std::vector<std::array<int32_t, 3>> idx;
      char *save = nullptr;
      for (char *tok = strtok_r(line + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        std::array<int32_t, 3> t;
        parse_index_triple(tok, nv, nvt, nvn, t.data());
        idx.push_back(t);
      }
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        out->f_v.push_back(idx[0][0]);
        out->f_v.push_back(idx[k][0]);
        out->f_v.push_back(idx[k + 1][0]);
        out->f_vt.push_back(idx[0][1]);
        out->f_vt.push_back(idx[k][1]);
        out->f_vt.push_back(idx[k + 1][1]);
        out->f_vn.push_back(idx[0][2]);
        out->f_vn.push_back(idx[k][2]);
        out->f_vn.push_back(idx[k + 1][2]);
      }
    }
  }
  fclose(f);
  delete g_last_obj;
  g_last_obj = out;
  *out_nv = (int)(out->v.size() / 3);
  *out_nvn = (int)(out->vn.size() / 3);
  *out_nvt = (int)(out->vt.size() / 2);
  *out_nf = (int)(out->f_v.size() / 3);
  return 0;
}

int qn_obj_fetch(float *v, float *vn, float *vt, int32_t *f_v, int32_t *f_vt,
                 int32_t *f_vn) {
  if (!g_last_obj) return -1;
  const ObjOut &o = *g_last_obj;
  memcpy(v, o.v.data(), o.v.size() * sizeof(float));
  if (vn) memcpy(vn, o.vn.data(), o.vn.size() * sizeof(float));
  if (vt) memcpy(vt, o.vt.data(), o.vt.size() * sizeof(float));
  memcpy(f_v, o.f_v.data(), o.f_v.size() * sizeof(int32_t));
  memcpy(f_vt, o.f_vt.data(), o.f_vt.size() * sizeof(int32_t));
  memcpy(f_vn, o.f_vn.data(), o.f_vn.size() * sizeof(int32_t));
  delete g_last_obj;
  g_last_obj = nullptr;
  return 0;
}

}  // extern "C"
