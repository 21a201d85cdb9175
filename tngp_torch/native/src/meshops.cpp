// meshops — native runtime pieces for the SDF workload and mesh export.
//
// Replaces the reference's external deps (readme: trimesh + pysdf for
// sdf/provider.py:28-88 ground truth; mcubes for mesh export,
// nerf/utils.py:190-202) with a self-contained C++ implementation:
//   * AABB-BVH over triangles: closest-point queries (unsigned distance)
//     + ray-crossing parity for the sign -> signed distance field.
//   * Surface sampling (area-weighted) for the SDF dataset sampler.
//   * Isosurface extraction via marching tetrahedra (6-tet cube split) —
//     table-free, unlike classic marching cubes, so it needs no vendored
//     lookup tables.
//
// Exposed as a C ABI for ctypes (tngp/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm2(V3 a) { return dot(a, a); }

struct AABB {
  V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
  void grow(V3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& b) { grow(b.lo); grow(b.hi); }
  float dist2(V3 p) const {
    float d = 0, t;
    t = std::max({lo.x - p.x, 0.f, p.x - hi.x}); d += t * t;
    t = std::max({lo.y - p.y, 0.f, p.y - hi.y}); d += t * t;
    t = std::max({lo.z - p.z, 0.f, p.z - hi.z}); d += t * t;
    return d;
  }
};

// closest point on triangle (Ericson, Real-Time Collision Detection §5.1.5)
static V3 closest_on_tri(V3 p, V3 a, V3 b, V3 c) {
  V3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  V3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) return a + ab * (d1 / (d1 - d3));
  V3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) return a + ac * (d2 / (d2 - d6));
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0)
    return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)));
  float denom = 1.f / (va + vb + vc);
  return a + ab * (vb * denom) + ac * (vc * denom);
}

// Moller-Trumbore; returns t or -1
static float ray_tri(V3 o, V3 d, V3 a, V3 b, V3 c) {
  const float EPS = 1e-9f;
  V3 e1 = b - a, e2 = c - a;
  V3 pv = cross(d, e2);
  float det = dot(e1, pv);
  if (std::fabs(det) < EPS) return -1.f;
  float inv = 1.f / det;
  V3 tv = o - a;
  float u = dot(tv, pv) * inv;
  if (u < 0 || u > 1) return -1.f;
  V3 qv = cross(tv, e1);
  float v = dot(d, qv) * inv;
  if (v < 0 || u + v > 1) return -1.f;
  float t = dot(e2, qv) * inv;
  return t > EPS ? t : -1.f;
}

struct BVHNode {
  AABB box;
  int left = -1, right = -1;  // children, or
  int start = 0, count = 0;   // leaf triangle range
};

struct MeshSDF {
  std::vector<V3> verts;
  std::vector<int> faces;  // 3*n_f
  std::vector<int> tri_order;
  std::vector<BVHNode> nodes;
  std::vector<double> cum_area;  // for surface sampling
  double total_area = 0;

  V3 tv(int t, int k) const { return verts[faces[3 * tri_order[t] + k]]; }

  int build(int start, int count, std::vector<V3>& centroids) {
    BVHNode node;
    for (int i = start; i < start + count; i++)
      for (int k = 0; k < 3; k++) node.box.grow(tv(i, k));
    int idx = (int)nodes.size();
    nodes.push_back(node);
    if (count <= 4) {
      nodes[idx].start = start;
      nodes[idx].count = count;
      return idx;
    }
    V3 ext = node.box.hi - node.box.lo;
    int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
    int mid = start + count / 2;
    std::nth_element(
        tri_order.begin() + start, tri_order.begin() + mid,
        tri_order.begin() + start + count, [&](int a, int b) {
          const V3 &ca = centroids[a], &cb = centroids[b];
          return axis == 0 ? ca.x < cb.x : (axis == 1 ? ca.y < cb.y : ca.z < cb.z);
        });
    int l = build(start, count / 2, centroids);
    int r = build(mid, count - count / 2, centroids);
    nodes[idx].left = l;
    nodes[idx].right = r;
    return idx;
  }

  void init(const float* v, int64_t n_v, const int* f, int64_t n_f) {
    verts.resize(n_v);
    std::memcpy(verts.data(), v, n_v * sizeof(V3));
    faces.assign(f, f + 3 * n_f);
    tri_order.resize(n_f);
    std::vector<V3> centroids(n_f);
    cum_area.resize(n_f);
    for (int64_t t = 0; t < n_f; t++) {
      tri_order[t] = (int)t;
      V3 a = verts[faces[3 * t]], b = verts[faces[3 * t + 1]], c = verts[faces[3 * t + 2]];
      centroids[t] = (a + b + c) * (1.f / 3.f);
      total_area += 0.5 * std::sqrt(norm2(cross(b - a, c - a)));
      cum_area[t] = total_area;
    }
    // centroids indexed by original tri id
    std::vector<V3> cent_by_id(n_f);
    for (int64_t t = 0; t < n_f; t++) cent_by_id[t] = centroids[t];
    nodes.reserve(2 * n_f);
    build(0, (int)n_f, cent_by_id);
  }

  float unsigned_dist2(V3 p) const {
    float best = 1e30f;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int ni = stack[--sp];
      const BVHNode& n = nodes[ni];
      if (n.box.dist2(p) >= best) continue;
      if (n.left < 0) {
        for (int i = n.start; i < n.start + n.count; i++) {
          V3 cp = closest_on_tri(p, tv(i, 0), tv(i, 1), tv(i, 2));
          best = std::min(best, norm2(p - cp));
        }
      } else {
        float dl = nodes[n.left].box.dist2(p), dr = nodes[n.right].box.dist2(p);
        // near child first
        if (dl < dr) {
          if (dr < best && sp < 127) stack[sp++] = n.right;
          if (dl < best && sp < 127) stack[sp++] = n.left;
        } else {
          if (dl < best && sp < 127) stack[sp++] = n.left;
          if (dr < best && sp < 127) stack[sp++] = n.right;
        }
      }
    }
    return best;
  }

  int count_hits(V3 o, V3 d) const {
    int hits = 0;
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int ni = stack[--sp];
      const BVHNode& n = nodes[ni];
      // slab test
      float t0 = 0.f, t1 = 1e30f;
      const float* lo = &n.box.lo.x;
      const float* hi = &n.box.hi.x;
      const float* oo = &o.x;
      const float* dd = &d.x;
      bool miss = false;
      for (int a = 0; a < 3; a++) {
        float inv = 1.f / dd[a];
        float ta = (lo[a] - oo[a]) * inv, tb = (hi[a] - oo[a]) * inv;
        if (ta > tb) std::swap(ta, tb);
        t0 = std::max(t0, ta);
        t1 = std::min(t1, tb);
        if (t0 > t1) { miss = true; break; }
      }
      if (miss) continue;
      if (n.left < 0) {
        for (int i = n.start; i < n.start + n.count; i++)
          if (ray_tri(o, d, tv(i, 0), tv(i, 1), tv(i, 2)) > 0) hits++;
      } else if (sp < 126) {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return hits;
  }

  float signed_dist(V3 p) const {
    float ud = std::sqrt(unsigned_dist2(p));
    // parity along a fixed irrational direction (robust against axis-aligned
    // coplanar faces); pysdf convention: positive INSIDE (sdf/provider.py uses
    // pysdf where sdf>0 inside)
    V3 dir{0.5773503f, 0.5773503f + 1e-4f, 0.5773503f - 2e-4f};
    int hits = count_hits(p, dir);
    return (hits % 2 == 1) ? ud : -ud;
  }
};

}  // namespace

extern "C" {

void* sdf_build(const float* verts, int64_t n_v, const int* faces, int64_t n_f) {
  auto* m = new MeshSDF();
  m->init(verts, n_v, faces, n_f);
  return m;
}

void sdf_free(void* handle) { delete static_cast<MeshSDF*>(handle); }

void sdf_query(void* handle, const float* pts, int64_t n, float* out) {
  auto* m = static_cast<MeshSDF*>(handle);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n; i++)
    out[i] = m->signed_dist({pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]});
}

// area-weighted surface samples (+ optional gaussian offset applied in python)
void sdf_sample_surface(void* handle, int64_t n, uint64_t seed, float* out) {
  auto* m = static_cast<MeshSDF*>(handle);
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  for (int64_t i = 0; i < n; i++) {
    double r = uni(rng) * m->total_area;
    auto it = std::lower_bound(m->cum_area.begin(), m->cum_area.end(), r);
    int64_t t = it - m->cum_area.begin();
    if (t >= (int64_t)m->cum_area.size()) t = m->cum_area.size() - 1;
    V3 a = m->verts[m->faces[3 * t]], b = m->verts[m->faces[3 * t + 1]],
       c = m->verts[m->faces[3 * t + 2]];
    float u = (float)uni(rng), v = (float)uni(rng);
    if (u + v > 1) { u = 1 - u; v = 1 - v; }
    V3 p = a + (b - a) * u + (c - a) * v;
    out[3 * i] = p.x; out[3 * i + 1] = p.y; out[3 * i + 2] = p.z;
  }
}

// ---------- marching tetrahedra isosurface extraction -----------------------

namespace {
struct MTOut {
  std::vector<float> verts;
  std::vector<int> faces;
};

// Kuhn/Freudenthal 6-tet split around the main diagonal 0-7 (corner index
// c = x + 2y + 4z): the six bit-add paths 0 -> a -> b -> 7.  Consistent face
// diagonals across neighboring cubes => watertight surface (ray parity works).
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7}, {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};
// cube corner offsets (x, y, z)
static const int CORNER[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
                                 {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

static inline void emit_vert(MTOut& o, const float* p0, const float* p1, float v0,
                             float v1, float iso) {
  float t = (std::fabs(v1 - v0) > 1e-12f) ? (iso - v0) / (v1 - v0) : 0.5f;
  o.verts.push_back(p0[0] + t * (p1[0] - p0[0]));
  o.verts.push_back(p0[1] + t * (p1[1] - p0[1]));
  o.verts.push_back(p0[2] + t * (p1[2] - p0[2]));
}
}  // namespace

// field: [X*Y*Z] with z fastest; emits triangles of the iso surface in grid coords
void* mt_extract(const float* field, int64_t X, int64_t Y, int64_t Z, float iso) {
  auto* out = new MTOut();
  auto F = [&](int64_t x, int64_t y, int64_t z) { return field[(x * Y + y) * Z + z]; };
  float P[8][3], V[8];
  for (int64_t x = 0; x + 1 < X; x++)
    for (int64_t y = 0; y + 1 < Y; y++)
      for (int64_t z = 0; z + 1 < Z; z++) {
        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; c++) {
          P[c][0] = (float)(x + CORNER[c][0]);
          P[c][1] = (float)(y + CORNER[c][1]);
          P[c][2] = (float)(z + CORNER[c][2]);
          V[c] = F(x + CORNER[c][0], y + CORNER[c][1], z + CORNER[c][2]);
          (V[c] > iso ? any_hi : any_lo) = true;
        }
        if (!any_lo || !any_hi) continue;
        for (int t = 0; t < 6; t++) {
          const int* T = TETS[t];
          int above = 0, ai[4], bi[4], na = 0, nb = 0;
          for (int k = 0; k < 4; k++)
            if (V[T[k]] > iso) { ai[na++] = T[k]; above++; }
            else bi[nb++] = T[k];
          if (above == 0 || above == 4) continue;
          int base = (int)(out->verts.size() / 3);
          if (above == 1 || above == 3) {
            int apex = (above == 1) ? ai[0] : bi[0];
            int* ring = (above == 1) ? bi : ai;
            for (int k = 0; k < 3; k++)
              emit_vert(*out, P[apex], P[ring[k]], V[apex], V[ring[k]], iso);
            if (above == 1) {
              out->faces.push_back(base); out->faces.push_back(base + 1); out->faces.push_back(base + 2);
            } else {
              out->faces.push_back(base); out->faces.push_back(base + 2); out->faces.push_back(base + 1);
            }
          } else {  // 2-2: quad
            emit_vert(*out, P[ai[0]], P[bi[0]], V[ai[0]], V[bi[0]], iso);
            emit_vert(*out, P[ai[0]], P[bi[1]], V[ai[0]], V[bi[1]], iso);
            emit_vert(*out, P[ai[1]], P[bi[1]], V[ai[1]], V[bi[1]], iso);
            emit_vert(*out, P[ai[1]], P[bi[0]], V[ai[1]], V[bi[0]], iso);
            out->faces.push_back(base); out->faces.push_back(base + 1); out->faces.push_back(base + 2);
            out->faces.push_back(base); out->faces.push_back(base + 2); out->faces.push_back(base + 3);
          }
        }
      }
  return out;
}

int64_t mt_num_verts(void* h) { return static_cast<MTOut*>(h)->verts.size() / 3; }
int64_t mt_num_faces(void* h) { return static_cast<MTOut*>(h)->faces.size() / 3; }
void mt_get(void* h, float* verts, int* faces) {
  auto* o = static_cast<MTOut*>(h);
  std::memcpy(verts, o->verts.data(), o->verts.size() * sizeof(float));
  std::memcpy(faces, o->faces.data(), o->faces.size() * sizeof(int));
}
void mt_free(void* h) { delete static_cast<MTOut*>(h); }

}  // extern "C"
