// ref_tracer.cpp — faithful scalar C++ mirror of the reference renderer's
// hot loop, used ONLY as (a) the measured performance baseline and (b) an
// end-to-end correctness oracle. It is NOT part of the device compute path.
//
// The reference (DrStiev/raytracing_rust) is Rust and publishes no numbers;
// Rust cannot run in this environment. This file transcribes its algorithm
// one-to-one — same f64 scalar math, same recursion, same rejection-sampled
// RNG draws, same virtual-dispatch object model, same linear HittableList
// scan, single thread (the reference never uses its rayon dep) — so timing
// it on this host measures the reference's class honestly. Citations mark
// the mirrored code. Intentional deviations, both documented:
//   * RNG: seeded xoshiro256++ instead of the unseeded rand::thread_rng()
//     (ChaCha12). Seeding gives the oracle reproducibility; xoshiro is
//     FASTER than ChaCha12, so the measured baseline is an upper bound on
//     the reference's own speed — conservative for our vs_baseline ratio.
//   * scenes are built from the same literals as tests/test.rs but only the
//     materials/geometry/textures those scenes need are implemented
//     (solid + checker + image textures, all five materials, sphere /
//     moving sphere / rect / cube / translate / rotate / flip / constant
//     medium, sphere UV with the reference's FRAC_2_PI quirk).
//
// Everything is f64 like the reference (nalgebra::Vector3<f64> throughout).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <limits>
#include <memory>
#include <utility>
#include <vector>

namespace {

// ---- vector (reference: external nalgebra::Vector3<f64>) -------------------

struct V3 {
  double e[3];
  double x() const { return e[0]; }
  double y() const { return e[1]; }
  double z() const { return e[2]; }
  double operator[](int i) const { return e[i]; }
  double& operator[](int i) { return e[i]; }
};

inline V3 operator+(V3 a, V3 b) { return {a.e[0] + b.e[0], a.e[1] + b.e[1], a.e[2] + b.e[2]}; }
inline V3 operator-(V3 a, V3 b) { return {a.e[0] - b.e[0], a.e[1] - b.e[1], a.e[2] - b.e[2]}; }
inline V3 operator*(double s, V3 a) { return {s * a.e[0], s * a.e[1], s * a.e[2]}; }
inline V3 operator*(V3 a, V3 b) { return {a.e[0] * b.e[0], a.e[1] * b.e[1], a.e[2] * b.e[2]}; }
inline V3 operator/(V3 a, double s) { return (1.0 / s) * a; }
inline V3& operator+=(V3& a, V3 b) { a = a + b; return a; }
inline double dot(V3 a, V3 b) { return a.e[0] * b.e[0] + a.e[1] * b.e[1] + a.e[2] * b.e[2]; }
inline V3 cross(V3 a, V3 b) {
  return {a.e[1] * b.e[2] - a.e[2] * b.e[1], a.e[2] * b.e[0] - a.e[0] * b.e[2],
          a.e[0] * b.e[1] - a.e[1] * b.e[0]};
}
inline double magnitude(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalize(V3 a) { return a / magnitude(a); }

// ---- RNG (reference src/util.rs; see file header for the deviation) --------

struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion of the seed into xoshiro state
    for (int i = 0; i < 4; ++i) {
      seed += 0x9E3779B97F4A7C15ull;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {  // xoshiro256++
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }  // U[0,1)
};

Rng* g_rng = nullptr;  // one global stream, like rand::thread_rng()

// rejection sampling exactly as the reference (src/util.rs:4-13)
V3 random_in_unit_sphere() {
  for (;;) {
    V3 p = {2.0 * g_rng->uniform() - 1.0, 2.0 * g_rng->uniform() - 1.0,
            2.0 * g_rng->uniform() - 1.0};
    if (dot(p, p) < 1.0) return p;
  }
}

// src/util.rs:15-24
V3 random_in_unit_disk() {
  for (;;) {
    V3 p = {2.0 * g_rng->uniform() - 1.0, 2.0 * g_rng->uniform() - 1.0, 0.0};
    if (dot(p, p) < 1.0) return p;
  }
}

// ---- ray (src/ray.rs) -------------------------------------------------------

struct Ray {
  V3 o, d;
  double time;
  V3 at(double t) const { return o + t * d; }  // ray.rs:24-26
};

// ---- textures (src/texture.rs) ----------------------------------------------

struct Texture {
  virtual V3 value(double u, double v, const V3& p) const = 0;
  virtual ~Texture() = default;
};

// texture.rs:8-25
struct Solid : Texture {
  V3 color;
  explicit Solid(V3 c) : color(c) {}
  V3 value(double, double, const V3&) const override { return color; }
};

// texture.rs:27-48 — 3-D checker: sin(10x)·sin(10y)·sin(10z) < 0 ? odd : even
struct Checker : Texture {
  const Texture* odd;
  const Texture* even;
  Checker(const Texture* o, const Texture* e) : odd(o), even(e) {}
  V3 value(double u, double v, const V3& p) const override {
    double s = std::sin(10.0 * p.x()) * std::sin(10.0 * p.y()) *
               std::sin(10.0 * p.z());
    return s < 0.0 ? odd->value(u, v, p) : even->value(u, v, p);
  }
};

// ---- hash-gradient Perlin (ops/perlin.py) -----------------------------------
// The framework's DOCUMENTED deviation from src/perlin.rs: the reference
// builds its gradient/permutation tables from an UNSEEDED thread RNG
// (src/perlin.rs:5,13), so there is no fixed noise field to match — the
// framework replaces the tables with a murmur-style lattice hash. This is
// an independent scalar f64 transcription of that spec, used ONLY to pin
// the JAX tiers' noise-scene radiometry absolutely (it shares the closed
// form but no code or vectorization with ops/perlin.py /
// ops/pallas_tracer.py / tests/oracle.py). It is NOT the reference's
// Perlin and is never part of the timed baseline scenes (ids 0-1).
namespace hash_perlin {
constexpr uint32_t kHA = 0x8DA6B343u, kHB = 0xD8163841u, kHC = 0xCB1AB31Fu;
constexpr uint32_t kHSeed = 0x27D4EB2Fu;
constexpr uint32_t kHM1 = 0x9E3779B1u, kHM2 = 0x85EBCA6Bu,
                   kHM3 = 0xC2B2AE35u;
constexpr double kInv24 = 1.0 / (1 << 24);

// ops/perlin.py:_gradient — unit gradient at wrapped lattice corner
V3 gradient(int ci, int cj, int ck, uint32_t seed) {
  uint32_t h = static_cast<uint32_t>(ci) * kHA ^
               static_cast<uint32_t>(cj) * kHB ^
               static_cast<uint32_t>(ck) * kHC ^ (seed * kHSeed);
  h ^= h >> 13;
  h *= kHM1;
  h ^= h >> 16;
  uint32_t g = (h ^ kHM2) * kHM3;
  g ^= g >> 16;
  double u1 = static_cast<double>(h >> 8) * kInv24;
  double u2 = static_cast<double>(g >> 8) * kInv24;
  double cz = 2.0 * u1 - 1.0;
  double sz = std::sqrt(std::max(0.0, 1.0 - cz * cz));
  double phi = 2.0 * M_PI * u2;
  return {sz * std::cos(phi), sz * std::sin(phi), cz};
}

// ops/perlin.py:noise — Hermite-smoothed trilinear gradient interpolation
// (the interpolation itself is the reference's, src/perlin.rs:58-97);
// signed floor + two's-complement &255 wrap, exactly the JAX int path
double noise(const V3& p, uint32_t seed) {
  double f[3], uvw[3], s[3];
  int ijk[3];
  for (int a = 0; a < 3; ++a) {
    f[a] = std::floor(p[a]);
    uvw[a] = p[a] - f[a];
    ijk[a] = static_cast<int>(f[a]);
    s[a] = uvw[a] * uvw[a] * (3.0 - 2.0 * uvw[a]);
  }
  double sum = 0.0;
  for (int di = 0; di < 2; ++di)
    for (int dj = 0; dj < 2; ++dj)
      for (int dk = 0; dk < 2; ++dk) {
        V3 g = gradient((ijk[0] + di) & 255, (ijk[1] + dj) & 255,
                        (ijk[2] + dk) & 255, seed);
        double dot = g.x() * (uvw[0] - di) + g.y() * (uvw[1] - dj) +
                     g.z() * (uvw[2] - dk);
        double wu = di ? s[0] : 1.0 - s[0];
        double wv = dj ? s[1] : 1.0 - s[1];
        double ww = dk ? s[2] : 1.0 - s[2];
        sum += wu * wv * ww * dot;
      }
  return sum;
}

// ops/perlin.py:turb — |Σ 0.5^k noise(2^k p)| (src/perlin.rs:99-109 form)
double turb(V3 p, int depth, uint32_t seed) {
  double accum = 0.0, weight = 1.0;
  for (int d = 0; d < depth; ++d) {
    accum += weight * noise(p, seed);
    weight *= 0.5;
    p = 2.0 * p;
  }
  return std::fabs(accum);
}
}  // namespace hash_perlin

// texture.rs:50-71 marble formula — 0.5·(1 + sin(scale·p.x + 5·turb(p,7)))
// — over the framework's hash-gradient field (see hash_perlin above)
struct HashNoise : Texture {
  double scale;
  uint32_t seed;
  HashNoise(double s, uint32_t sd) : scale(s), seed(sd) {}
  V3 value(double, double, const V3& p) const override {
    double m = 0.5 * (1.0 + std::sin(scale * p.x() +
                                     5.0 * hash_perlin::turb(p, 7, seed)));
    return {m, m, m};
  }
};

// texture.rs:73-108 — nearest fetch from raw RGB8 (row 0 = image top),
// v flipped, Rust `as usize` saturating cast then clamp-to-edge, /255.
struct Image : Texture {
  std::vector<unsigned char> data;
  int nx, ny;
  Image(std::vector<unsigned char> d, int w, int h)
      : data(std::move(d)), nx(w), ny(h) {}
  V3 value(double u, double v, const V3&) const override {
    // Rust `as usize` saturates: negative/NaN -> 0 (texture.rs:91-92);
    // the explicit clamp-to-edge follows (texture.rs:94-99)
    auto cast = [](double x, int hi) {
      if (!(x > 0.0)) return 0;
      double c = x > static_cast<double>(hi) ? hi : x;
      return static_cast<int>(c);
    };
    int i = cast(u * nx, nx - 1);
    int j = cast((1.0 - v) * ny, ny - 1);
    size_t idx = 3 * (static_cast<size_t>(i) + static_cast<size_t>(nx) * j);
    return {data[idx] / 255.0, data[idx + 1] / 255.0, data[idx + 2] / 255.0};
  }
};

// ---- materials (src/material.rs) --------------------------------------------

struct HitRecord;

struct Material {
  virtual bool scatter(const Ray& ray, const HitRecord& hit, Ray& out,
                       V3& attenuation) const = 0;
  virtual V3 emitted(double, double, const V3&) const { return {0, 0, 0}; }
  virtual ~Material() = default;
};

struct HitRecord {
  double t, u, v;
  V3 p, normal;
  const Material* material;
};

// material.rs:9-11
V3 reflect(V3 v, V3 n) { return v - 2.0 * dot(v, n) * n; }

// material.rs:13-23
bool refract(V3 v, V3 n, double ni_over_nt, V3& out) {
  V3 uv = normalize(v);
  double dt = dot(uv, n);
  double disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt);
  if (disc > 0.0) {
    out = ni_over_nt * (uv - dt * n) - std::sqrt(disc) * n;
    return true;
  }
  return false;
}

// material.rs:25-28
double schlick(double cosine, double ref_idx) {
  double r0 = (1.0 - ref_idx) / (1.0 + ref_idx);
  r0 *= r0;
  return r0 + (1.0 - r0) * std::pow(1.0 - cosine, 5.0);
}

// material.rs:35-58 — generic over Texture like the reference
struct Lambertian : Material {
  const Texture* albedo;
  explicit Lambertian(const Texture* a) : albedo(a) {}
  bool scatter(const Ray& ray, const HitRecord& hit, Ray& out,
               V3& att) const override {
    V3 target = hit.p + hit.normal + random_in_unit_sphere();
    out = {hit.p, target - hit.p, ray.time};
    att = albedo->value(hit.u, hit.v, hit.p);
    return true;
  }
};

// material.rs:153-173 — ConstantMedium's phase function: uniform-ish
// direction from the same rejection sampler, attenuation = albedo
struct Isotropic : Material {
  const Texture* albedo;
  explicit Isotropic(const Texture* a) : albedo(a) {}
  bool scatter(const Ray& ray, const HitRecord& hit, Ray& out,
               V3& att) const override {
    out = {hit.p, random_in_unit_sphere(), ray.time};
    att = albedo->value(hit.u, hit.v, hit.p);
    return true;
  }
};

// material.rs:60-92
struct Metal : Material {
  V3 albedo;
  double fuzz;
  Metal(V3 a, double f) : albedo(a), fuzz(f < 1.0 ? f : 1.0) {}
  bool scatter(const Ray& ray, const HitRecord& hit, Ray& out,
               V3& att) const override {
    V3 reflected = reflect(normalize(ray.d), hit.normal);
    if (fuzz > 0.0) reflected += fuzz * random_in_unit_sphere();
    if (dot(reflected, hit.normal) > 0.0) {
      out = {hit.p, reflected, ray.time};
      att = albedo;
      return true;
    }
    return false;
  }
};

// material.rs:94-131 (including the reference's exit-cosine formula quirk)
struct Dielectric : Material {
  double ref_idx;
  explicit Dielectric(double r) : ref_idx(r) {}
  bool scatter(const Ray& ray, const HitRecord& hit, Ray& out,
               V3& att) const override {
    att = {1.0, 1.0, 1.0};
    V3 outward_normal;
    double ni_over_nt, cosine;
    if (dot(ray.d, hit.normal) > 0.0) {
      outward_normal = -1.0 * hit.normal;
      ni_over_nt = ref_idx;
      cosine = ref_idx * dot(ray.d, hit.normal) / magnitude(ray.d);
    } else {
      outward_normal = hit.normal;
      ni_over_nt = 1.0 / ref_idx;
      cosine = -dot(ray.d, hit.normal) / magnitude(ray.d);
    }
    V3 refracted;
    if (refract(ray.d, outward_normal, ni_over_nt, refracted)) {
      double reflect_prob = schlick(cosine, ref_idx);
      if (g_rng->uniform() >= reflect_prob) {
        out = {hit.p, refracted, ray.time};
        return true;
      }
    }
    out = {hit.p, reflect(ray.d, hit.normal), ray.time};
    return true;
  }
};

// material.rs:133-151
struct DiffuseLight : Material {
  V3 emit;
  explicit DiffuseLight(V3 e) : emit(e) {}
  bool scatter(const Ray&, const HitRecord&, Ray&, V3&) const override {
    return false;
  }
  V3 emitted(double, double, const V3&) const override { return emit; }
};

// ---- hittables (src/hittable.rs, sphere.rs, rect.rs, cube.rs, ...) ---------

struct Hittable {
  virtual bool hit(const Ray& ray, double t_min, double t_max,
                   HitRecord& rec) const = 0;
  virtual ~Hittable() = default;
};

// src/sphere.rs:9-15 — NOTE the reference's FRAC_2_PI constant (= 2/π)
// where the formula wants π/2, mirrored verbatim; the framework's
// SceneTables.compat_uv_bug reproduces the same quirk on the JAX side.
void get_sphere_uv(const V3& n, double& u, double& v) {
  double phi = std::atan2(n.z(), n.x());
  double theta = std::asin(n.y());
  u = 1.0 - (phi + M_PI) / (2.0 * M_PI);
  v = (theta + 2.0 / M_PI) / M_PI;
}

// src/sphere.rs:20-85
struct Sphere : Hittable {
  V3 center;
  double radius;
  const Material* material;
  Sphere(V3 c, double r, const Material* m) : center(c), radius(r), material(m) {}
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    V3 oc = ray.o - center;
    double a = dot(ray.d, ray.d);
    double b = dot(oc, ray.d);
    double c = dot(oc, oc) - radius * radius;
    double disc = b * b - a * c;
    if (disc > 0.0) {
      double sq = std::sqrt(disc);
      for (double t : {(-b - sq) / a, (-b + sq) / a}) {
        if (t < t_max && t > t_min) {
          rec.t = t;
          rec.p = ray.at(t);
          rec.normal = (rec.p - center) / radius;
          get_sphere_uv(rec.normal, rec.u, rec.v);  // sphere.rs:51
          rec.material = material;
          return true;
        }
      }
    }
    return false;
  }
};

// src/sphere.rs:87-163 — center lerps with ray time (sphere.rs:115-118);
// hit math identical to Sphere against center(ray.time).
struct MovingSphere : Hittable {
  V3 center0, center1;
  double time0, time1, radius;
  const Material* material;
  MovingSphere(V3 c0, V3 c1, double t0, double t1, double r,
               const Material* m)
      : center0(c0), center1(c1), time0(t0), time1(t1), radius(r),
        material(m) {}
  V3 center(double time) const {
    return center0 +
           ((time - time0) / (time1 - time0)) * (center1 - center0);
  }
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    V3 c = center(ray.time);
    V3 oc = ray.o - c;
    double a = dot(ray.d, ray.d);
    double b = dot(oc, ray.d);
    double cc = dot(oc, oc) - radius * radius;
    double disc = b * b - a * cc;
    if (disc > 0.0) {
      double sq = std::sqrt(disc);
      for (double t : {(-b - sq) / a, (-b + sq) / a}) {
        if (t < t_max && t > t_min) {
          rec.t = t;
          rec.p = ray.at(t);
          rec.normal = (rec.p - c) / radius;
          get_sphere_uv(rec.normal, rec.u, rec.v);  // sphere.rs:136
          rec.material = material;
          return true;
        }
      }
    }
    return false;
  }
};

// src/rect.rs:39-69; plane 0=YZ, 1=ZX, 2=XY → (k_axis, a_axis, b_axis)
struct Rect : Hittable {
  int ka, aa, ba;
  double x0, y0, x1, y1, k;
  const Material* material;
  Rect(int plane, double x0_, double y0_, double x1_, double y1_, double k_,
       const Material* m)
      : x0(x0_), y0(y0_), x1(x1_), y1(y1_), k(k_), material(m) {
    static const int axes[3][3] = {{0, 1, 2}, {1, 2, 0}, {2, 0, 1}};
    ka = axes[plane][0]; aa = axes[plane][1]; ba = axes[plane][2];
  }
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    double t = (k - ray.o[ka]) / ray.d[ka];
    if (t < t_min || t > t_max) return false;
    double x = ray.o[aa] + t * ray.d[aa];
    double y = ray.o[ba] + t * ray.d[ba];
    if (x < x0 || x > x1 || y < y0 || y > y1) return false;
    rec.t = t;
    rec.u = (x - x0) / (x1 - x0);
    rec.v = (y - y0) / (y1 - y0);
    rec.p = ray.at(t);
    rec.normal = {0, 0, 0};
    rec.normal[ka] = 1.0;
    rec.material = material;
    return true;
  }
};

// src/hittable.rs:67-88
struct FlipNormals : Hittable {
  std::unique_ptr<Hittable> child;
  explicit FlipNormals(std::unique_ptr<Hittable> c) : child(std::move(c)) {}
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    if (!child->hit(ray, t_min, t_max, rec)) return false;
    rec.normal = -1.0 * rec.normal;
    return true;
  }
};

// src/hittable.rs:23-47 — linear scan with shrinking closest_so_far
struct HittableList : Hittable {
  std::vector<std::unique_ptr<Hittable>> list;
  void push(std::unique_ptr<Hittable> h) { list.push_back(std::move(h)); }
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    double closest = t_max;
    bool any = false;
    HitRecord tmp;
    for (const auto& h : list) {
      if (h->hit(ray, t_min, closest, tmp)) {
        closest = tmp.t;
        rec = tmp;
        any = true;
      }
    }
    return any;
  }
};

// src/cube.rs:8-86 — six Rects in a HittableList, no FlipNormals
struct Cube : Hittable {
  HittableList sides;
  Cube(V3 p_min, V3 p_max, const Material* m) {
    sides.push(std::make_unique<Rect>(2, p_min.x(), p_min.y(), p_max.x(), p_max.y(), p_max.z(), m));
    sides.push(std::make_unique<Rect>(2, p_min.x(), p_min.y(), p_max.x(), p_max.y(), p_min.z(), m));
    sides.push(std::make_unique<Rect>(1, p_min.z(), p_min.x(), p_max.z(), p_max.x(), p_max.y(), m));
    sides.push(std::make_unique<Rect>(1, p_min.z(), p_min.x(), p_max.z(), p_max.x(), p_min.y(), m));
    sides.push(std::make_unique<Rect>(0, p_min.y(), p_min.z(), p_max.y(), p_max.z(), p_max.x(), m));
    sides.push(std::make_unique<Rect>(0, p_min.y(), p_min.z(), p_max.y(), p_max.z(), p_min.x(), m));
  }
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    return sides.hit(ray, t_min, t_max, rec);
  }
};

// src/traslate.rs:18-24
struct Translate : Hittable {
  std::unique_ptr<Hittable> child;
  V3 offset;
  Translate(std::unique_ptr<Hittable> c, V3 off) : child(std::move(c)), offset(off) {}
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    Ray moved = {ray.o - offset, ray.d, ray.time};
    if (!child->hit(moved, t_min, t_max, rec)) return false;
    rec.p += offset;
    return true;
  }
};

// src/rotate.rs:85-118; axis 0=X,1=Y,2=Z → (r_axis, a_axis, b_axis)
struct Rotate : Hittable {
  std::unique_ptr<Hittable> child;
  int aa, ba;
  double sin_t, cos_t;
  Rotate(int axis, std::unique_ptr<Hittable> c, double angle_deg)
      : child(std::move(c)) {
    static const int axes[3][3] = {{0, 1, 2}, {1, 2, 0}, {2, 0, 1}};
    aa = axes[axis][1]; ba = axes[axis][2];
    double rad = angle_deg * M_PI / 180.0;
    sin_t = std::sin(rad);
    cos_t = std::cos(rad);
  }
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    V3 o = ray.o, d = ray.d;
    o[aa] = cos_t * ray.o[aa] + sin_t * ray.o[ba];
    o[ba] = -sin_t * ray.o[aa] + cos_t * ray.o[ba];
    d[aa] = cos_t * ray.d[aa] + sin_t * ray.d[ba];
    d[ba] = -sin_t * ray.d[aa] + cos_t * ray.d[ba];
    Ray rotated = {o, d, ray.time};
    if (!child->hit(rotated, t_min, t_max, rec)) return false;
    V3 p = rec.p, n = rec.normal;
    p[aa] = cos_t * rec.p[aa] - sin_t * rec.p[ba];
    p[ba] = sin_t * rec.p[aa] + cos_t * rec.p[ba];
    n[aa] = cos_t * rec.normal[aa] - sin_t * rec.normal[ba];
    n[ba] = sin_t * rec.normal[aa] + cos_t * rec.normal[ba];
    rec.p = p;
    rec.normal = n;
    return true;
  }
};

// src/medium.rs:28-56 — exact mirror of the reference's homogeneous volume:
// entry hit over (−MAX, MAX), exit hit from entry+1e−4, clamp to [t_min,
// t_max], free-flight distance −(1/ρ)·ln(U) against the inside span scaled
// by ‖d‖; a scatter event yields u=v=0, normal (1,0,0), Isotropic phase.
struct ConstantMedium : Hittable {
  std::unique_ptr<Hittable> boundary;
  double density;
  Isotropic phase;
  ConstantMedium(std::unique_ptr<Hittable> b, double d, const Texture* tex)
      : boundary(std::move(b)), density(d), phase(tex) {}
  bool hit(const Ray& ray, double t_min, double t_max,
           HitRecord& rec) const override {
    constexpr double kMax = std::numeric_limits<double>::max();
    HitRecord hit1, hit2;
    if (!boundary->hit(ray, -kMax, kMax, hit1)) return false;
    if (!boundary->hit(ray, hit1.t + 0.0001, kMax, hit2)) return false;
    if (hit1.t < t_min) hit1.t = t_min;       // medium.rs:32-37
    if (hit2.t > t_max) hit2.t = t_max;
    if (hit1.t >= hit2.t) return false;
    double dlen = magnitude(ray.d);
    double dist_inside = (hit2.t - hit1.t) * dlen;       // medium.rs:39
    double hit_dist = -(1.0 / density) * std::log(g_rng->uniform());
    if (hit_dist >= dist_inside) return false;           // medium.rs:41
    rec.t = hit1.t + hit_dist / dlen;                    // medium.rs:43
    rec.u = rec.v = 0.0;
    rec.p = ray.at(rec.t);
    rec.normal = {1.0, 0.0, 0.0};  // "choose arbitrary" (medium.rs:49)
    rec.material = &phase;
    return true;
  }
};

// ---- camera (src/camera.rs:21-67) -------------------------------------------

struct Camera {
  V3 origin, lower_left, horizontal, vertical, u, v;
  double time0, time1, lens_radius;
  Camera(V3 look_from, V3 look_at, V3 vup, double vfov_deg, double aspect,
         double aperture, double focus_dist, double t0, double t1) {
    double theta = vfov_deg * M_PI / 180.0;
    double half_h = focus_dist * std::tan(theta / 2.0);
    double half_w = aspect * half_h;
    V3 w = normalize(look_from - look_at);
    u = normalize(cross(vup, w));
    v = cross(w, u);
    origin = look_from;
    lower_left = look_from - half_w * u - half_h * v - focus_dist * w;
    horizontal = 2.0 * half_w * u;
    vertical = 2.0 * half_h * v;
    time0 = t0; time1 = t1;
    lens_radius = aperture / 2.0;
  }
  Ray get_ray(double s, double t) const {  // camera.rs:53-67
    V3 o = origin;
    if (lens_radius != 0.0) {
      V3 rd = lens_radius * random_in_unit_disk();
      o = origin + rd.x() * u + rd.y() * v;
    }
    double time = time0 + g_rng->uniform() * (time1 - time0);
    return {o, lower_left + s * horizontal + t * vertical - o, time};
  }
};

// ---- integrator (src/color.rs:6-23) -----------------------------------------

V3 color(const Ray& ray, const Hittable& world, int depth, int max_depth,
         int background) {
  HitRecord hit;
  if (world.hit(ray, 0.001, std::numeric_limits<double>::max(), hit)) {
    V3 emitted = hit.material->emitted(hit.u, hit.v, hit.p);
    if (depth < max_depth) {
      Ray scattered;
      V3 attenuation;
      if (hit.material->scatter(ray, hit, scattered, attenuation)) {
        return emitted + attenuation * color(scattered, world, depth + 1,
                                             max_depth, background);
      }
    }
    return emitted;
  }
  if (background == 1) {  // the book-1 sky the reference keeps commented out
    V3 unit = normalize(ray.d);
    double t = 0.5 * (unit.y() + 1.0);
    return (1.0 - t) * V3{1.0, 1.0, 1.0} + t * V3{0.5, 0.7, 1.0};
  }
  return {0, 0, 0};  // the reference's live behavior (color.rs:21)
}

// ---- scenes (tests/test.rs literals) ----------------------------------------

struct Scene {
  HittableList world;
  std::vector<std::unique_ptr<Material>> mats;
  std::vector<std::unique_ptr<Texture>> texs;
  template <class M, class... A>
  const Material* mat(A&&... a) {
    mats.push_back(std::make_unique<M>(std::forward<A>(a)...));
    return mats.back().get();
  }
  template <class T, class... A>
  const Texture* tex(A&&... a) {
    texs.push_back(std::make_unique<T>(std::forward<A>(a)...));
    return texs.back().get();
  }
  const Material* lamb(V3 albedo) {
    return mat<Lambertian>(tex<Solid>(albedo));
  }
};

// tests/test.rs:242-323 — exact literals, including the duplicated floor
// (ZX k=0 pushed both flipped and unflipped) and the XY k=555 back wall.
void build_cornell_box(Scene& s) {
  const Material* red = s.lamb(V3{0.65, 0.05, 0.05});
  const Material* white = s.lamb(V3{0.73, 0.73, 0.73});
  const Material* green = s.lamb(V3{0.12, 0.45, 0.15});
  const Material* light = s.mat<DiffuseLight>(V3{15.0, 15.0, 15.0});
  auto& w = s.world;
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(0, 0.0, 0.0, 555.0, 555.0, 555.0, green)));
  w.push(std::make_unique<Rect>(0, 0.0, 0.0, 555.0, 555.0, 0.0, red));
  w.push(std::make_unique<Rect>(1, 227.0, 213.0, 332.0, 343.0, 554.0, light));
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(1, 0.0, 0.0, 555.0, 555.0, 0.0, white)));
  w.push(std::make_unique<Rect>(1, 0.0, 0.0, 555.0, 555.0, 0.0, white));
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(2, 0.0, 0.0, 555.0, 555.0, 555.0, white)));
  w.push(std::make_unique<Translate>(
      std::make_unique<Rotate>(1,
          std::make_unique<Cube>(V3{0, 0, 0}, V3{165, 165, 165}, white),
          -18.0),
      V3{130, 0, 65}));
  w.push(std::make_unique<Translate>(
      std::make_unique<Rotate>(1,
          std::make_unique<Cube>(V3{0, 0, 0}, V3{165, 330, 165}, white),
          15.0),
      V3{265, 0, 295}));
}

// Small mixed-feature scene for the end-to-end oracle test: ground +
// lambertian/metal/dielectric spheres under the sky background. The JAX
// side builds the identical scene in tests/test_e2e_oracle.py.
void build_oracle_spheres(Scene& s) {
  auto& w = s.world;
  w.push(std::make_unique<Sphere>(V3{0, -1000, 0}, 1000.0,
                                  s.lamb(V3{0.5, 0.5, 0.5})));
  w.push(std::make_unique<Sphere>(V3{0, 1, 0}, 1.0,
                                  s.lamb(V3{0.4, 0.2, 0.1})));
  w.push(std::make_unique<Sphere>(V3{2.2, 1, 0}, 1.0,
                                  s.mat<Metal>(V3{0.7, 0.6, 0.5}, 0.2)));
  w.push(std::make_unique<Sphere>(V3{-2.2, 1, 0}, 1.0,
                                  s.mat<Dielectric>(1.5)));
}

// tests/test.rs:325-417 — exact literals EXCEPT the white wall the
// reference places at XY k=0 between the camera (z=−800) and the box
// (its own golden PPM is all black); like the framework's default
// (models/builders.py cornell_smoke), the oracle uses the book's back
// wall at k=555 so the comparison carries signal. Everything else is
// faithful: light ZX(127,113→432,443, k=554, emit 7), flipped floor,
// unflipped ceiling, the two rotated boxes wrapped in ConstantMedium
// densities 0.01 with albedos (1,1,1) and (0,0,0).
void build_cornell_smoke(Scene& s) {
  const Material* red = s.lamb(V3{0.65, 0.05, 0.05});
  const Material* white = s.lamb(V3{0.73, 0.73, 0.73});
  const Material* green = s.lamb(V3{0.12, 0.45, 0.15});
  const Material* light = s.mat<DiffuseLight>(V3{7.0, 7.0, 7.0});
  auto& w = s.world;
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(0, 0.0, 0.0, 555.0, 555.0, 555.0, green)));
  w.push(std::make_unique<Rect>(0, 0.0, 0.0, 555.0, 555.0, 0.0, red));
  w.push(std::make_unique<Rect>(1, 127.0, 113.0, 432.0, 443.0, 554.0, light));
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(1, 0.0, 0.0, 555.0, 555.0, 0.0, white)));
  w.push(std::make_unique<Rect>(1, 0.0, 0.0, 555.0, 555.0, 555.0, white));
  w.push(std::make_unique<FlipNormals>(
      std::make_unique<Rect>(2, 0.0, 0.0, 555.0, 555.0, 555.0, white)));
  auto box1 = std::make_unique<Translate>(
      std::make_unique<Rotate>(1,
          std::make_unique<Cube>(V3{0, 0, 0}, V3{165, 165, 165}, white),
          -18.0),
      V3{130, 0, 65});
  auto box2 = std::make_unique<Translate>(
      std::make_unique<Rotate>(1,
          std::make_unique<Cube>(V3{0, 0, 0}, V3{165, 330, 165}, white),
          15.0),
      V3{265, 0, 295});
  w.push(std::make_unique<ConstantMedium>(std::move(box1), 0.01,
                                          s.tex<Solid>(V3{1.0, 1.0, 1.0})));
  w.push(std::make_unique<ConstantMedium>(std::move(box2), 0.01,
                                          s.tex<Solid>(V3{0.0, 0.0, 0.0})));
}

// Motion-blur + checker oracle scene: the random_scene ground checker
// (tests/test.rs:93-101 literals) under a MovingSphere with the hero
// lambertian albedo (test.rs:148) rising 0.5 over t∈[0,1] exactly like the
// grid spheres (test.rs:117: center + (0, 0.5·U, 0), with U fixed at 1 for
// a deterministic endpoint), plus the hero metal sphere (test.rs:155-160).
// Sky background. The JAX side builds the identical scene in
// tests/test_e2e_oracle.py.
void build_moving_checker(Scene& s) {
  auto& w = s.world;
  const Texture* checker =
      s.tex<Checker>(s.tex<Solid>(V3{0.2, 0.3, 0.1}),
                     s.tex<Solid>(V3{0.9, 0.9, 0.9}));
  w.push(std::make_unique<Sphere>(V3{0, -1000, 0}, 1000.0,
                                  s.mat<Lambertian>(checker)));
  w.push(std::make_unique<MovingSphere>(V3{0, 1, 0}, V3{0, 1.5, 0}, 0.0,
                                        1.0, 1.0,
                                        s.lamb(V3{0.4, 0.2, 0.1})));
  w.push(std::make_unique<Sphere>(V3{2.2, 1, 0}, 1.0,
                                  s.mat<Metal>(V3{0.7, 0.6, 0.5}, 0.0)));
}

// Image-texture oracle scene: the earth config (tests/test.rs:200-209,
// 645-683 — one image-textured r=2 sphere at the origin, sky background,
// aperture 0.1) with earthmap.jpg replaced by a deterministic synthetic
// 32×16 RGB byte pattern generated by the identical integer formula on
// the JAX side (tests/test_e2e_oracle.py) — pins ImageTexture's nearest
// fetch / v-flip / clamp semantics AND the sphere-UV mapping including
// the reference's FRAC_2_PI quirk, absolutely.
void build_earth_image(Scene& s) {
  const int w = 32, h = 16;
  std::vector<unsigned char> px(3 * w * h);
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i) {
      size_t o = 3 * (static_cast<size_t>(j) * w + i);
      px[o] = static_cast<unsigned char>((8 * i + 3 * j) % 256);
      px[o + 1] = static_cast<unsigned char>((5 * i + 11 * j) % 256);
      px[o + 2] = static_cast<unsigned char>((i * j) % 256);
    }
  s.world.push(std::make_unique<Sphere>(
      V3{0, 0, 0}, 2.0,
      s.mat<Lambertian>(s.tex<Image>(std::move(px), w, h))));
}

// Free-flight density oracle scene: cornell_smoke (scene_id 2) pins the
// medium's INTEGRATION but has almost no density sensitivity — its white
// box scatters losslessly (albedo 1 conserves flux) and its black box is
// already opaque at 0.01·165, so even DOUBLING the density moves every
// luminance statistic by <0.003 (measured). This scene maximizes
// d(luminance)/d(density): a 100-unit slab of gray (albedo 0.3) medium
// between the camera and a large unit emitter — direct transmission
// exp(−ρ·100) dominates, so a 30% density error shifts the image mean by
// ~25%. Geometry is framework-API-expressible (medium_box + diffuse_light
// rect, black background); the JAX side builds the identical scene in
// tests/test_e2e_oracle.py.
void build_fog_slab(Scene& s) {
  auto& w = s.world;
  const Material* glow = s.mat<DiffuseLight>(V3{1.0, 1.0, 1.0});
  w.push(std::make_unique<Rect>(2, -100.0, -100.0, 100.0, 100.0, -50.0,
                                glow));
  w.push(std::make_unique<ConstantMedium>(
      std::make_unique<Cube>(V3{-100, -100, 0}, V3{100, 100, 100},
                             s.lamb(V3{0.0, 0.0, 0.0})),
      0.01, s.tex<Solid>(V3{0.3, 0.3, 0.3})));
}

// Noise oracle scene: simple_light exactly (tests/test.rs:211-240,
// 685-723 — noise ground + noise sphere, two emitters 4·(1,1,1), black
// background) with the reference's unseeded table Perlin replaced by the
// framework's hash-gradient field (seed 0) on BOTH sides — the JAX side
// builds PRESETS["simple_light"] with the default perlin_seed=0. Pins the
// marble formula, octave sum, lattice hash, and the noise scene's whole
// radiometry against an implementation that shares no code with the JAX
// tiers. (The reference's own noise field is unmatchable by design — its
// tables come from an unseeded thread RNG; README documents the
// deviation.)
void build_simple_light_noise(Scene& s) {
  auto& w = s.world;
  const Material* lam = s.mat<Lambertian>(s.tex<HashNoise>(4.0, 0u));
  w.push(std::make_unique<Sphere>(V3{0, -1000, 0}, 1000.0, lam));
  w.push(std::make_unique<Sphere>(V3{0, 2, 0}, 2.0, lam));
  const Material* light = s.mat<DiffuseLight>(V3{4.0, 4.0, 4.0});
  w.push(std::make_unique<Sphere>(V3{0, 7, 0}, 2.0, light));
  w.push(std::make_unique<Rect>(2, 3.0, 1.0, 5.0, 3.0, -2.0, light));
}

}  // namespace

extern "C" {

// Renders scene_id (0 = cornell_box, 1 = oracle_spheres, 2 = cornell_smoke
// with the fixed back wall, 3 = moving_checker, 4 = earth_image,
// 5 = simple_light_noise, 6 = fog_slab) with the
// reference's create_image loop (tests/test.rs:55-85): rows j = ny-1..0,
// ns jittered samples per pixel, recursive color(), gamma sqrt + clamp +
// (255.99*c) quantize. Writes the PRE-gamma per-pixel mean radiance to
// out_mean (row 0 = top scanline, [ny*nx*3]) and the quantized-byte sum to
// out_qsum (keeps the gamma/quantize work observable). Returns wall seconds
// of the render loop only (scene/camera build excluded), or -1.0 on a bad
// scene id.
double ref_trace(int scene_id, int nx, int ny, int ns, int max_depth,
                 unsigned long long seed, int background,
                 const double* look_from, const double* look_at,
                 const double* vup, double vfov, double aperture,
                 double focus_dist, double time0, double time1,
                 double* out_mean, long long* out_qsum) {
  Scene scene;
  if (scene_id == 0) build_cornell_box(scene);
  else if (scene_id == 1) build_oracle_spheres(scene);
  else if (scene_id == 2) build_cornell_smoke(scene);
  else if (scene_id == 3) build_moving_checker(scene);
  else if (scene_id == 4) build_earth_image(scene);
  else if (scene_id == 5) build_simple_light_noise(scene);
  else if (scene_id == 6) build_fog_slab(scene);
  else return -1.0;

  Camera cam({look_from[0], look_from[1], look_from[2]},
             {look_at[0], look_at[1], look_at[2]},
             {vup[0], vup[1], vup[2]}, vfov,
             static_cast<double>(nx) / static_cast<double>(ny), aperture,
             focus_dist, time0, time1);
  Rng rng(seed);
  g_rng = &rng;

  long long qsum = 0;
  const auto start = std::chrono::steady_clock::now();
  for (int j = ny - 1; j >= 0; --j) {    // test.rs:62 row order
    for (int i = 0; i < nx; ++i) {
      V3 col = {0, 0, 0};
      for (int s = 0; s < ns; ++s) {     // test.rs:65-70
        double u = (i + rng.uniform()) / nx;
        double v = (j + rng.uniform()) / ny;
        Ray ray = cam.get_ray(u, v);
        col += color(ray, scene.world, 0, max_depth, background);
      }
      col = col / static_cast<double>(ns);
      double* px = out_mean + 3 * ((ny - 1 - j) * static_cast<long>(nx) + i);
      for (int c = 0; c < 3; ++c) {
        px[c] = col[c];
        // gamma 2.0 + clamp + quantize (test.rs:72-78)
        double g = std::sqrt(col[c]);
        g = g < 0.0 ? 0.0 : (g > 1.0 ? 1.0 : g);
        qsum += static_cast<int>(255.99 * g);
      }
    }
  }
  const auto end = std::chrono::steady_clock::now();
  g_rng = nullptr;
  *out_qsum = qsum;
  return std::chrono::duration<double>(end - start).count();
}

// Direct pointwise export of the hash-Perlin turbulence field: the
// renders above pin the noise-scene RADIOMETRY, but two different valid
// noise fields produce statistically identical half-means — this lets
// tests compare the FIELD itself against ops/perlin.py:turb at exact
// points (deterministic, no Monte Carlo floor).
void ref_hash_turb(const double* pts, int n, int depth,
                   unsigned int seed, double* out) {
  for (int i = 0; i < n; ++i)
    out[i] = hash_perlin::turb({pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]},
                               depth, seed);
}

}  // extern "C"
