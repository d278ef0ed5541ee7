// Native Gilbert-curve walker + block neighbor-mask builder.
//
// C++ twin of rectified_spaattn_tpu_torch/curves/gilbert.py (same splitting
// rules; see that file for the algorithm notes).  The curve build is the
// slowest host-side step of pipeline setup at video scale; this walker is
// ~40x the Python generator's speed.  Exposed through ctypes
// (curves/native.py) with transparent fallback to the Python path.
//
// Build:  make -C rectified_spaattn_tpu_torch/csrc OUT=<path>.so
// (curves/native.py does this at first use, into the package's build/)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  int64_t x, y, z;
  V3 operator+(const V3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator-() const { return {-x, -y, -z}; }
};

inline int64_t sgn(int64_t v) { return (v > 0) - (v < 0); }
inline V3 sgn3(const V3 &v) { return {sgn(v.x), sgn(v.y), sgn(v.z)}; }
inline int64_t norm(const V3 &v) { return std::llabs(v.x + v.y + v.z); }
// Python-// semantics: floor division (C++ / truncates toward zero).
inline int64_t fdiv2(int64_t v) { return v >= 0 ? v / 2 : -((-v + 1) / 2); }
inline V3 halve(const V3 &v) { return {fdiv2(v.x), fdiv2(v.y), fdiv2(v.z)}; }

struct Frame {
  V3 o, a, b, c;
};

// Walk the generalized Hilbert curve; out[i*3..] = (x, y, z) of step i.
void walk(V3 origin, V3 a0, V3 b0, V3 c0, int64_t *out) {
  std::vector<Frame> stack;
  stack.reserve(1024);
  stack.push_back({origin, a0, b0, c0});
  size_t pos = 0;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const int64_t w = norm(f.a), h = norm(f.b), d = norm(f.c);
    const V3 da = sgn3(f.a), db = sgn3(f.b), dc = sgn3(f.c);

    // trivial runs
    const V3 *dv = nullptr;
    int64_t run = 0;
    if (h == 1 && d == 1) { run = w; dv = &da; }
    else if (w == 1 && d == 1) { run = h; dv = &db; }
    else if (w == 1 && h == 1) { run = d; dv = &dc; }
    if (dv) {
      V3 p = f.o;
      for (int64_t i = 0; i < run; ++i) {
        out[pos * 3 + 0] = p.x;
        out[pos * 3 + 1] = p.y;
        out[pos * 3 + 2] = p.z;
        ++pos;
        p = p + *dv;
      }
      continue;
    }

    V3 a2 = halve(f.a), b2 = halve(f.b), c2 = halve(f.c);
    if ((norm(a2) % 2) && (w > 2)) a2 = a2 + da;
    if ((norm(b2) % 2) && (h > 2)) b2 = b2 + db;
    if ((norm(c2) % 2) && (d > 2)) c2 = c2 + dc;

    Frame ch[5];
    int n = 0;
    if ((2 * w > 3 * h) && (2 * w > 3 * d)) {
      ch[n++] = {f.o, a2, f.b, f.c};
      ch[n++] = {f.o + a2, f.a - a2, f.b, f.c};
    } else if (3 * h > 4 * d) {
      ch[n++] = {f.o, b2, f.c, a2};
      ch[n++] = {f.o + b2, f.a, f.b - b2, f.c};
      ch[n++] = {f.o + (f.a - da) + (b2 - db), -b2, f.c, -(f.a - a2)};
    } else if (3 * d > 4 * h) {
      ch[n++] = {f.o, c2, a2, f.b};
      ch[n++] = {f.o + c2, f.a, f.b, f.c - c2};
      ch[n++] = {f.o + (f.a - da) + (c2 - dc), -c2, -(f.a - a2), f.b};
    } else {
      ch[n++] = {f.o, b2, c2, a2};
      ch[n++] = {f.o + b2, f.c, a2, f.b - b2};
      ch[n++] = {f.o + (b2 - db) + (f.c - dc), f.a, -b2, -(f.c - c2)};
      ch[n++] = {f.o + (f.a - da) + b2 + (f.c - dc), -f.c, -(f.a - a2),
                 f.b - b2};
      ch[n++] = {f.o + (f.a - da) + (b2 - db), -b2, c2, -(f.a - a2)};
    }
    for (int i = n - 1; i >= 0; --i) stack.push_back(ch[i]);
  }
}

}  // namespace

extern "C" {

// axis_order: 0 = size-based default, else packed digits naming the
// (major, mid, minor) axes with 1=w, 2=h, 3=t  (e.g. 123 = ("w","h","t")).
void gilbert3d_path(int64_t width, int64_t height, int64_t depth,
                    int64_t axis_order, int64_t *out) {
  V3 W{width, 0, 0}, H{0, height, 0}, T{0, 0, depth};
  V3 a, b, c;
  if (axis_order == 0) {
    if (width >= height && width >= depth) { a = W; b = H; c = T; }
    else if (height >= width && height >= depth) { a = H; b = W; c = T; }
    else { a = T; b = W; c = H; }
  } else {
    const V3 axes[4] = {{0, 0, 0}, W, H, T};
    a = axes[(axis_order / 100) % 10];
    b = axes[(axis_order / 10) % 10];
    c = axes[axis_order % 10];
  }
  walk({0, 0, 0}, a, b, c, out);
}

// 26-neighborhood adjacency of curve blocks.  colors: [t*h*w] block id per
// voxel (z-major linear order); adj: [nb*nb] bytes (in/out, or-ed into).
void block_neighbors(const int64_t *colors, int64_t t, int64_t h, int64_t w,
                     int64_t nb, uint8_t *adj) {
  for (int64_t i = 0; i < nb; ++i) adj[i * nb + i] = 1;
  for (int64_t z = 0; z < t; ++z)
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        const int64_t c = colors[(z * h + y) * w + x];
        for (int64_t dz = -1; dz <= 1; ++dz) {
          const int64_t nz = z + dz;
          if (nz < 0 || nz >= t) continue;
          for (int64_t dy = -1; dy <= 1; ++dy) {
            const int64_t ny = y + dy;
            if (ny < 0 || ny >= h) continue;
            for (int64_t dx = -1; dx <= 1; ++dx) {
              const int64_t nx = x + dx;
              if (nx < 0 || nx >= w) continue;
              adj[c * nb + colors[(nz * h + ny) * w + nx]] = 1;
            }
          }
        }
      }
}

}  // extern "C"
