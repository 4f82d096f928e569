// lcgan_torch native input pipeline (a copy of lcgan_tpu/native/loader.cpp).
//
// C++ equivalent of the reference's CPU-side hot path — decode, Lanczos
// square resize, and the triple-view augmentation (custom_dataset.py:59-88):
//   base view:       shared random h-flip
//   geometry view:   random 4-corner perspective warp, albumentations
//                    semantics (two variants: fit-output and crop-zoom,
//                    p=0.5 each)
//   appearance view: coarse dropout (1 hole, 30-50% per side) OR color
//                    jitter (brightness/contrast/saturation/hue 0.2), p=0.5
//
// Why native: on production hosts the input pipeline runs tens of
// workers; a Python per-sample path serializes on the GIL. This library
// decodes (libjpeg/libpng) and augments entirely in C++ with its own
// pthread pool, exposed to Python through a minimal ctypes C API.
//
// Determinism: every sample derives its own splitmix64/xoshiro stream from
// (seed, index) — results are reproducible regardless of thread schedule.
//
// Build (same recipe __init__.py uses, into lcgan_torch/_build/; std::clamp
// needs C++17):
//   g++ -O3 -std=c++17 -shared -fPIC loader.cpp -o liblcgan_loader.so -ljpeg -lpng -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

// ----------------------------------------------------------------------
// RNG: splitmix64 seeded xoshiro256++
// ----------------------------------------------------------------------
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + uniform() * (hi - lo); }
  // Box-Muller
  double normal() {
    double u1 = std::max(uniform(), 1e-12), u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }
};

// ----------------------------------------------------------------------
// Decoding
// ----------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// returns RGB8 buffer (malloc'd) or nullptr
uint8_t* decode_jpeg(FILE* f, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: `out` is written between setjmp and longjmp — without it the
  // register copy restored by longjmp is indeterminate (C11 7.13.2.1p3) and
  // in practice reverts to nullptr, leaking the buffer on corrupt images
  uint8_t* volatile out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out = (uint8_t*)malloc((size_t)(*w) * (*h) * 3);
  if (!out) longjmp(jerr.jb, 1);  // decompression bomb / OOM → failure, not UB
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

uint8_t* decode_png(FILE* f, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  // volatile + malloc'd row array: both are written between setjmp and a
  // possible longjmp (corrupt IDAT), so register-cached copies would be
  // indeterminate after the jump (C11 7.13.2.1p3) and leak the buffers
  uint8_t* volatile out = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(rows);
    free(out);
    return nullptr;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out = (uint8_t*)malloc((size_t)(*w) * (*h) * 3);
  rows = (png_bytep*)malloc((size_t)(*h) * sizeof(png_bytep));
  if (!out || !rows) longjmp(png_jmpbuf(png), 1);  // bomb/OOM → failure
  for (int y = 0; y < *h; y++) rows[y] = out + (size_t)y * (*w) * 3;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  return out;
}

uint8_t* decode_image(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  fseek(f, 0, SEEK_SET);
  uint8_t* out = nullptr;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    out = decode_jpeg(f, w, h);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    out = decode_png(f, w, h);
  }
  fclose(f);
  return out;
}

// ----------------------------------------------------------------------
// Lanczos-3 separable resize (PIL LANCZOS-family kernel)
// ----------------------------------------------------------------------
inline double lanczos3(double x) {
  x = std::fabs(x);
  if (x >= 3.0) return 0.0;
  if (x < 1e-9) return 1.0;
  double pix = 3.141592653589793 * x;
  return 3.0 * std::sin(pix) * std::sin(pix / 3.0) / (pix * pix);
}

// resize one axis: in (n_in) -> out (n_out) with per-output precomputed taps
struct ResizePlan {
  std::vector<int> start;      // first input tap per output
  std::vector<int> count;      // taps per output
  std::vector<float> weights;  // flattened [n_out x max_count]
  int max_count = 0;
};

ResizePlan plan_resize(int n_in, int n_out) {
  ResizePlan p;
  double scale = (double)n_in / n_out;
  double support = 3.0 * std::max(scale, 1.0);
  p.max_count = (int)std::ceil(support * 2 + 1);
  p.start.resize(n_out);
  p.count.resize(n_out);
  p.weights.assign((size_t)n_out * p.max_count, 0.f);
  double inv = std::max(scale, 1.0);
  for (int o = 0; o < n_out; o++) {
    double center = (o + 0.5) * scale;
    int lo = std::max(0, (int)std::floor(center - support + 0.5));
    int hi = std::min(n_in, (int)std::floor(center + support + 0.5));
    double total = 0;
    for (int i = lo; i < hi; i++)
      total += lanczos3((i + 0.5 - center) / inv);
    p.start[o] = lo;
    p.count[o] = hi - lo;
    for (int i = lo; i < hi; i++)
      p.weights[(size_t)o * p.max_count + (i - lo)] =
          (float)(lanczos3((i + 0.5 - center) / inv) / (total > 0 ? total : 1.0));
  }
  return p;
}

inline uint8_t clamp_u8(float v) {
  return (uint8_t)std::min(255.f, std::max(0.f, v + 0.5f));
}

// RGB8 (h_in,w_in) -> RGB8 (size,size)
void lanczos_resize(const uint8_t* in, int w_in, int h_in, uint8_t* out, int size) {
  ResizePlan px = plan_resize(w_in, size);
  ResizePlan py = plan_resize(h_in, size);
  // horizontal pass to float intermediate (h_in, size, 3)
  std::vector<float> tmp((size_t)h_in * size * 3);
  for (int y = 0; y < h_in; y++) {
    const uint8_t* row = in + (size_t)y * w_in * 3;
    float* trow = tmp.data() + (size_t)y * size * 3;
    for (int o = 0; o < size; o++) {
      float r = 0, g = 0, b = 0;
      int s = px.start[o], c = px.count[o];
      const float* wts = &px.weights[(size_t)o * px.max_count];
      for (int k = 0; k < c; k++) {
        const uint8_t* pix = row + (size_t)(s + k) * 3;
        float wgt = wts[k];
        r += wgt * pix[0]; g += wgt * pix[1]; b += wgt * pix[2];
      }
      trow[o * 3 + 0] = r; trow[o * 3 + 1] = g; trow[o * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int o = 0; o < size; o++) {
    int s = py.start[o], c = py.count[o];
    const float* wts = &py.weights[(size_t)o * py.max_count];
    uint8_t* orow = out + (size_t)o * size * 3;
    for (int x = 0; x < size * 3; x++) {
      float acc = 0;
      for (int k = 0; k < c; k++)
        acc += wts[k] * tmp[(size_t)(s + k) * size * 3 + x];
      orow[x] = clamp_u8(acc);
    }
  }
}

// ----------------------------------------------------------------------
// Augmentations (uint8 RGB, square size x size)
// ----------------------------------------------------------------------
void hflip(uint8_t* img, int size) {
  for (int y = 0; y < size; y++) {
    uint8_t* row = img + (size_t)y * size * 3;
    for (int x = 0; x < size / 2; x++) {
      for (int c = 0; c < 3; c++)
        std::swap(row[x * 3 + c], row[(size - 1 - x) * 3 + c]);
    }
  }
}

// homography mapping src quad -> dst quad; returns H as row-major 3x3
// (solves the 8x8 DLT system with Gaussian elimination)
bool solve_homography(const double src[4][2], const double dst[4][2], double H[9]) {
  double A[8][9];
  for (int i = 0; i < 4; i++) {
    double x = src[i][0], y = src[i][1], u = dst[i][0], v = dst[i][1];
    double r0[9] = {x, y, 1, 0, 0, 0, -u * x, -u * y, u};
    double r1[9] = {0, 0, 0, x, y, 1, -v * x, -v * y, v};
    memcpy(A[i * 2], r0, sizeof r0);
    memcpy(A[i * 2 + 1], r1, sizeof r1);
  }
  for (int col = 0; col < 8; col++) {
    int piv = col;
    for (int r = col + 1; r < 8; r++)
      if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
    if (std::fabs(A[piv][col]) < 1e-12) return false;
    if (piv != col)
      for (int k = 0; k < 9; k++) std::swap(A[piv][k], A[col][k]);
    for (int r = 0; r < 8; r++) {
      if (r == col) continue;
      double f = A[r][col] / A[col][col];
      for (int k = col; k < 9; k++) A[r][k] -= f * A[col][k];
    }
  }
  for (int i = 0; i < 8; i++) H[i] = A[i][8] / A[i][i];
  H[8] = 1.0;
  return true;
}

void invert3x3(const double m[9], double inv[9]) {
  double det = m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
               m[2] * (m[3] * m[7] - m[4] * m[6]);
  double id = 1.0 / det;
  inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
  inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
  inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
  inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
  inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
  inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
  inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
  inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
  inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
}

// inverse-map bilinear warp, black border; in is (size x size),
// out is (out_h x out_w)
void warp_perspective(const uint8_t* in, uint8_t* out, int size, int out_w,
                      int out_h, const double H[9]) {
  double Hi[9];
  invert3x3(H, Hi);
  for (int y = 0; y < out_h; y++) {
    uint8_t* orow = out + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; x++) {
      double d = Hi[6] * x + Hi[7] * y + Hi[8];
      if (std::fabs(d) < 1e-12) {  // horizon line: no finite source pixel
        orow[x * 3 + 0] = orow[x * 3 + 1] = orow[x * 3 + 2] = 0;
        continue;
      }
      double sx = (Hi[0] * x + Hi[1] * y + Hi[2]) / d;
      double sy = (Hi[3] * x + Hi[4] * y + Hi[5]) / d;
      // clamp before the int cast: double→int outside int range is UB
      sx = std::clamp(sx, -2.0, (double)size + 2.0);
      sy = std::clamp(sy, -2.0, (double)size + 2.0);
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      float fx = (float)(sx - x0), fy = (float)(sy - y0);
      for (int c = 0; c < 3; c++) {
        float acc = 0;
        for (int dy = 0; dy < 2; dy++) {
          int yy = y0 + dy;
          if (yy < 0 || yy >= size) continue;
          float wy = dy ? fy : 1.f - fy;
          for (int dx = 0; dx < 2; dx++) {
            int xx = x0 + dx;
            if (xx < 0 || xx >= size) continue;
            float wx = dx ? fx : 1.f - fx;
            acc += wy * wx * in[((size_t)yy * size + xx) * 3 + c];
          }
        }
        orow[x * 3 + c] = clamp_u8(acc);
      }
    }
  }
}

// cv2.resize(INTER_LINEAR) semantics: half-pixel centers, edge clamp
void bilinear_resize(const uint8_t* in, int w_in, int h_in, uint8_t* out,
                     int w_out, int h_out) {
  double sx_ratio = (double)w_in / w_out, sy_ratio = (double)h_in / h_out;
  for (int y = 0; y < h_out; y++) {
    double sy = (y + 0.5) * sy_ratio - 0.5;
    int y0 = (int)std::floor(sy);
    float fy = (float)(sy - y0);
    int ya = std::clamp(y0, 0, h_in - 1), yb = std::clamp(y0 + 1, 0, h_in - 1);
    uint8_t* orow = out + (size_t)y * w_out * 3;
    for (int x = 0; x < w_out; x++) {
      double sx = (x + 0.5) * sx_ratio - 0.5;
      int x0 = (int)std::floor(sx);
      float fx = (float)(sx - x0);
      int xa = std::clamp(x0, 0, w_in - 1), xb = std::clamp(x0 + 1, 0, w_in - 1);
      const uint8_t* r0 = in + ((size_t)ya * w_in) * 3;
      const uint8_t* r1 = in + ((size_t)yb * w_in) * 3;
      for (int c = 0; c < 3; c++) {
        float top = r0[xa * 3 + c] * (1.f - fx) + r0[xb * 3 + c] * fx;
        float bot = r1[xa * 3 + c] * (1.f - fx) + r1[xb * 3 + c] * fx;
        orow[x * 3 + c] = clamp_u8(top * (1.f - fy) + bot * fy);
      }
    }
  }
}

// albumentations.Perspective(scale=(0.05,0.1), keep_size=True) semantics
// (mirrors lcgan_torch/data/augment.py random_perspective): inward
// |N(0,scale)| mod 0.32 corner jitter, source QUAD mapped to an output
// rect sized by the quad's extents (fit_output=False → border-free
// crop-zoom; True → transform expanded to show the whole warped frame),
// then bilinear resize back to size.
void random_perspective(const uint8_t* in, uint8_t* out, int size, Rng& rng) {
  bool fit_output = rng.uniform() < 0.5;
  double scale = rng.uniform(0.05, 0.1);
  double p[4][2];
  for (int i = 0; i < 4; i++)
    for (int c = 0; c < 2; c++) p[i][c] = std::fmod(std::fabs(rng.normal() * scale), 0.32);
  double quad[4][2] = {
      {p[0][0] * size, p[0][1] * size},
      {(1.0 - p[1][0]) * size, p[1][1] * size},
      {(1.0 - p[2][0]) * size, (1.0 - p[2][1]) * size},
      {p[3][0] * size, (1.0 - p[3][1]) * size},
  };
  auto dist = [](const double a[2], const double b[2]) {
    return std::hypot(a[0] - b[0], a[1] - b[1]);
  };
  int mw = (int)std::max((double)(int)dist(quad[2], quad[3]), (double)(int)dist(quad[1], quad[0]));
  int mh = (int)std::max((double)(int)dist(quad[1], quad[2]), (double)(int)dist(quad[0], quad[3]));
  mw = std::max(mw, 2); mh = std::max(mh, 2);
  double rect[4][2] = {{0, 0}, {mw - 1.0, 0}, {mw - 1.0, mh - 1.0}, {0, mh - 1.0}};
  double H[9];
  if (!solve_homography(quad, rect, H)) {
    memcpy(out, in, (size_t)size * size * 3);
    return;
  }
  if (fit_output) {
    // transform the source frame's corners, shift to >= 0, round, re-solve
    double frame[4][2] = {{0, 0}, {size - 1.0, 0}, {size - 1.0, size - 1.0}, {0, size - 1.0}};
    double tc[4][2];
    double mnx = 1e30, mny = 1e30;
    for (int i = 0; i < 4; i++) {
      double d = H[6] * frame[i][0] + H[7] * frame[i][1] + H[8];
      tc[i][0] = (H[0] * frame[i][0] + H[1] * frame[i][1] + H[2]) / d;
      tc[i][1] = (H[3] * frame[i][0] + H[4] * frame[i][1] + H[5]) / d;
      mnx = std::min(mnx, tc[i][0]);
      mny = std::min(mny, tc[i][1]);
    }
    double mxx = 0, mxy = 0;
    for (int i = 0; i < 4; i++) {
      tc[i][0] = std::round(tc[i][0] - mnx);
      tc[i][1] = std::round(tc[i][1] - mny);
      mxx = std::max(mxx, tc[i][0]);
      mxy = std::max(mxy, tc[i][1]);
    }
    if (!solve_homography(frame, tc, H)) {
      memcpy(out, in, (size_t)size * size * 3);
      return;
    }
    mw = (int)mxx + 1;
    mh = (int)mxy + 1;
  }
  std::vector<uint8_t> tmp((size_t)mw * mh * 3);
  warp_perspective(in, tmp.data(), size, mw, mh, H);
  if (mw == size && mh == size) {
    memcpy(out, tmp.data(), (size_t)size * size * 3);
  } else {
    bilinear_resize(tmp.data(), mw, mh, out, size, size);  // keep_size
  }
}

void coarse_dropout(const uint8_t* in, uint8_t* out, int size, Rng& rng) {
  memcpy(out, in, (size_t)size * size * 3);
  int hh = (int)(rng.uniform(0.3, 0.5) * size);
  int ww = (int)(rng.uniform(0.3, 0.5) * size);
  // +1: inclusive placement bound (random.randint semantics) so the hole
  // can sit flush with the bottom/right edge
  int y0 = (int)(rng.uniform() * (std::max(size - hh, 0) + 1));
  int x0 = (int)(rng.uniform() * (std::max(size - ww, 0) + 1));
  for (int y = y0; y < y0 + hh && y < size; y++)
    memset(out + ((size_t)y * size + x0) * 3, 0, (size_t)std::min(ww, size - x0) * 3);
}

void rgb2hsv(float r, float g, float b, float* h, float* s, float* v) {
  float mx = std::max({r, g, b}), mn = std::min({r, g, b}), d = mx - mn;
  *v = mx;
  *s = mx > 0 ? d / mx : 0;
  if (d <= 0) { *h = 0; return; }
  float hh;
  if (mx == r) hh = (g - b) / d;
  else if (mx == g) hh = 2 + (b - r) / d;
  else hh = 4 + (r - g) / d;
  hh /= 6;
  if (hh < 0) hh += 1;
  *h = hh;
}

void hsv2rgb(float h, float s, float v, float* r, float* g, float* b) {
  h = h - std::floor(h);
  float i = std::floor(h * 6);
  float f = h * 6 - i;
  float p = v * (1 - s), q = v * (1 - f * s), t = v * (1 - (1 - f) * s);
  switch ((int)i % 6) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

void color_jitter(const uint8_t* in, uint8_t* out, int size, Rng& rng) {
  const float strength = 0.2f;
  // random op order (Fisher-Yates over 4 ops), torchvision semantics
  int order[4] = {0, 1, 2, 3};
  for (int i = 3; i > 0; i--) {
    int j = (int)(rng.uniform() * (i + 1));
    std::swap(order[i], order[j]);
  }
  float fb = (float)rng.uniform(1 - strength, 1 + strength);
  float fc = (float)rng.uniform(1 - strength, 1 + strength);
  float fs = (float)rng.uniform(1 - strength, 1 + strength);
  float fh = (float)rng.uniform(-strength, strength);

  size_t n = (size_t)size * size;
  std::vector<float> buf(n * 3);
  for (size_t i = 0; i < n * 3; i++) buf[i] = in[i];

  for (int oi = 0; oi < 4; oi++) {
    switch (order[oi]) {
      case 0:  // brightness
        for (size_t i = 0; i < n * 3; i++) buf[i] = std::min(255.f, std::max(0.f, buf[i] * fb));
        break;
      case 1: {  // contrast: blend with rounded mean gray
        double mean = 0;
        for (size_t i = 0; i < n; i++)
          mean += 0.299 * buf[i * 3] + 0.587 * buf[i * 3 + 1] + 0.114 * buf[i * 3 + 2];
        float gray = (float)std::round(mean / n);
        for (size_t i = 0; i < n * 3; i++)
          buf[i] = std::min(255.f, std::max(0.f, buf[i] * fc + gray * (1 - fc)));
        break;
      }
      case 2:  // saturation: blend with per-pixel gray
        for (size_t i = 0; i < n; i++) {
          float gray = 0.299f * buf[i * 3] + 0.587f * buf[i * 3 + 1] + 0.114f * buf[i * 3 + 2];
          for (int c = 0; c < 3; c++)
            buf[i * 3 + c] = std::min(255.f, std::max(0.f, buf[i * 3 + c] * fs + gray * (1 - fs)));
        }
        break;
      default:  // hue
        for (size_t i = 0; i < n; i++) {
          float h, s, v, r, g, b;
          rgb2hsv(buf[i * 3] / 255.f, buf[i * 3 + 1] / 255.f, buf[i * 3 + 2] / 255.f, &h, &s, &v);
          hsv2rgb(h + fh, s, v, &r, &g, &b);
          buf[i * 3] = r * 255.f; buf[i * 3 + 1] = g * 255.f; buf[i * 3 + 2] = b * 255.f;
        }
        break;
    }
  }
  for (size_t i = 0; i < n * 3; i++) out[i] = clamp_u8(buf[i]);
}

}  // namespace

// ----------------------------------------------------------------------
// C API (ctypes)
// ----------------------------------------------------------------------
extern "C" {

// Load one training triple: returns 0 on success.
// out buffers: size*size*3 uint8 each (image, geometry_change, appearance_change).
int lcg_load_triple(const char* path, int size, uint64_t seed,
                    uint8_t* out_img, uint8_t* out_geo, uint8_t* out_app) {
  int w = 0, h = 0;
  uint8_t* raw = decode_image(path, &w, &h);
  if (!raw) return 1;
  if (w == size && h == size) {
    memcpy(out_img, raw, (size_t)size * size * 3);
  } else {
    lanczos_resize(raw, w, h, out_img, size);
  }
  free(raw);
  Rng rng(seed);
  if (rng.uniform() < 0.5) hflip(out_img, size);  // shared h-flip
  random_perspective(out_img, out_geo, size, rng);
  if (rng.uniform() < 0.5) {
    coarse_dropout(out_img, out_app, size, rng);
  } else {
    color_jitter(out_img, out_app, size, rng);
  }
  return 0;
}

// Eval-mode load: decode + resize only.
int lcg_load_image(const char* path, int size, uint8_t* out_img) {
  int w = 0, h = 0;
  uint8_t* raw = decode_image(path, &w, &h);
  if (!raw) return 1;
  if (w == size && h == size) {
    memcpy(out_img, raw, (size_t)size * size * 3);
  } else {
    lanczos_resize(raw, w, h, out_img, size);
  }
  free(raw);
  return 0;
}

// Batch load with an internal thread pool. paths: array of n C strings.
// Outputs are (n, size, size, 3) uint8, C-contiguous. seeds: n uint64.
// status: n int32 per-sample codes (0 == ok, 1 == failed) so the caller
// can fall back for exactly the failed samples (a single unsupported
// format or transient IO error must not poison the whole batch).
// Returns number of failures (0 == all good).
int lcg_load_batch(const char** paths, int n, int size, const uint64_t* seeds,
                   uint8_t* out_img, uint8_t* out_geo, uint8_t* out_app,
                   int num_threads, int32_t* status) {
  std::atomic<int> next(0), failures(0);
  size_t stride = (size_t)size * size * 3;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = lcg_load_triple(paths[i], size, seeds[i],
                               out_img + i * stride, out_geo + i * stride,
                               out_app + i * stride);
      if (status) status[i] = rc ? 1 : 0;
      if (rc) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; t++) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
