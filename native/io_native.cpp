// Native asset-ingest library: OBJ triangle-soup parsing + Radiance RGBE
// (.hdr) decoding.
//
// This is the native-capability counterpart of the reference's host-side
// asset pipeline — its OBJ loader (reference Mesh.cpp:6-37, line-by-line
// sscanf) and its stb_image HDR decode (RefractionDemo.cpp:108-140,
// stbi_loadf) — reimplemented from scratch with the exact semantics the
// Python definitions in refraction/io/{objmesh,hdr}.py specify; the two
// implementations are cross-checked in tests/test_native.py.
//
// Exposed via a C ABI consumed with ctypes (refraction/io/native.py):
//   rrt_parse_obj(path, *n_tris) -> float[T][24]  (9 pos, 9 norm, 6 uv)
//   rrt_load_hdr(path, *h, *w)   -> float[H][W][3]
//   rrt_free(ptr)
//
// Build: make -C native      (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

#include <zlib.h>  // PNG IDAT inflate (system zlib, linked with -lz)

namespace {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };
struct V2 { float u, v; };

// Parse one "a/b/c" face-corner token into 1-based indices; returns false
// unless all three fields are present and integral (matches the reference's
// sscanf("%d/%d/%d") == 9 rule and io/objmesh.py::_parse_face_token).
bool parse_corner(const char* tok, long* vi, long* ti, long* ni) {
  char* end = nullptr;
  long a = strtol(tok, &end, 10);
  if (end == tok || *end != '/') return false;
  const char* p = end + 1;
  long b = strtol(p, &end, 10);
  if (end == p || *end != '/') return false;
  p = end + 1;
  long c = strtol(p, &end, 10);
  if (end == p || *end != '\0') return false;
  *vi = a; *ti = b; *ni = c;
  return true;
}

// One float token under the shared numeric-token contract
// (io/objmesh.py::_parse_float_token): full consumption like a sscanf
// "%f" whose next directive must match, and strtof-only literal
// extensions Python's float() rejects (hex floats, NaN payloads) are
// rejected so the two implementations accept identical tokens.
bool parse_float_token(const char* tok, float* dst) {
  const char* p = tok;
  while (*p == '\v' || *p == '\f') p++;   // strtof skips C whitespace
  const char* q = (*p == '+' || *p == '-') ? p + 1 : p;
  if (q[0] == '0' && (q[1] == 'x' || q[1] == 'X')) return false;
  if (strchr(p, '(')) return false;       // strtof's nan(...) form
  char* end = nullptr;
  *dst = strtof(tok, &end);
  return end != tok && *end == '\0';
}

float* parse_obj_impl(const char* path, long long* n_tris) {
  *n_tris = 0;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data((size_t)sz, '\0');
  if (sz > 0 && fread(&data[0], 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<V3> locs, norms;
  std::vector<V2> uvs;
  std::vector<float> out;  // 24 floats per triangle

  // Lines split on '\n' only, no length limit (the reference's
  // std::getline is unbounded, Mesh.cpp:13); strtok stops at an
  // embedded NUL, which the Python twin mirrors by truncating there.
  std::string linebuf;
  std::vector<char*> toks;
  size_t ls = 0;
  while (ls <= data.size()) {
    size_t le = data.find('\n', ls);
    if (le == std::string::npos) le = data.size();
    linebuf.assign(data, ls, le - ls);
    ls = le + 1;
    toks.clear();
    for (char* t = strtok(&linebuf[0], " \t\r\n"); t;
         t = strtok(nullptr, " \t\r\n"))
      toks.push_back(t);
    if (le == data.size() && toks.empty()) break;
    if (toks.empty()) continue;
    const char* tag = toks[0];

    auto parse_floats = [&](size_t need, float* dst) -> bool {
      if (toks.size() < need + 1) return false;
      for (size_t i = 0; i < need; i++)
        if (!parse_float_token(toks[i + 1], &dst[i])) return false;
      return true;
    };

    if (!strcmp(tag, "v")) {
      float p[3];
      if (parse_floats(3, p)) locs.push_back({p[0], p[1], p[2]});
    } else if (!strcmp(tag, "vt")) {
      float p[2];
      if (parse_floats(2, p)) uvs.push_back({p[0], p[1]});
    } else if (!strcmp(tag, "vn")) {
      float p[3];
      if (parse_floats(3, p)) norms.push_back({p[0], p[1], p[2]});
    } else if (!strcmp(tag, "f") && toks.size() >= 4) {
      // First three corners only (sscanf stops after 9 ints -> quads
      // import as their first triangle; reference Mesh.cpp:21-33).
      long vi[3], ti[3], ni[3];
      bool ok = true;
      for (int i = 0; i < 3 && ok; i++)
        ok = parse_corner(toks[1 + i], &vi[i], &ti[i], &ni[i]);
      for (int i = 0; i < 3 && ok; i++)
        ok = vi[i] >= 1 && (size_t)vi[i] <= locs.size() &&
             ti[i] >= 1 && (size_t)ti[i] <= uvs.size() &&
             ni[i] >= 1 && (size_t)ni[i] <= norms.size();
      if (!ok) continue;
      size_t base = out.size();
      out.resize(base + 24);
      float* tri = out.data() + base;
      for (int i = 0; i < 3; i++) {
        const V3& p = locs[vi[i] - 1];
        tri[3 * i + 0] = p.x; tri[3 * i + 1] = p.y; tri[3 * i + 2] = p.z;
        const V3& n = norms[ni[i] - 1];
        tri[9 + 3 * i + 0] = n.x; tri[9 + 3 * i + 1] = n.y; tri[9 + 3 * i + 2] = n.z;
        const V2& t = uvs[ti[i] - 1];
        tri[18 + 2 * i + 0] = t.u; tri[18 + 2 * i + 1] = t.v;
      }
    }
  }

  *n_tris = (long long)(out.size() / 24);
  if (out.empty()) {
    // Distinguish "no triangles" (valid) from failure: return a 1-byte
    // allocation the caller frees; n_tris == 0 signals emptiness.
    return (float*)malloc(1);
  }
  float* buf = (float*)malloc(out.size() * sizeof(float));
  memcpy(buf, out.data(), out.size() * sizeof(float));
  return buf;
}

// ---------------------------------------------------------------------------
// Radiance RGBE decode (semantics of io/hdr.py::decode_hdr_bytes /
// stb_image's stbi__hdr_convert: rgb = m * 2^(e-136), e==0 -> black)
// ---------------------------------------------------------------------------

inline void rgbe_to_rgb(const uint8_t px[4], float* dst) {
  if (px[3] == 0) { dst[0] = dst[1] = dst[2] = 0.f; return; }
  float scale = ldexpf(1.0f, (int)px[3] - 136);
  dst[0] = px[0] * scale;
  dst[1] = px[1] * scale;
  dst[2] = px[2] * scale;
}

float* load_hdr_impl(const char* path, long long* hh, long long* ww) {
  *hh = *ww = 0;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data((size_t)sz, '\0');
  if (fread(&data[0], 1, (size_t)sz, f) != (size_t)sz) { fclose(f); return nullptr; }
  fclose(f);

  if (data.rfind("#?RADIANCE", 0) != 0 && data.rfind("#?RGBE", 0) != 0)
    return nullptr;

  // Header: lines to the first empty line, then the resolution line.
  size_t pos = 0;
  while (true) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) return nullptr;
    std::string hline = data.substr(pos, eol - pos);
    pos = eol + 1;
    if (hline.empty() || hline == "\r") break;
  }
  size_t eol = data.find('\n', pos);
  if (eol == std::string::npos) return nullptr;
  std::string res = data.substr(pos, eol - pos);
  pos = eol + 1;
  int h = 0, w = 0;
  // Dimension cap shared with io/hdr.py: rejects hostile headers whose
  // h*w*12-byte allocation would otherwise overflow size_t arithmetic.
  if (sscanf(res.c_str(), "-Y %d +X %d", &h, &w) != 2 || h <= 0 || w <= 0 ||
      (long long)h * w > (1LL << 28))
    return nullptr;

  const uint8_t* raw = (const uint8_t*)data.data();
  size_t n = data.size();
  float* out = (float*)malloc((size_t)h * w * 3 * sizeof(float));
  if (!out) return nullptr;
  std::vector<uint8_t> scan((size_t)w * 4);

  int y = 0;
  while (y < h) {
    if (pos + 4 > n) { free(out); return nullptr; }
    uint8_t b0 = raw[pos], b1 = raw[pos + 1], b2 = raw[pos + 2], b3 = raw[pos + 3];
    int marker_w = (b2 << 8) | b3;
    if (b0 == 2 && b1 == 2 && marker_w == w && w >= 8 && w < 32768) {
      pos += 4;  // new-style RLE, 4 component planes
      for (int c = 0; c < 4; c++) {
        int x = 0;
        while (x < w) {
          if (pos >= n) { free(out); return nullptr; }
          int count = raw[pos];
          if (count > 128) {  // run
            if (pos + 1 >= n) { free(out); return nullptr; }
            uint8_t val = raw[pos + 1];
            count -= 128;
            if (x + count > w) { free(out); return nullptr; }
            for (int i = 0; i < count; i++) scan[(size_t)(x + i) * 4 + c] = val;
            pos += 2;
          } else {            // literals
            if (pos + 1 + (size_t)count > n || x + count > w) { free(out); return nullptr; }
            for (int i = 0; i < count; i++)
              scan[(size_t)(x + i) * 4 + c] = raw[pos + 1 + i];
            pos += 1 + count;
          }
          x += count;
        }
      }
      for (int x = 0; x < w; x++)
        rgbe_to_rgb(&scan[(size_t)x * 4], out + ((size_t)y * w + x) * 3);
      y++;
    } else {
      // Flat / old-style RLE with (1,1,1,shift) repeat codes.
      uint8_t prev[4] = {0, 0, 0, 0};
      int shift = 0;
      for (; y < h; y++) {
        for (int x = 0; x < w;) {
          if (pos + 4 > n) { free(out); return nullptr; }
          const uint8_t* px = raw + pos;
          pos += 4;
          if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
            // Python-int semantics without signed-shift UB: consecutive
            // repeat codes can push shift past 31; any nonzero count at
            // such a shift necessarily exceeds the scanline.
            long long cnt = (long long)px[3] << (shift > 40 ? 40 : shift);
            if (x + cnt > w) { free(out); return nullptr; }
            for (int i = 0; i < cnt; i++)
              rgbe_to_rgb(prev, out + ((size_t)y * w + x + i) * 3);
            x += cnt;
            shift += 8;
          } else {
            memcpy(prev, px, 4);
            rgbe_to_rgb(prev, out + ((size_t)y * w + x) * 3);
            x++;
            shift = 0;
          }
        }
      }
      break;
    }
  }
  *hh = h;
  *ww = w;
  return out;
}

// ---------------------------------------------------------------------------
// PNG decoding (the other half of the stb_image capability,
// RefractionDemo.cpp:111 via io/texture.py's hdr->png fallback).
//
// Supported subset — exactly the cases the pure-Python decoder
// (io/png.py::decode_png_bytes) handles minus sub-byte depths: 8/16-bit,
// color types 0/2/3/4/6, scanline filters 0-4, palette + tRNS,
// non-interlaced. Anything else returns nullptr and the Python
// implementation takes over; supported inputs decode bit-identically
// (tests/test_native.py).
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

uint8_t* load_png_impl(const char* path, long long* hh, long long* ww,
                       long long* cc, long long* dd) {
  *hh = *ww = *cc = *dd = 0;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)sz);
  if (sz <= 0 || fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  static const uint8_t SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (data.size() < 8 || memcmp(data.data(), SIG, 8) != 0) return nullptr;

  size_t pos = 8, n = data.size();
  bool have_ihdr = false, saw_iend = false;
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0;
  std::vector<uint8_t> idat, plte, trns;
  while (pos + 8 <= n) {
    uint32_t length = be32(&data[pos]);
    const uint8_t* ctype = &data[pos + 4];
    if (pos + 12 + (size_t)length > n) return nullptr;  // truncated chunk
    const uint8_t* chunk = &data[pos + 8];
    pos += 12 + length;
    if (!memcmp(ctype, "IHDR", 4)) {
      if (length != 13) return nullptr;
      w = be32(chunk);
      h = be32(chunk + 4);
      depth = chunk[8];
      color = chunk[9];
      int comp = chunk[10], filt = chunk[11], interlace = chunk[12];
      if (comp != 0 || filt != 0 || interlace != 0) return nullptr;
      have_ihdr = true;
    } else if (!memcmp(ctype, "PLTE", 4)) {
      plte.assign(chunk, chunk + length);
    } else if (!memcmp(ctype, "tRNS", 4)) {
      trns.assign(chunk, chunk + length);
    } else if (!memcmp(ctype, "IDAT", 4)) {
      idat.insert(idat.end(), chunk, chunk + length);
    } else if (!memcmp(ctype, "IEND", 4)) {
      saw_iend = true;
      break;
    }
  }
  // A trailing partial chunk header is an error in the Python decoder
  // ("truncated PNG chunk header") unless IEND already ended the stream.
  if (!saw_iend && pos != n) return nullptr;
  if (!have_ihdr || w == 0 || h == 0 || (long long)w * h > (1LL << 28))
    return nullptr;
  if (depth != 8 && depth != 16) return nullptr;  // sub-byte -> Python
  int nch;
  switch (color) {
    case 0: nch = 1; break;
    case 2: nch = 3; break;
    case 3: nch = 1; break;
    case 4: nch = 2; break;
    case 6: nch = 4; break;
    default: return nullptr;
  }
  if (color == 3 && depth != 8) return nullptr;  // palette is 8-bit here

  size_t bytes_pp = (size_t)depth * nch / 8;
  size_t stride = (size_t)w * bytes_pp;
  size_t need = (size_t)h * (stride + 1);

  std::vector<uint8_t> raw(need);
  {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return nullptr;
    zs.next_in = idat.data();
    zs.avail_in = (uInt)idat.size();
    zs.next_out = raw.data();
    zs.avail_out = (uInt)need;
    int rc = inflate(&zs, Z_FINISH);
    bool ok = (zs.total_out == need) &&
              (rc == Z_STREAM_END || rc == Z_OK || rc == Z_BUF_ERROR);
    inflateEnd(&zs);
    if (!ok) return nullptr;  // short data -> corrupt (Python raises too)
  }

  // Undo scanline filters in place into `img` rows.
  std::vector<uint8_t> cur(stride), prev(stride, 0);
  std::vector<uint8_t> pixels((size_t)h * stride);
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = &raw[(size_t)y * (stride + 1)];
    int ftype = src[0];
    memcpy(cur.data(), src + 1, stride);
    switch (ftype) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bytes_pp; i < stride; i++)
          cur[i] = (uint8_t)(cur[i] + cur[i - bytes_pp]);
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; i++) {
          int a = i >= bytes_pp ? cur[i - bytes_pp] : 0;
          cur[i] = (uint8_t)(cur[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; i++) {
          int a = i >= bytes_pp ? cur[i - bytes_pp] : 0;
          int b = prev[i];
          int c = i >= bytes_pp ? prev[i - bytes_pp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(cur[i] + pred);
        }
        break;
      default:
        return nullptr;  // bad filter type
    }
    memcpy(&pixels[(size_t)y * stride], cur.data(), stride);
    prev = cur;
  }

  if (color == 3) {
    // Palette expansion (+ optional tRNS alpha, indexed by palette index).
    if (plte.size() < 3) return nullptr;
    size_t pal_n = plte.size() / 3;
    bool alpha = !trns.empty();
    int out_c = alpha ? 4 : 3;
    uint8_t* out = (uint8_t*)malloc((size_t)h * w * out_c);
    if (!out) return nullptr;
    for (size_t i = 0; i < (size_t)h * w; i++) {
      uint8_t idx = pixels[i];
      // OOB palette index -> corrupt (the Python decoder's fancy-index
      // raises); nullptr routes the file to Python for the error.
      if (idx >= pal_n) { free(out); return nullptr; }
      out[i * out_c + 0] = plte[(size_t)idx * 3 + 0];
      out[i * out_c + 1] = plte[(size_t)idx * 3 + 1];
      out[i * out_c + 2] = plte[(size_t)idx * 3 + 2];
      if (alpha)
        out[i * out_c + 3] = idx < trns.size() ? trns[idx] : 255;
    }
    *hh = h; *ww = w; *cc = out_c; *dd = 8;
    return out;
  }

  if (depth == 16) {
    // Big-endian pairs -> host uint16.
    uint16_t* out = (uint16_t*)malloc((size_t)h * w * nch * 2);
    if (!out) return nullptr;
    for (size_t i = 0; i < (size_t)h * w * nch; i++)
      out[i] = (uint16_t)((pixels[i * 2] << 8) | pixels[i * 2 + 1]);
    *hh = h; *ww = w; *cc = nch; *dd = 16;
    return (uint8_t*)out;
  }

  uint8_t* out = (uint8_t*)malloc(pixels.size());
  if (!out) return nullptr;
  memcpy(out, pixels.data(), pixels.size());
  *hh = h; *ww = w; *cc = nch; *dd = 8;
  return out;
}

}  // namespace

extern "C" {

float* rrt_parse_obj(const char* path, long long* n_tris) {
  return parse_obj_impl(path, n_tris);
}

float* rrt_load_hdr(const char* path, long long* h, long long* w) {
  return load_hdr_impl(path, h, w);
}

// Decoded pixels: (h, w, c) of uint8 (depth 8) or host-order uint16
// (depth 16). nullptr = unsupported-or-corrupt; caller falls back to the
// Python decoder.
uint8_t* rrt_load_png(const char* path, long long* h, long long* w,
                      long long* c, long long* depth) {
  return load_png_impl(path, h, w, c, depth);
}

void rrt_free(void* p) { free(p); }

}  // extern "C"
