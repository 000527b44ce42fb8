// gsv_native: the native host data path of the PyTorch port, a copy of the
// JAX package's native/gsv_native.cpp with one change (below).
//
// The reference delegates its heavy I/O to native code indirectly (plyfile's
// C-accelerated numpy paths, PIL/libpng, cv2).  This library is the
// framework's own native runtime for the host-side data path:
//   * single-pass INRIA-PLY ingestion: parse + channel-major -> coeff-major
//     SH transpose (ref util_gau.py:99-100), straight from the file into
//     caller-provided buffers.  The change: scale, opacity and rotation are
//     written as stored (raw) and the caller applies the activations
//     (exp/sigmoid/quat-normalize, ref util_gau.py:114-121) with the same
//     numpy code as its numpy loader, so the two loads are bit-equal (the
//     C library's expf and a reciprocal-multiply normalize differ from
//     numpy's float32 exp and divide in the last bit);
//   * zlib PNG encoding for 8-bit RGB and 16-bit grayscale frames — the
//     hot path of the 270-scene x 100-pose stereo dataset generator.
//
// This is host I/O, not a device kernel.  C ABI only (loaded with ctypes).
// Thread-safe: no global state.
//
// Build: see native/__init__.py (g++ -O3 -shared -fPIC gsv_native.cpp -lz).

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PLY loading
// ---------------------------------------------------------------------------

// Property descriptor filled by gsv_ply_inspect.
struct GsvPlyInfo {
  int64_t n_vertices;
  int32_t n_props;       // total float properties per vertex
  int32_t sh_rest;       // number of f_rest_* properties
  int64_t header_bytes;  // offset of binary payload
};

// Parse the header of a binary_little_endian PLY with float-only vertex
// properties.  Returns 0 on success, negative error codes otherwise.
// prop_names_out: caller buffer of size max_props*64 receiving
// NUL-terminated property names in file order.
int gsv_ply_inspect(const char* path, GsvPlyInfo* info, char* prop_names_out,
                    int32_t max_props) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3)) {
    std::fclose(f);
    return -2;
  }
  info->n_vertices = 0;
  info->n_props = 0;
  info->sh_rest = 0;
  bool little = false;
  bool in_vertex = false;
  while (std::fgets(line, sizeof line, f)) {
    if (!std::strncmp(line, "format binary_little_endian", 27)) {
      little = true;
    } else if (!std::strncmp(line, "element vertex", 14)) {
      info->n_vertices = std::strtoll(line + 14, nullptr, 10);
      in_vertex = true;
    } else if (!std::strncmp(line, "element", 7)) {
      in_vertex = false;  // later elements are ignored (read stops early)
    } else if (in_vertex && !std::strncmp(line, "property", 8)) {
      char type[32], name[64];
      if (std::sscanf(line + 8, "%31s %63s", type, name) != 2 ||
          (std::strcmp(type, "float") && std::strcmp(type, "float32"))) {
        std::fclose(f);
        return -3;  // non-float property: fall back to python loader
      }
      if (info->n_props >= max_props) {
        std::fclose(f);
        return -4;
      }
      std::snprintf(prop_names_out + 64 * info->n_props, 64, "%s", name);
      if (!std::strncmp(name, "f_rest_", 7)) info->sh_rest++;
      info->n_props++;
    } else if (!std::strncmp(line, "end_header", 10)) {
      info->header_bytes = std::ftell(f);
      std::fclose(f);
      return little ? 0 : -5;
    }
  }
  std::fclose(f);
  return -6;
}

// Load.  Column indices are discovered by the Python wrapper from the
// inspected names and passed in, so any property order works.  rot, scale
// and opacity are the stored (pre-activation) values.
// sh layout out: [dc.rgb, rest_0.rgb, ...] per splat (coeff-major).
// Returns 0 on success.
int gsv_ply_load(const char* path, int64_t header_bytes, int64_t n,
                 int32_t n_props, const int32_t* col_xyz,  // 3 indices
                 const int32_t* col_dc,                    // 3
                 const int32_t* col_rest,  // sh_rest indices (channel-major)
                 int32_t sh_rest,
                 const int32_t* col_scale,  // n_scale: 3, or 2 (2DGS)
                 int32_t n_scale,
                 const int32_t* col_rot,                     // 4
                 int32_t col_opacity, float* xyz, float* rot, float* scale,
                 float* opacity, float* sh) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, (long)header_bytes, SEEK_SET)) {
    std::fclose(f);
    return -2;
  }
  const int n_coeff = sh_rest / 3;   // per-channel higher-order coeffs
  const int sh_dim = 3 + sh_rest;    // interleaved per-coeff RGB floats
  std::vector<float> row(n_props);
  const size_t row_bytes = sizeof(float) * n_props;

  // buffered row-batch reads
  const int64_t BATCH = 8192;
  std::vector<float> buf(BATCH * n_props);
  for (int64_t base = 0; base < n; base += BATCH) {
    const int64_t m = (n - base < BATCH) ? n - base : BATCH;
    if (std::fread(buf.data(), row_bytes, (size_t)m, f) != (size_t)m) {
      std::fclose(f);
      return -3;
    }
    for (int64_t j = 0; j < m; ++j) {
      const float* r = buf.data() + j * n_props;
      const int64_t i = base + j;
      for (int k = 0; k < 3; ++k) xyz[i * 3 + k] = r[col_xyz[k]];
      // raw quaternion, log-scale and logit opacity (activated by the
      // caller, util_gau.py:114-121)
      for (int k = 0; k < 4; ++k) rot[i * 4 + k] = r[col_rot[k]];
      for (int k = 0; k < n_scale; ++k)
        scale[i * n_scale + k] = r[col_scale[k]];
      opacity[i] = r[col_opacity];
      // SH: dc first, then channel-major f_rest transposed to coeff-major
      float* s = sh + i * sh_dim;
      for (int c = 0; c < 3; ++c) s[c] = r[col_dc[c]];
      for (int k = 0; k < n_coeff; ++k)
        for (int c = 0; c < 3; ++c)
          s[3 + k * 3 + c] = r[col_rest[c * n_coeff + k]];
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encoding
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char* tag,
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + tag_pos, (uInt)(len + 4));
  put_be32(out, crc);
}

// raw: filtered scanline payload already assembled (filter byte + data rows)
static int write_png(const char* path, int w, int h, int bit_depth,
                     int color_type, const std::vector<uint8_t>& raw,
                     int level) {
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), (uLong)raw.size(), level) !=
      Z_OK)
    return -2;
  z.resize(bound);

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff;
  ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;
  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff;
  ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;
  ihdr[7] = h & 0xff;
  ihdr[8] = (uint8_t)bit_depth;
  ihdr[9] = (uint8_t)color_type;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", z.data(), z.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t nw = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return nw == out.size() ? 0 : -3;
}

// 8-bit RGB, row-major HxWx3.
int gsv_write_png_rgb8(const char* path, int32_t w, int32_t h,
                       const uint8_t* data, int32_t level) {
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    *dst++ = 0;  // filter: none
    std::memcpy(dst, data + (size_t)y * w * 3, (size_t)w * 3);
  }
  return write_png(path, w, h, 8, 2, raw, level);
}

// 16-bit grayscale, row-major HxW host-endian uint16 (byteswapped to the
// PNG's big-endian on the fly).
int gsv_write_png_gray16(const char* path, int32_t w, int32_t h,
                         const uint16_t* data, int32_t level) {
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 2));
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = raw.data() + (size_t)y * (1 + (size_t)w * 2);
    *dst++ = 0;
    const uint16_t* src = data + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      dst[2 * x] = (uint8_t)(src[x] >> 8);
      dst[2 * x + 1] = (uint8_t)(src[x] & 0xff);
    }
  }
  return write_png(path, w, h, 16, 0, raw, level);
}

}  // extern "C"
