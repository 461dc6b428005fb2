// Native IO runtime of d3roma_tpu_torch (a copy of native/d3roma_io.cpp).
//
// Threaded OpenEXR scanline decode (FLOAT/HALF, NONE/ZIPS/ZIP via zlib) and
// batched parallel loading for the data-loader hot path, exposed to Python
// over a C ABI (ctypes; d3roma_tpu_torch/utils/native_io.py). Mirrors the
// file subset documented in d3roma_tpu_torch/utils/exr.py. Host code: built
// by g++, never by nvcc.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared d3roma_io.cpp -o libd3roma_io.so -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x01312F76;
constexpr int kNoCompression = 0;
constexpr int kZipsCompression = 2;
constexpr int kZipCompression = 3;
constexpr int kPixelHalf = 1;
constexpr int kPixelFloat = 2;

struct Channel {
  std::string name;
  int pixel_type;
};

struct ExrHeader {
  int width = 0;
  int height = 0;
  int compression = kNoCompression;
  std::vector<Channel> channels;
  long data_offset = 0;  // file position after the header
  std::string error;
};

float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {
      // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FF;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

bool read_cstr(FILE* f, std::string* out) {
  out->clear();
  int c;
  while ((c = std::fgetc(f)) != EOF) {
    if (c == 0) return true;
    out->push_back(static_cast<char>(c));
    if (out->size() > 255) return false;
  }
  return false;
}

bool parse_header(FILE* f, ExrHeader* hdr) {
  uint32_t magic = 0, version = 0;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != kMagic) {
    hdr->error = "bad magic";
    return false;
  }
  if (std::fread(&version, 4, 1, f) != 1) {
    hdr->error = "truncated version";
    return false;
  }
  // OpenEXR 2.0 version flags: 0x200 single-part tiled, 0x800 deep
  // data, 0x1000 multi-part — all three change the chunk layout this
  // scanline reader assumes; misparsing a deep/multipart chunk table as
  // scanline offsets can return SUCCESS with garbage pixels, so reject
  // loudly (the Python caller falls back to cv2).
  if (version & (0x200u | 0x800u | 0x1000u)) {
    hdr->error = "tiled/deep/multi-part unsupported";
    return false;
  }
  while (true) {
    std::string name;
    if (!read_cstr(f, &name)) {
      hdr->error = "truncated header";
      return false;
    }
    if (name.empty()) break;  // end of header
    std::string type_name;
    if (!read_cstr(f, &type_name)) return false;
    int32_t size = 0;
    if (std::fread(&size, 4, 1, f) != 1 || size < 0) return false;
    std::vector<uint8_t> data(size);
    if (size && std::fread(data.data(), 1, size, f) != size_t(size)) return false;

    if (name == "channels") {
      // chlist: [name\0 int32 pixel_type 12 bytes misc]* \0 — every field
      // is file-controlled, so bounds-check before each read.
      size_t i = 0;
      while (i < data.size() && data[i] != 0) {
        size_t j = i;
        while (j < data.size() && data[j] != 0) j++;
        if (j + 1 + 16 > data.size()) {
          hdr->error = "truncated chlist entry";
          return false;
        }
        Channel ch;
        ch.name.assign(reinterpret_cast<char*>(&data[i]), j - i);
        int32_t ptype;
        std::memcpy(&ptype, &data[j + 1], 4);
        if (ptype != kPixelHalf && ptype != kPixelFloat) {
          hdr->error = "unsupported pixel type";
          return false;
        }
        ch.pixel_type = ptype;
        hdr->channels.push_back(ch);
        if (hdr->channels.size() > 64) {
          hdr->error = "too many channels";
          return false;
        }
        i = j + 1 + 16;
      }
    } else if (name == "compression") {
      hdr->compression = data.empty() ? kNoCompression : data[0];
    } else if (name == "dataWindow") {
      if (data.size() < 16) {
        hdr->error = "bad dataWindow";
        return false;
      }
      int32_t box[4];
      std::memcpy(box, data.data(), 16);
      int64_t w = int64_t(box[2]) - box[0] + 1;
      int64_t h = int64_t(box[3]) - box[1] + 1;
      // sanity: positive and small enough that h*w*c cannot overflow int
      if (w <= 0 || h <= 0 || w > (1 << 20) || h > (1 << 20) ||
          w * h > (int64_t(1) << 28)) {
        hdr->error = "unreasonable dataWindow";
        return false;
      }
      hdr->width = static_cast<int>(w);
      hdr->height = static_cast<int>(h);
    }
  }
  hdr->data_offset = std::ftell(f);
  return true;
}

// EXR zip post-filter: zlib inflate, then byte delta + deinterleave.
bool unzip_block(const uint8_t* src, size_t src_len, std::vector<uint8_t>* out,
                 size_t expect) {
  out->resize(expect);
  uLongf dst_len = expect;
  std::vector<uint8_t> tmp(expect);
  if (uncompress(tmp.data(), &dst_len, src, src_len) != Z_OK) return false;
  // the decode loop walks exactly `expect` bytes; a short inflate would be
  // an out-of-bounds read downstream
  if (dst_len != expect) return false;
  for (size_t i = 1; i < dst_len; i++) {
    tmp[i] = static_cast<uint8_t>(tmp[i] + tmp[i - 1] - 128);
  }
  size_t half = (dst_len + 1) / 2;
  for (size_t i = 0; i < dst_len; i++) {
    (*out)[i] = (i % 2 == 0) ? tmp[i / 2] : tmp[half + i / 2];
  }
  return true;
}

int decode_exr(const char* path, float* out, int out_capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  ExrHeader hdr;
  if (!parse_header(f, &hdr) || hdr.channels.empty()) {
    std::fclose(f);
    return -2;
  }
  const int W = hdr.width, H = hdr.height;
  const int C = static_cast<int>(hdr.channels.size());
  // 64-bit product: H*W is bounded to 2^28 by parse_header but C up to
  // 64 pushes H*W*C to 2^34 — an int product would wrap and bypass the
  // capacity check (out-of-bounds writes on a crafted header)
  const int64_t total = int64_t(H) * W * C;
  if (total > int64_t(out_capacity)) {
    std::fclose(f);
    return -3;
  }
  int lines_per_block = (hdr.compression == kZipCompression) ? 16 : 1;
  if (hdr.compression != kNoCompression &&
      hdr.compression != kZipsCompression &&
      hdr.compression != kZipCompression) {
    std::fclose(f);
    return -4;  // unsupported compression
  }
  int n_blocks = (H + lines_per_block - 1) / lines_per_block;
  std::fseek(f, hdr.data_offset + 8L * n_blocks, SEEK_SET);

  size_t bytes_per_px = 0;
  for (auto& ch : hdr.channels)
    bytes_per_px += (ch.pixel_type == kPixelFloat) ? 4 : 2;

  std::vector<uint8_t> raw, plain;
  const size_t max_block = bytes_per_px * size_t(W) * lines_per_block;
  for (int b = 0; b < n_blocks; b++) {
    int32_t y = 0, size = 0;
    if (std::fread(&y, 4, 1, f) != 1 || std::fread(&size, 4, 1, f) != 1) {
      std::fclose(f);
      return -5;
    }
    // y and size are file-controlled: y indexes the output buffer and size
    // the read — reject anything outside the header-implied bounds
    // (compressed blocks can exceed raw size slightly for incompressible
    // data; allow zlib's worst-case expansion).
    if (y < 0 || y >= H ||
        size <= 0 || size_t(size) > max_block + max_block / 64 + 256) {
      std::fclose(f);
      return -7;
    }
    raw.resize(size);
    if (std::fread(raw.data(), 1, size, f) != size_t(size)) {
      std::fclose(f);
      return -5;
    }
    int n_lines = std::min(lines_per_block, H - y);
    size_t expect = bytes_per_px * W * n_lines;
    const uint8_t* data = raw.data();
    if (size_t(size) != expect) {
      if (hdr.compression == kNoCompression) {
        // NONE blocks must be exactly the scanline payload
        std::fclose(f);
        return -7;
      }
      if (!unzip_block(raw.data(), size, &plain, expect)) {
        std::fclose(f);
        return -6;
      }
      data = plain.data();
    }
    size_t pos = 0;
    for (int line = 0; line < n_lines; line++) {
      for (int ci = 0; ci < C; ci++) {
        float* dst = out + (size_t(y + line) * W * C) + ci;
        if (hdr.channels[ci].pixel_type == kPixelFloat) {
          const float* src = reinterpret_cast<const float*>(data + pos);
          for (int x = 0; x < W; x++) dst[size_t(x) * C] = src[x];
          pos += 4 * W;
        } else {
          const uint16_t* src = reinterpret_cast<const uint16_t*>(data + pos);
          for (int x = 0; x < W; x++) dst[size_t(x) * C] = half_to_float(src[x]);
          pos += 2 * W;
        }
      }
    }
  }
  std::fclose(f);
  return H * W * C;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills h/w/c.
int exr_header(const char* path, int* h, int* w, int* c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  ExrHeader hdr;
  bool ok = parse_header(f, &hdr);
  std::fclose(f);
  if (!ok) return -2;
  *h = hdr.height;
  *w = hdr.width;
  *c = static_cast<int>(hdr.channels.size());
  return 0;
}

// Channel names in storage order, ';'-joined into `buf` (cap bytes incl.
// the terminator). The Python wrapper needs them to reorder B,G,R storage
// into RGB exactly like the pure-Python twin (utils/exr.py) — without
// this the two decoders returned different channel orders per host.
int exr_channel_names(const char* path, char* buf, int cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  ExrHeader hdr;
  bool ok = parse_header(f, &hdr);
  std::fclose(f);
  if (!ok) return -2;
  std::string joined;
  for (size_t i = 0; i < hdr.channels.size(); i++) {
    if (i) joined += ';';
    joined += hdr.channels[i].name;
  }
  if (int(joined.size()) + 1 > cap) return -3;
  std::memcpy(buf, joined.c_str(), joined.size() + 1);
  return 0;
}

// Decode into caller-allocated out (capacity floats). Returns element count
// written, or negative error.
int exr_read(const char* path, float* out, int capacity) {
  return decode_exr(path, out, capacity);
}

// Batched parallel decode: n files of identical h*w*c into one contiguous
// buffer; per-file status codes in status[n]. Worker-thread count clamps to
// hardware concurrency.
void exr_read_batch(const char** paths, int n, float* out, int per_file,
                    int* status, int num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads > n) num_threads = n;
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> next(1, 0);
  std::mutex* m = new std::mutex();
  for (int t = 0; t < num_threads; t++) {
    workers.emplace_back([&, t]() {
      while (true) {
        int i;
        {
          std::lock_guard<std::mutex> lock(*m);
          if (next[0] >= n) return;
          i = next[0]++;
        }
        status[i] = decode_exr(paths[i], out + size_t(i) * per_file, per_file);
      }
    });
  }
  for (auto& w : workers) w.join();
  delete m;
}

// Simple float32 single-channel NONE-compression writer.
int exr_write(const char* path, const float* data, int h, int w) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t magic = kMagic, version = 2;
  std::fwrite(&magic, 4, 1, f);
  std::fwrite(&version, 4, 1, f);
  auto attr = [&](const char* name, const char* type,
                  const void* data_, int32_t size) {
    std::fwrite(name, 1, std::strlen(name) + 1, f);
    std::fwrite(type, 1, std::strlen(type) + 1, f);
    std::fwrite(&size, 4, 1, f);
    std::fwrite(data_, 1, size, f);
  };
  uint8_t chan[2 + 16 + 1] = {0};
  chan[0] = 'Y';
  chan[1] = 0;
  int32_t ptype = kPixelFloat, zero = 0, one = 1;
  std::memcpy(chan + 2, &ptype, 4);
  std::memcpy(chan + 6, &zero, 4);
  std::memcpy(chan + 10, &one, 4);
  std::memcpy(chan + 14, &one, 4);
  attr("channels", "chlist", chan, sizeof(chan));
  uint8_t comp = kNoCompression;
  attr("compression", "compression", &comp, 1);
  int32_t box[4] = {0, 0, w - 1, h - 1};
  attr("dataWindow", "box2i", box, 16);
  attr("displayWindow", "box2i", box, 16);
  uint8_t lo = 0;
  attr("lineOrder", "lineOrder", &lo, 1);
  float par = 1.0f;
  attr("pixelAspectRatio", "float", &par, 4);
  float swc[2] = {0, 0};
  attr("screenWindowCenter", "v2f", swc, 8);
  attr("screenWindowWidth", "float", &par, 4);
  std::fputc(0, f);

  long table_pos = std::ftell(f);
  if (table_pos < 0) { std::fclose(f); return -2; }
  std::vector<uint64_t> offsets(h, 0);
  bool ok = std::fwrite(offsets.data(), 8, h, f) == size_t(h);
  for (int y = 0; ok && y < h; y++) {
    long pos = std::ftell(f);
    if (pos < 0) { ok = false; break; }
    offsets[y] = uint64_t(pos);
    int32_t yy = y, size = w * 4;
    ok = std::fwrite(&yy, 4, 1, f) == 1 &&
         std::fwrite(&size, 4, 1, f) == 1 &&
         std::fwrite(data + size_t(y) * w, 4, w, f) == size_t(w);
  }
  // a disk-full/quota failure must not report success: the pipeline
  // would claim the depth map saved while the file is truncated
  ok = ok && std::fseek(f, table_pos, SEEK_SET) == 0 &&
       std::fwrite(offsets.data(), 8, h, f) == size_t(h);
  if (std::fclose(f) != 0) ok = false;
  return ok ? 0 : -2;
}

}  // extern "C"
