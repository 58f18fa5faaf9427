// Native EuRoC frame loader: grayscale PNG decode + prefetch ring.
//
// The reference's data path is C++ ROS image subscribers feeding the
// tracking thread (Examples/ROS/MAM3SLAM/nodes/ros_mono_multi.cc:93-122 —
// SURVEY.md §2.7).  This is this build's native equivalent for dataset
// replay: a background thread decodes 8-bit grayscale PNGs (EuRoC format)
// ahead of the consumer into a bounded ring, so image decode overlaps
// device compute.  Decode is zlib inflate + PNG row-filter reversal —
// no OpenCV dependency on the hot path.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 loader.cc -lz -lpthread -o libloader.so

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;  // grayscale 8-bit
  bool ok = false;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit PNG to grayscale (gray or RGB(A)->luma; non-interlaced).
Image decode_png(const std::string& path) {
  Image out;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return out;
  std::vector<uint8_t> data;
  uint8_t buf[65536];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0)
    data.insert(data.end(), buf, buf + n);
  fclose(f);
  if (data.size() < 45 || memcmp(data.data(), "\x89PNG\r\n\x1a\n", 8) != 0)
    return out;

  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    if (pos + 12 + len > data.size()) break;
    const uint8_t* type = &data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    if (!memcmp(type, "IHDR", 4) && len >= 13) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0 || bit_depth != 8 || interlace != 0)
    return out;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return out;          // palette unsupported
  }

  const size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return out;

  // reverse per-row filters in place into `img`
  std::vector<uint8_t> img(stride * height);
  const int bpp = channels;
  for (int y = 0; y < height; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &img[stride * y];
    const uint8_t* up = y > 0 ? &img[stride * (y - 1)] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return out;
      }
      dst[x] = uint8_t(v);
    }
  }

  out.width = width;
  out.height = height;
  out.pixels.resize(size_t(width) * height);
  if (channels == 1) {
    out.pixels = std::move(img);
  } else {
    for (size_t i = 0; i < out.pixels.size(); ++i) {
      const uint8_t* px = &img[i * channels];
      if (channels >= 3) {
        // ITU-R BT.601 luma, integer arithmetic
        out.pixels[i] =
            uint8_t((299 * px[0] + 587 * px[1] + 114 * px[2]) / 1000);
      } else {
        out.pixels[i] = px[0];
      }
    }
  }
  out.ok = true;
  return out;
}

struct Loader {
  std::vector<std::string> paths;
  size_t next_submit = 0;
  size_t next_read = 0;
  size_t ring_cap;
  std::vector<Image> ring;       // indexed by seq % ring_cap
  std::vector<std::atomic<int>> state;  // 0 empty, 1 ready
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_space, cv_ready;
  std::atomic<bool> stop{false};

  Loader(std::vector<std::string> p, size_t cap)
      : paths(std::move(p)), ring_cap(cap), ring(cap), state(cap) {
    for (auto& s : state) s.store(0);
    worker = std::thread([this] { run(); });
  }
  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    if (worker.joinable()) worker.join();
  }
  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || state[i % ring_cap].load() == 0;
      });
      if (stop.load()) return;
      lk.unlock();
      Image im = decode_png(paths[i]);
      ring[i % ring_cap] = std::move(im);
      state[i % ring_cap].store(1);
      cv_ready.notify_all();
    }
  }
  // Returns 1 ok, 0 decode failed, -1 end of stream.
  int next(uint8_t* dst, int64_t cap_bytes, int* w, int* h) {
    if (next_read >= paths.size()) return -1;
    size_t slot = next_read % ring_cap;
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return state[slot].load() == 1; });
    lk.unlock();
    Image& im = ring[slot];
    int rc = 0;
    if (im.ok && int64_t(im.pixels.size()) <= cap_bytes) {
      memcpy(dst, im.pixels.data(), im.pixels.size());
      *w = im.width;
      *h = im.height;
      rc = 1;
    }
    im = Image();
    state[slot].store(0);
    cv_space.notify_all();
    ++next_read;
    return rc;
  }
};

}  // namespace

extern "C" {

void* loader_open(const char** paths, int64_t n, int64_t ring_cap) {
  std::vector<std::string> p(paths, paths + n);
  return new Loader(std::move(p), size_t(ring_cap > 1 ? ring_cap : 2));
}

int loader_next(void* handle, uint8_t* dst, int64_t cap_bytes, int* w,
                int* h) {
  return static_cast<Loader*>(handle)->next(dst, cap_bytes, w, h);
}

void loader_close(void* handle) { delete static_cast<Loader*>(handle); }

// one-shot decode (no prefetch) — used by tests and random access
int decode_png_gray(const char* path, uint8_t* dst, int64_t cap_bytes,
                    int* w, int* h) {
  Image im = decode_png(path);
  if (!im.ok || int64_t(im.pixels.size()) > cap_bytes) return 0;
  memcpy(dst, im.pixels.data(), im.pixels.size());
  *w = im.width;
  *h = im.height;
  return 1;
}

}  // extern "C"
