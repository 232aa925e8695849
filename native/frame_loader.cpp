// Native async frame pipeline: threaded image decode + ordered frame queue.
//
// C++ runtime equivalent of the reference's async frame construction
// (hobot::CThreadPool + System::CreateFrameAndPush + the timestamp-ordered
// bounded mFrameQueue, /root/reference/src/ThreadPool.cpp,
// src/System.cc:307-402, include/System.h:348-357): a worker pool decodes
// and converts images ahead of the consumer while the device computes, and a
// bounded ordered queue delivers frames strictly in sequence index order.
//
// Decodes 8-bit PGM/PPM and 8/16-bit grayscale/RGB PNG (zlib inflate +
// unfilter) to float32 grayscale (+ optional depth scaling), matching
// io/datasets.py's Python decoders bit-for-bit for 8-bit data.
//
// Exposed as a plain C API for ctypes (no pybind11 in this environment).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> data;  // grayscale float32
  bool ok = false;
};

// ---------------------------------------------------------------- PNM ----
Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P') return img;
  int type = buf[1] - '0';
  if (type != 5 && type != 6) return img;
  size_t i = 2;
  int vals[3], got = 0;
  while (got < 3 && i < buf.size()) {
    while (i < buf.size() && isspace(buf[i])) i++;
    if (i < buf.size() && buf[i] == '#') {
      while (i < buf.size() && buf[i] != '\n') i++;
      continue;
    }
    int v = 0;
    while (i < buf.size() && isdigit(buf[i])) v = v * 10 + (buf[i++] - '0');
    vals[got++] = v;
  }
  i++;  // single whitespace after maxval
  int w = vals[0], h = vals[1], maxval = vals[2];
  img.w = w;
  img.h = h;
  img.data.resize((size_t)w * h);
  if (type == 5 && maxval < 256) {
    if (buf.size() - i < (size_t)w * h) return img;
    for (size_t p = 0; p < (size_t)w * h; p++) img.data[p] = buf[i + p];
  } else if (type == 5) {  // 16-bit big endian
    if (buf.size() - i < (size_t)w * h * 2) return img;
    for (size_t p = 0; p < (size_t)w * h; p++)
      img.data[p] = (float)((buf[i + 2 * p] << 8) | buf[i + 2 * p + 1]);
  } else {  // P6 RGB -> luma
    if (buf.size() - i < (size_t)w * h * 3) return img;
    for (size_t p = 0; p < (size_t)w * h; p++) {
      const uint8_t* px = &buf[i + 3 * p];
      img.data[p] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    }
  }
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------- PNG ----
uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (buf.size() < 8 || memcmp(buf.data(), magic, 8) != 0) return img;
  size_t pos = 8;
  int w = 0, h = 0, bitd = 0, color = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const uint8_t* ctype = &buf[pos + 4];
    const uint8_t* chunk = &buf[pos + 8];
    if (memcmp(ctype, "IHDR", 4) == 0) {
      w = be32(chunk);
      h = be32(chunk + 4);
      bitd = chunk[8];
      color = chunk[9];
      if (chunk[12] != 0) return img;  // interlaced unsupported
    } else if (memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), chunk, chunk + len);
    } else if (memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  int nch = color == 0 ? 1 : color == 2 ? 3 : color == 4 ? 2 : 4;
  int bpp = nch * (bitd / 8);
  size_t stride = (size_t)w * bpp;
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf rawlen = raw.size();
  if (uncompress(raw.data(), &rawlen, idat.data(), idat.size()) != Z_OK)
    return img;

  std::vector<uint8_t> out(h * stride);
  std::vector<uint8_t> prev(stride, 0);
  size_t o = 0;
  for (int y = 0; y < h; y++) {
    int f = raw[o++];
    uint8_t* line = &out[y * stride];
    memcpy(line, &raw[o], stride);
    o += stride;
    switch (f) {
      case 0: break;
      case 1:
        for (size_t x = bpp; x < stride; x++) line[x] += line[x - bpp];
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) line[x] += prev[x];
        break;
      case 3:
        for (size_t x = 0; x < stride; x++) {
          int left = x >= (size_t)bpp ? line[x - bpp] : 0;
          line[x] += (left + prev[x]) >> 1;
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; x++) {
          int left = x >= (size_t)bpp ? line[x - bpp] : 0;
          int ul = x >= (size_t)bpp ? prev[x - bpp] : 0;
          line[x] += paeth(left, prev[x], ul);
        }
        break;
      default:
        return img;
    }
    memcpy(prev.data(), line, stride);
  }

  img.w = w;
  img.h = h;
  img.data.resize((size_t)w * h);
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const uint8_t* px = &out[y * stride + (size_t)x * bpp];
      float v;
      if (bitd == 16) {
        if (nch >= 3) {
          float r = (px[0] << 8) | px[1], g = (px[2] << 8) | px[3],
                b = (px[4] << 8) | px[5];
          v = 0.299f * r + 0.587f * g + 0.114f * b;
        } else {
          v = (float)((px[0] << 8) | px[1]);
        }
      } else {
        if (nch >= 3)
          v = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
        else
          v = px[0];
      }
      img.data[(size_t)y * w + x] = v;
    }
  }
  img.ok = true;
  return img;
}

Image decode_file(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return {};
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  size_t rd = fread(buf.data(), 1, n, f);
  fclose(f);
  if ((long)rd != n) return {};
  if (n > 8 && buf[0] == 0x89) return decode_png(buf);
  return decode_pnm(buf);
}

// ------------------------------------------------------------- loader ----
struct Frame {
  int index = -1;
  Image gray, depth;
};

struct Loader {
  std::vector<std::string> rgb, dep;
  float depth_scale = 1.0f;
  int queue_cap = 50;
  std::atomic<int> next_job{0};
  int next_out = 0;
  std::map<int, Frame> ready;  // ordered by index (the mFrameQueue std::map)
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      int job = next_job.fetch_add(1);
      if (stop.load() || job >= (int)rgb.size()) return;
      Frame fr;
      fr.index = job;
      fr.gray = decode_file(rgb[job]);
      if (!dep.empty() && !dep[job].empty()) {
        fr.depth = decode_file(dep[job]);
        if (fr.depth.ok && depth_scale != 1.0f)
          for (auto& v : fr.depth.data) v *= depth_scale;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || (int)ready.size() < queue_cap ||
               job < next_out + queue_cap;
      });
      if (stop.load()) return;
      ready.emplace(job, std::move(fr));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* gfs_loader_create(const char** rgb_paths, const char** depth_paths,
                        int n, int n_threads, int queue_cap,
                        float depth_scale) {
  auto* L = new Loader();
  L->rgb.assign(rgb_paths, rgb_paths + n);
  if (depth_paths) {
    L->dep.resize(n);
    for (int i = 0; i < n; i++)
      L->dep[i] = depth_paths[i] ? depth_paths[i] : "";
  }
  L->depth_scale = depth_scale;
  L->queue_cap = queue_cap;
  for (int i = 0; i < n_threads; i++)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Returns 1 with the next frame in order, 0 at end of sequence, -1 on a
// decode failure (frame skipped; call again).
int gfs_loader_next(void* h, float* gray_out, float* depth_out, int* w_out,
                    int* h_out, int* index_out) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= (int)L->rgb.size()) return 0;
  L->cv_ready.wait(lk, [&] { return L->ready.count(L->next_out) > 0; });
  Frame fr = std::move(L->ready[L->next_out]);
  L->ready.erase(L->next_out);
  L->next_out++;
  L->cv_space.notify_all();
  lk.unlock();

  *index_out = fr.index;
  if (!fr.gray.ok) return -1;
  *w_out = fr.gray.w;
  *h_out = fr.gray.h;
  memcpy(gray_out, fr.gray.data.data(), fr.gray.data.size() * sizeof(float));
  if (depth_out && fr.depth.ok)
    memcpy(depth_out, fr.depth.data.data(),
           fr.depth.data.size() * sizeof(float));
  return 1;
}

void gfs_loader_destroy(void* h) {
  auto* L = (Loader*)h;
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Standalone single-image decode (for tools/tests).
int gfs_decode_image(const char* path, float* out, int max_elems, int* w_out,
                     int* h_out) {
  Image img = decode_file(path);
  if (!img.ok || (int)img.data.size() > max_elems) return 0;
  *w_out = img.w;
  *h_out = img.h;
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  return 1;
}

}  // extern "C"
