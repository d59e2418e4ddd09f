// vo_loader.cpp — native image loader of tpu_vo_torch (io/native_loader.py).
//
// The port's counterpart of the JAX package's native/vo_loader.cpp: a
// C++17 shared library that scans datasets, decodes PNG/JPEG on a worker
// pool into an ordered ring buffer, converts to grayscale with the exact
// BT.601 fixed-point arithmetic of image/color, and serves frames to
// Python through a minimal C ABI (ctypes — no pybind dependency). Also
// reads and writes the packed ".vobin" sequence format (decode once,
// stream raw frames via mmap).
//
// The decoders are this directory's own (codecs.h: inflate.cpp,
// png_decode.cpp, jpeg_decode.cpp), so the library needs no image or
// compression library. They give the pixels that the original's libpng
// and libjpeg calls give, and an Adam7-interlaced PNG is read whole, which
// the original cannot do (libpng stops there with "IDAT: Too much image
// data"). JPEG decodes as io/jpeg.py does: sequential and progressive,
// Huffman- and arithmetic-coded.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC vo_loader.cpp inflate.cpp
//        png_decode.cpp jpeg_decode.cpp -o libvo_loader.so -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "codecs.h"

namespace fs = std::filesystem;

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> gray;  // height * width
  bool ok = false;
};

bool has_ext(const std::string &path, const char *ext) {
  auto n = std::strlen(ext);
  if (path.size() < n) return false;
  std::string tail = path.substr(path.size() - n);
  std::transform(tail.begin(), tail.end(), tail.begin(), ::tolower);
  return tail == ext;
}

bool read_file(const std::string &path, std::vector<uint8_t> &data) {
  FILE *fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(fp) : -1;
  ok = size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    data.resize(static_cast<size_t>(size));
    ok = std::fread(data.data(), 1, data.size(), fp) == data.size();
  }
  std::fclose(fp);
  return ok;
}

Image decode(const std::string &path) {
  Image out;
  const bool png = has_ext(path, ".png");
  if (!png && !has_ext(path, ".jpg") && !has_ext(path, ".jpeg")) return out;
  try {
    std::vector<uint8_t> data;
    vo::GrayImage img;
    if (!read_file(path, data) || !(png ? vo::decode_png(data.data(), data.size(), img)
                                        : vo::decode_jpeg(data.data(), data.size(), img)))
      return out;
    out.width = img.width;
    out.height = img.height;
    out.gray = std::move(img.pixels);
    out.ok = true;
  } catch (const std::bad_alloc &) {  // a frame too large to hold is unreadable
  }
  return out;
}

// --------------------------------------------------------------------------
// Dataset handle: enumeration + threaded ordered prefetch.
// --------------------------------------------------------------------------

struct Dataset {
  std::vector<std::string> paths;
  int width = 0;
  int height = 0;

  // prefetch state
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produced;
  std::condition_variable cv_space;
  std::map<int, Image> ready;  // decoded frames awaiting consumption
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  size_t max_buffered = 4;
  std::atomic<bool> stopping{false};

  ~Dataset() { stop(); }

  void stop() {
    stopping.store(true);
    cv_space.notify_all();
    cv_produced.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  void worker() {
    for (;;) {
      if (stopping.load()) return;
      int idx = next_to_decode.fetch_add(1);
      if (idx >= static_cast<int>(paths.size())) return;
      Image img = decode(paths[idx]);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stopping.load() || ready.size() < max_buffered ||
               idx < next_to_consume + static_cast<int>(max_buffered);
      });
      if (stopping.load()) return;
      ready.emplace(idx, std::move(img));
      cv_produced.notify_all();
    }
  }

  void start(int n_threads, int depth) {
    max_buffered = std::max(depth, n_threads + 1);
    stopping.store(false);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  // Returns 1 on success, 0 on decode failure (frame skipped upstream),
  // -1 at end of sequence.
  int next(uint8_t *out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_consume >= static_cast<int>(paths.size())) return -1;
    cv_produced.wait(lk, [&] {
      return stopping.load() || ready.count(next_to_consume) > 0;
    });
    if (stopping.load()) return -1;
    Image img = std::move(ready[next_to_consume]);
    ready.erase(next_to_consume);
    ++next_to_consume;
    cv_space.notify_all();
    lk.unlock();
    if (!img.ok || img.width != width || img.height != height) return 0;
    std::memcpy(out, img.gray.data(), img.gray.size());
    return 1;
  }
};

// --------------------------------------------------------------------------
// Packed .vobin sequences: [magic "VOBN" | u32 version | u32 T,H,W] + raw.
// --------------------------------------------------------------------------

struct Pack {
  int fd = -1;
  const uint8_t *base = nullptr;
  size_t bytes = 0;
  uint32_t T = 0, H = 0, W = 0;

  ~Pack() {
    if (base) munmap(const_cast<uint8_t *>(base), bytes);
    if (fd >= 0) close(fd);
  }
};

constexpr uint32_t kMagic = 0x4e424f56;  // "VOBN"
constexpr size_t kHeader = 20;

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Dataset>> g_datasets;
std::map<int64_t, std::unique_ptr<Pack>> g_packs;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

int64_t vl_open_dataset(const char *dir) {
  auto ds = std::make_unique<Dataset>();
  std::error_code ec;
  for (const auto &e : fs::directory_iterator(dir, ec)) {
    if (!e.is_regular_file()) continue;
    const std::string p = e.path().string();
    if (has_ext(p, ".png") || has_ext(p, ".jpg") || has_ext(p, ".jpeg"))
      ds->paths.push_back(p);
  }
  if (ec || ds->paths.empty()) return 0;
  std::sort(ds->paths.begin(), ds->paths.end());
  Image first = decode(ds->paths[0]);
  if (!first.ok) return 0;
  ds->width = first.width;
  ds->height = first.height;
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_datasets[h] = std::move(ds);
  return h;
}

int vl_num_frames(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_datasets.find(h);
  return it == g_datasets.end() ? -1
                                : static_cast<int>(it->second->paths.size());
}

int vl_width(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_datasets.find(h);
  return it == g_datasets.end() ? -1 : it->second->width;
}

int vl_height(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_datasets.find(h);
  return it == g_datasets.end() ? -1 : it->second->height;
}

void vl_start_prefetch(int64_t h, int n_threads, int depth) {
  Dataset *ds;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_datasets.find(h);
    if (it == g_datasets.end()) return;
    ds = it->second.get();
  }
  ds->start(std::max(1, n_threads), std::max(2, depth));
}

int vl_next(int64_t h, uint8_t *out) {
  Dataset *ds;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_datasets.find(h);
    if (it == g_datasets.end()) return -2;
    ds = it->second.get();
  }
  return ds->next(out);
}

int vl_read_frame(int64_t h, int idx, uint8_t *out) {
  Dataset *ds;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_datasets.find(h);
    if (it == g_datasets.end()) return -2;
    ds = it->second.get();
  }
  if (idx < 0 || idx >= static_cast<int>(ds->paths.size())) return -1;
  Image img = decode(ds->paths[idx]);
  if (!img.ok || img.width != ds->width || img.height != ds->height) return 0;
  std::memcpy(out, img.gray.data(), img.gray.size());
  return 1;
}

void vl_close(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_datasets.erase(h);
}

// ---- packed sequences ------------------------------------------------------

int vl_pack_dataset(const char *dir, const char *out_path, int n_threads) {
  int64_t h = vl_open_dataset(dir);
  if (!h) return -1;
  Dataset *ds;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    ds = g_datasets[h].get();
  }
  const uint32_t T = ds->paths.size(), H = ds->height, W = ds->width;
  FILE *fp = std::fopen(out_path, "wb");
  if (!fp) {
    vl_close(h);
    return -2;
  }
  uint32_t header[5] = {kMagic, 1u, T, H, W};
  std::fwrite(header, sizeof(header), 1, fp);
  ds->start(std::max(1, n_threads), 2 * n_threads);
  std::vector<uint8_t> buf(static_cast<size_t>(H) * W);
  int written = 0;
  for (;;) {
    int r = ds->next(buf.data());
    if (r < 0) break;
    if (r == 0) std::memset(buf.data(), 0, buf.size());  // unreadable: zeros
    std::fwrite(buf.data(), buf.size(), 1, fp);
    ++written;
  }
  std::fclose(fp);
  vl_close(h);
  return written;
}

int64_t vl_open_pack(const char *path) {
  auto pk = std::make_unique<Pack>();
  pk->fd = open(path, O_RDONLY);
  if (pk->fd < 0) return 0;
  struct stat st;
  if (fstat(pk->fd, &st) != 0) return 0;
  pk->bytes = st.st_size;
  void *m = mmap(nullptr, pk->bytes, PROT_READ, MAP_PRIVATE, pk->fd, 0);
  if (m == MAP_FAILED) return 0;
  pk->base = static_cast<const uint8_t *>(m);
  const uint32_t *hdr = reinterpret_cast<const uint32_t *>(pk->base);
  if (pk->bytes < kHeader || hdr[0] != kMagic || hdr[1] != 1u) return 0;
  pk->T = hdr[2];
  pk->H = hdr[3];
  pk->W = hdr[4];
  if (pk->bytes != kHeader + static_cast<size_t>(pk->T) * pk->H * pk->W)
    return 0;
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_packs[h] = std::move(pk);
  return h;
}

int vl_pack_info(int64_t h, int *T, int *H, int *W) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_packs.find(h);
  if (it == g_packs.end()) return -1;
  *T = it->second->T;
  *H = it->second->H;
  *W = it->second->W;
  return 0;
}

int vl_pack_read(int64_t h, int start, int count, uint8_t *out) {
  Pack *pk;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_packs.find(h);
    if (it == g_packs.end()) return -1;
    pk = it->second.get();
  }
  if (start < 0 || count < 0 ||
      start + count > static_cast<int>(pk->T))
    return -1;
  const size_t frame = static_cast<size_t>(pk->H) * pk->W;
  std::memcpy(out, pk->base + kHeader + frame * start, frame * count);
  return count;
}

void vl_close_pack(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_packs.erase(h);
}

}  // extern "C"
