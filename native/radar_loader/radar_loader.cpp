// Native radar sequence loader: threaded PNG decode + prefetch ring.
//
// Counterpart of the reference's sensor ingestion path
// (cfear_radarodometry radar_driver.cpp rosbag/image callbacks +
// tbv_slam/include/tbv_slam/safe_queue.h): a worker pool decodes polar radar
// PNGs ahead of the consumer into a bounded ring buffer, so the Python host
// loop that feeds the accelerator never stalls on libpng.  Exposed as a plain C API
// consumed through ctypes (no pybind11 in this toolchain).
//
// Layout handled natively:
//  - Oxford Radar RobotCar: [400, 11 + R] uint8 PNGs; the first 11 columns
//    are per-azimuth metadata (timestamp/counter/valid) and are stripped.
//  - flat uint8 polar PNGs (flavor=raw): returned as-is.
//
// Build: make -C native/radar_loader   (produces libradar_loader.so)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <png.h>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  int64_t index = -1;
  double stamp = 0.0;
  int rows = 0;
  int cols = 0;
  std::vector<uint8_t> data;  // row-major [rows, cols]
  bool ok = false;
};

// Decode an 8-bit (or 16-bit, truncated) grayscale PNG.
bool DecodePng(const std::string &path, int strip_cols, Frame *out) {
  FILE *fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  png_byte color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray(png, 1, -1, -1);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<uint8_t> rowbuf(png_get_rowbytes(png, info));
  const int out_cols = static_cast<int>(width) - strip_cols;
  if (out_cols <= 0) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  out->rows = static_cast<int>(height);
  out->cols = out_cols;
  out->data.resize(static_cast<size_t>(height) * out_cols);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, rowbuf.data(), nullptr);
    std::memcpy(&out->data[static_cast<size_t>(y) * out_cols],
                rowbuf.data() + strip_cols, out_cols);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out->ok = true;
  return true;
}

// Bounded thread-safe slot map: decoded frames parked until consumed in
// order (the SafeQueue analogue, but order-restoring since decode is
// parallel).
class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> paths, std::vector<double> stamps,
             int strip_cols, int num_threads, int depth)
      : paths_(std::move(paths)), stamps_(std::move(stamps)),
        strip_cols_(strip_cols), depth_(depth) {
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { Work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_slot_.notify_all();
    cv_done_.notify_all();
    for (auto &t : workers_) t.join();
  }

  // Blocking in-order pop; returns false at end of sequence.
  bool Next(Frame *out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_out_ >= static_cast<int64_t>(paths_.size())) return false;
    cv_done_.wait(lk, [this] {
      return stop_ || done_.count(next_out_) > 0;
    });
    if (stop_) return false;
    *out = std::move(done_[next_out_]);
    done_.erase(next_out_);
    ++next_out_;
    cv_slot_.notify_all();
    return true;
  }

 private:
  void Work() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_slot_.wait(lk, [this] {
          return stop_ ||
                 (next_in_ < static_cast<int64_t>(paths_.size()) &&
                  next_in_ - next_out_ < depth_);
        });
        if (stop_) return;
        idx = next_in_++;
      }
      Frame f;
      f.index = idx;
      f.stamp = stamps_[idx];
      DecodePng(paths_[idx], strip_cols_, &f);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(f);
      }
      cv_done_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  std::vector<double> stamps_;
  int strip_cols_;
  int depth_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_slot_, cv_done_;
  std::map<int64_t, Frame> done_;
  int64_t next_in_ = 0;
  int64_t next_out_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

struct RLHandle {
  Prefetcher *pf;
  Frame current;
};

// paths: '\n'-separated file list; stamps parallel array (seconds).
RLHandle *rl_open(const char *paths_joined, const double *stamps, int n,
                  int strip_cols, int num_threads, int prefetch_depth) {
  std::vector<std::string> paths;
  std::vector<double> st(stamps, stamps + n);
  const char *p = paths_joined;
  for (int i = 0; i < n; ++i) {
    const char *nl = std::strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    paths.emplace_back(p, len);
    p += len + (nl ? 1 : 0);
  }
  auto *h = new RLHandle();
  h->pf = new Prefetcher(std::move(paths), std::move(st), strip_cols,
                         num_threads, prefetch_depth);
  return h;
}

// Advance to the next frame. Returns 1 on success, 0 at end.
// Metadata out-params: rows, cols, stamp; data fetched via rl_copy.
int rl_next(RLHandle *h, int *rows, int *cols, double *stamp, int *ok) {
  if (!h->pf->Next(&h->current)) return 0;
  *rows = h->current.rows;
  *cols = h->current.cols;
  *stamp = h->current.stamp;
  *ok = h->current.ok ? 1 : 0;
  return 1;
}

// Copy the current frame into caller-owned memory of size rows*cols.
void rl_copy(RLHandle *h, uint8_t *dst) {
  std::memcpy(dst, h->current.data.data(), h->current.data.size());
}

void rl_close(RLHandle *h) {
  delete h->pf;
  delete h;
}

// One-shot decode without a prefetcher (utility/testing).
int rl_decode(const char *path, int strip_cols, uint8_t *dst, int max_bytes,
              int *rows, int *cols) {
  Frame f;
  if (!DecodePng(path, strip_cols, &f)) return 0;
  if (static_cast<int>(f.data.size()) > max_bytes) return 0;
  std::memcpy(dst, f.data.data(), f.data.size());
  *rows = f.rows;
  *cols = f.cols;
  return 1;
}

}  // extern "C"
