// vors_io — native data-loader core for visual_odometry_rs_tpu.
//
// Native equivalent of the reference's IO layer
// (src/misc/helper.rs:13-36 `read_png_16bits`, src/misc/interop.rs and the
// image crate's `to_luma` used at src/bin/vors_track.rs:141-143): libpng
// decode of 16-bit grayscale depth PNGs and 8-bit gray/RGB color PNGs with
// the image crate's integer BT.601 luma ((299R + 587G + 114B) / 1000), plus
// a multi-threaded prefetching frame loader (the reference decodes frames
// one-by-one on the tracking thread; here decode overlaps device compute so
// host IO never stalls the device step).
//
// Exposed as a plain C API consumed from Python via ctypes
// (visual_odometry_rs_tpu/native/__init__.py).  No Python.h dependency.

#include <png.h>

#include <condition_variable>
#include <cstdint>
#include <memory>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int height = 0;
  int width = 0;
  int channels = 0;   // 1 or 3 (alpha is stripped)
  int bit_depth = 0;  // 8 or 16
  std::vector<uint8_t> data;  // row-major, native byte order, u8 or u16
};

// Decode any PNG into 8/16-bit gray or RGB rows (palette expanded, alpha
// stripped, 16-bit network byte order swapped to host).
bool decode_png(const char* path, Image* out, std::string* err) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    *err = std::string("not a PNG: ") + path;
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    *err = "libpng init failed";
    return false;
  }
  std::vector<png_bytep> row_ptrs;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    *err = std::string("libpng decode error: ") + path;
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // big-endian PNG -> host LE u16
  png_read_update_info(png, info);

  bit_depth = png_get_bit_depth(png, info);
  color_type = png_get_color_type(png, info);
  int channels = png_get_channels(png, info);

  out->height = static_cast<int>(height);
  out->width = static_cast<int>(width);
  out->channels = channels;
  out->bit_depth = bit_depth;
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.assign(rowbytes * height, 0);
  row_ptrs.resize(height);
  for (png_uint_32 y = 0; y < height; ++y)
    row_ptrs[y] = out->data.data() + y * rowbytes;
  png_read_image(png, row_ptrs.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

thread_local std::string g_last_error;

// RGB u8 rows -> BT.601 integer luma, matching the Rust image crate / the
// Python fallback in dataset.tum_rgbd.read_gray: (299R + 587G + 114B) / 1000.
inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
  return static_cast<uint8_t>(
      (299u * r + 587u * g + 114u * b) / 1000u);
}

bool to_gray_u8(const Image& img, uint8_t* out, std::string* err) {
  const int n = img.height * img.width;
  if (img.bit_depth == 8 && img.channels == 1) {
    std::memcpy(out, img.data.data(), n);
    return true;
  }
  if (img.bit_depth == 8 && img.channels == 3) {
    const uint8_t* p = img.data.data();
    for (int i = 0; i < n; ++i, p += 3) out[i] = luma(p[0], p[1], p[2]);
    return true;
  }
  if (img.bit_depth == 16 && img.channels == 1) {
    // image::to_luma on 16-bit gray keeps the high byte (u16 -> u8 scaling)
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.data.data());
    for (int i = 0; i < n; ++i) out[i] = static_cast<uint8_t>(p[i] >> 8);
    return true;
  }
  *err = "unsupported PNG layout for gray conversion";
  return false;
}

}  // namespace

extern "C" {

const char* vors_last_error() { return g_last_error.c_str(); }

// Query dimensions from the PNG header only (IHDR via png_read_info — no
// pixel decode). Returns 0 on success.
int vors_png_dims(const char* path, int* height, int* width) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    g_last_error = std::string("cannot open ") + path;
    return 1;
  }
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    g_last_error = std::string("not a PNG: ") + path;
    return 1;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    g_last_error = "libpng init failed";
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    g_last_error = std::string("libpng header error: ") + path;
    return 1;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  *height = static_cast<int>(png_get_image_height(png, info));
  *width = static_cast<int>(png_get_image_width(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode a 16-bit grayscale depth PNG into `out` (height*width u16,
// row-major, host byte order). Mirrors helper.rs:13-36 which requires
// ColorType::Grayscale + 16-bit big-endian. Returns 0 on success.
int vors_read_png16(const char* path, uint16_t* out, int height, int width) {
  Image img;
  if (!decode_png(path, &img, &g_last_error)) return 1;
  if (img.bit_depth != 16 || img.channels != 1) {
    g_last_error = std::string("expected 16-bit grayscale PNG: ") + path;
    return 2;
  }
  if (img.height != height || img.width != width) {
    g_last_error = std::string("unexpected dimensions: ") + path;
    return 3;
  }
  std::memcpy(out, img.data.data(), sizeof(uint16_t) * height * width);
  return 0;
}

// Decode a color/gray PNG into u8 luma (BT.601 integer weights).
int vors_read_gray(const char* path, uint8_t* out, int height, int width) {
  Image img;
  if (!decode_png(path, &img, &g_last_error)) return 1;
  if (img.height != height || img.width != width) {
    g_last_error = std::string("unexpected dimensions: ") + path;
    return 3;
  }
  if (!to_gray_u8(img, out, &g_last_error)) return 2;
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded prefetch loader: decodes (depth, color) pairs ahead of the
// consumer on a worker pool, delivering frames strictly in order.
// ---------------------------------------------------------------------------

struct FramePair {
  std::vector<uint16_t> depth;
  std::vector<uint8_t> gray;
  int status = 0;  // 0 ok, nonzero = decode error code
  std::string error;
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> color_paths;
  int height = 0, width = 0;
  size_t next_to_schedule = 0;  // guarded by mu
  size_t next_to_deliver = 0;   // guarded by mu
  size_t ahead = 0;             // frames decoded or in flight but undelivered
  size_t max_ahead = 0;
  std::vector<std::unique_ptr<FramePair>> done;  // index-aligned slots
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_worker;    // work available / room in window
  std::condition_variable cv_consumer;  // frame ready
  bool stop = false;

  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_worker.wait(lock, [&] {
          return stop || (next_to_schedule < depth_paths.size() &&
                          ahead < max_ahead);
        });
        if (stop) return;
        idx = next_to_schedule++;
        ahead++;
      }
      auto fp = std::make_unique<FramePair>();
      fp->depth.resize(static_cast<size_t>(height) * width);
      fp->gray.resize(static_cast<size_t>(height) * width);
      fp->status = vors_read_png16(depth_paths[idx].c_str(), fp->depth.data(),
                                   height, width);
      if (fp->status == 0)
        fp->status = vors_read_gray(color_paths[idx].c_str(), fp->gray.data(),
                                    height, width);
      if (fp->status != 0) fp->error = g_last_error;
      {
        std::lock_guard<std::mutex> lock(mu);
        done[idx] = std::move(fp);
      }
      cv_consumer.notify_all();
    }
  }
};

// Create a loader over n frames. Paths are flat arrays of C strings.
// `num_threads` decode workers, window of `max_ahead` frames in flight.
void* vors_loader_create(const char** depth_paths, const char** color_paths,
                         int n, int height, int width, int num_threads,
                         int max_ahead) {
  auto* ld = new Loader();
  ld->depth_paths.reserve(n);
  ld->color_paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    ld->depth_paths.emplace_back(depth_paths[i]);
    ld->color_paths.emplace_back(color_paths[i]);
  }
  ld->height = height;
  ld->width = width;
  ld->max_ahead = max_ahead < 1 ? 1 : static_cast<size_t>(max_ahead);
  ld->done.resize(n);
  int nt = num_threads < 1 ? 1 : num_threads;
  for (int i = 0; i < nt; ++i)
    ld->workers.emplace_back([ld] { ld->worker_loop(); });
  return ld;
}

// Blocking in-order delivery of the next decoded frame pair. Returns 0 on
// success, -1 when the sequence is exhausted, else the decode error code.
int vors_loader_next(void* handle, uint16_t* depth_out, uint8_t* gray_out) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_ptr<FramePair> fp;
  {
    std::unique_lock<std::mutex> lock(ld->mu);
    if (ld->next_to_deliver >= ld->depth_paths.size()) return -1;
    size_t idx = ld->next_to_deliver;
    ld->cv_consumer.wait(lock, [&] { return ld->done[idx] != nullptr; });
    fp = std::move(ld->done[idx]);
    ld->next_to_deliver++;
    ld->ahead--;
  }
  ld->cv_worker.notify_all();
  if (fp->status == 0) {
    std::memcpy(depth_out, fp->depth.data(),
                sizeof(uint16_t) * ld->height * ld->width);
    std::memcpy(gray_out, fp->gray.data(),
                sizeof(uint8_t) * ld->height * ld->width);
  } else {
    g_last_error = fp->error;
  }
  return fp->status;
}

void vors_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    ld->stop = true;
  }
  ld->cv_worker.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
