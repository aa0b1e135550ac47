// Native data loader of the PyTorch port (its own copy of the JAX
// package's native/dataloader.cc): threaded JPEG decode -> nearest-neighbor
// resize -> ImageNet normalization, with an asynchronous batch pipeline.
//
// The counterpart of the reference's CPU-side loader tasks (model.cu:97-211:
// load_images_task's JPEG decode and nearest-neighbor resize, then the
// apply_normalize kernel's (u8/256 - mean)/std), with the Legion "loader CPU
// processors" replaced by an in-process thread pool and the zero-copy
// staging memory by caller-provided host buffers that Python wraps as
// tensors (flexflow_tpu_torch/data/native.py).
//
// Differences from the reference (deliberate, as in the JAX package):
//   * output layout is NHWC float32, not NCHW;
//   * grayscale JPEGs are promoted to RGB via libjpeg out_color_space
//     instead of being skipped;
//   * decode errors leave the slot zero-filled with label preserved instead
//     of aborting the run.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

namespace {

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file into normalized float NHWC at (height, width).
// Returns 0 on success; on failure `out` is zero-filled.
int decode_one(const char* path, int height, int width, float* out) {
  std::memset(out, 0, sizeof(float) * 3 * height * width);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  std::vector<unsigned char> rgb;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // promotes grayscale; CMYK will fail out
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -3;
  }
  const int ow = cinfo.output_width, oh = cinfo.output_height;
  const int row_stride = ow * 3;
  rgb.resize(static_cast<size_t>(oh) * row_stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* rowp = rgb.data() +
        static_cast<size_t>(cinfo.output_scanline) * row_stride;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  // Nearest-neighbor resize (reference index rule: round(y*scale), clamped
  // — model.cu:74-90) fused with (u8/256 - mean)/std into NHWC floats.
  const float hs = static_cast<float>(oh) / height;
  const float ws = static_cast<float>(ow) / width;
  for (int y = 0; y < height; y++) {
    int y0 = static_cast<int>(y * hs + 0.5f);
    if (y0 > oh - 1) y0 = oh - 1;
    const unsigned char* row = rgb.data() + static_cast<size_t>(y0) * row_stride;
    float* orow = out + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; x++) {
      int x0 = static_cast<int>(x * ws + 0.5f);
      if (x0 > ow - 1) x0 = ow - 1;
      const unsigned char* px = row + x0 * 3;
      for (int c = 0; c < 3; c++) {
        orow[x * 3 + c] = (px[c] / 256.0f - kMean[c]) / kStd[c];
      }
    }
  }
  return 0;
}

struct Batch {
  std::vector<std::string> files;
  std::vector<int> labels;
  std::vector<float> img;     // n * h * w * 3
  std::atomic<int> remaining{0};
};

struct Loader {
  int height, width;
  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for work
  std::condition_variable cv_done;   // consumer waits for front batch
  std::deque<std::shared_ptr<Batch>> fifo;          // submit order
  std::deque<std::pair<std::shared_ptr<Batch>, int>> work;  // (batch, idx)
  std::vector<std::thread> workers;
  bool stop = false;

  explicit Loader(int h, int w, int nthreads) : height(h), width(w) {
    for (int i = 0; i < nthreads; i++) {
      workers.emplace_back([this] { run(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  void run() {
    for (;;) {
      std::pair<std::shared_ptr<Batch>, int> item;
      {
        std::unique_lock<std::mutex> g(mu);
        cv_work.wait(g, [this] { return stop || !work.empty(); });
        if (stop && work.empty()) return;
        item = work.front();
        work.pop_front();
      }
      Batch& b = *item.first;
      const int i = item.second;
      decode_one(b.files[i].c_str(), height, width,
                 b.img.data() + static_cast<size_t>(i) * height * width * 3);
      if (b.remaining.fetch_sub(1) == 1) {
        // take mu so the notify can't slip between the consumer's predicate
        // check and its wait (lost-wakeup)
        std::lock_guard<std::mutex> g(mu);
        cv_done.notify_all();
      }
    }
  }

  void submit(const char** files, const int32_t* labels, int n) {
    auto b = std::make_shared<Batch>();
    b->files.reserve(n);
    b->labels.assign(labels, labels + n);
    for (int i = 0; i < n; i++) b->files.emplace_back(files[i]);
    b->img.resize(static_cast<size_t>(n) * height * width * 3);
    b->remaining.store(n);
    {
      std::lock_guard<std::mutex> g(mu);
      fifo.push_back(b);
      for (int i = 0; i < n; i++) work.emplace_back(b, i);
    }
    cv_work.notify_all();
  }

  // Blocks until the oldest submitted batch is fully decoded; copies it out.
  int next(float* img, int32_t* lbl) {
    std::shared_ptr<Batch> b;
    {
      std::unique_lock<std::mutex> g(mu);
      if (fifo.empty()) return -1;
      b = fifo.front();
      fifo.pop_front();
    }
    {
      std::unique_lock<std::mutex> g(mu);
      cv_done.wait(g, [&b] { return b->remaining.load() == 0; });
    }
    std::memcpy(img, b->img.data(), b->img.size() * sizeof(float));
    std::memcpy(lbl, b->labels.data(), b->labels.size() * sizeof(int32_t));
    return static_cast<int>(b->labels.size());
  }
};

}  // namespace

extern "C" {

void* ffdata_create(int height, int width, int nthreads) {
  if (height <= 0 || width <= 0 || nthreads <= 0) return nullptr;
  return new Loader(height, width, nthreads);
}

void ffdata_destroy(void* h) { delete static_cast<Loader*>(h); }

void ffdata_submit(void* h, const char** files, const int32_t* labels,
                   int n) {
  static_cast<Loader*>(h)->submit(files, labels, n);
}

int ffdata_next(void* h, float* img, int32_t* lbl) {
  return static_cast<Loader*>(h)->next(img, lbl);
}

// Synchronous single-image decode (tests / fallback path).
int ffdata_decode(const char* path, int height, int width, float* out) {
  return decode_one(path, height, width, out);
}

}  // extern "C"
