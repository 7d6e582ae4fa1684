// Host-side batch state assembly for the training input pipeline: the
// port's copy of the JAX package's native gather
// (dt4image_restoration_tpu/data/native_loader.py, _CPP_SOURCE).
//
// out[i] = float32(src[rows[i]] / 255) for rows[i] >= 0, zeros for -1
// (the short-trajectory pad). The conversion goes through a 256-entry LUT
// built in double precision, so the result is bit-exact with numpy's
// np.float32(uint8_array / 255) (float64 divide, then float32 cast). Rows
// are split over std::thread workers; the caller (ctypes) releases the
// GIL for the whole call. Built with g++ (not nvcc): it runs on the host.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Lut {
    float v[256];
    Lut() {
        for (int i = 0; i < 256; ++i)
            v[i] = static_cast<float>(static_cast<double>(i) / 255.0);
    }
};
const Lut kLut;

void gather_range(const std::uint8_t* src, std::int64_t img_elems,
                  const std::int64_t* rows, float* out,
                  std::int64_t begin, std::int64_t end) {
    for (std::int64_t i = begin; i < end; ++i) {
        float* dst = out + i * img_elems;
        const std::int64_t r = rows[i];
        if (r < 0) {
            std::memset(dst, 0, sizeof(float) * img_elems);
            continue;
        }
        const std::uint8_t* s = src + r * img_elems;
        for (std::int64_t j = 0; j < img_elems; ++j)
            dst[j] = kLut.v[s[j]];
    }
}

}  // namespace

extern "C" void dt4ir_gather_scale(const std::uint8_t* src,
                                   std::int64_t img_elems,
                                   const std::int64_t* rows,
                                   std::int64_t n_rows,
                                   float* out,
                                   std::int32_t n_threads) {
    if (n_threads <= 1 || n_rows < 2 * n_threads) {
        gather_range(src, img_elems, rows, out, 0, n_rows);
        return;
    }
    std::vector<std::thread> workers;
    const std::int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (std::int32_t t = 0; t < n_threads; ++t) {
        const std::int64_t begin = t * chunk;
        if (begin >= n_rows) break;
        const std::int64_t end = std::min(begin + chunk, n_rows);
        workers.emplace_back(gather_range, src, img_elems, rows, out,
                             begin, end);
    }
    for (auto& w : workers) w.join();
}
