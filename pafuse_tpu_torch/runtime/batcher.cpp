// Native batch assembly for the training sampler.
//
// A copy of pafuse_tpu/runtime/batcher.cpp with the same C ABI (the port
// builds its own copy and imports nothing of the JAX package).  The hot
// host-side loop of training is assembling (batch, chunk, joints, chans)
// windows from the contiguous pose buffer: an edge-clamped frame gather
// plus, for flip-augmented rows, a joint permutation with x-negation.  This
// does it in one multithreaded pass, so batch assembly overlaps the device
// step through the PrefetchingLoader.
//
// Exposed through a plain C ABI that Python loads with ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src:        (total_frames, joints, chans) float32 contiguous buffer
// frame_idx:  (batch, chunk) int64 global frame indices (pre-clamped)
// flip_mask:  (batch,) uint8, 1 = apply flip augmentation
// perm:       (joints,) int32 flip permutation (left<->right swap)
// out:        (batch, chunk, joints, chans) float32
void assemble_batch(const float* src, const int64_t* frame_idx,
                    const uint8_t* flip_mask, const int32_t* perm,
                    float* out, int64_t batch, int64_t chunk,
                    int64_t joints, int64_t chans, int64_t n_threads) {
  const int64_t frame_elems = joints * chans;
  const int64_t row_elems = chunk * frame_elems;
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > batch) n_threads = batch > 0 ? batch : 1;

  std::atomic<int64_t> next_row(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next_row.fetch_add(1);
      if (b >= batch) return;
      float* dst_row = out + b * row_elems;
      const int64_t* idx_row = frame_idx + b * chunk;
      const bool flip = flip_mask != nullptr && flip_mask[b] != 0;
      for (int64_t f = 0; f < chunk; ++f) {
        const float* src_frame = src + idx_row[f] * frame_elems;
        float* dst_frame = dst_row + f * frame_elems;
        if (!flip) {
          std::memcpy(dst_frame, src_frame,
                      sizeof(float) * static_cast<size_t>(frame_elems));
        } else {
          for (int64_t j = 0; j < joints; ++j) {
            const float* sj = src_frame + perm[j] * chans;
            float* dj = dst_frame + j * chans;
            dj[0] = -sj[0];  // mirror: negate x
            for (int64_t c = 1; c < chans; ++c) dj[c] = sj[c];
          }
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads - 1));
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
