// Host-side trajectory operations for mjrl_tpu_torch (the port's own copy
// of mjrl_tpu/native/src/pathops.cpp, same three functions and signatures).
//
// They do the host boundary work around the device: packing ragged path
// lists into padded (N, T, D) batches with validity masks, and reverse
// discounted sums / GAE over ragged arrays (utils/process_samples.py).
//
// Built with: g++ -O3 -shared -fPIC pathops.cpp -o libpathops.so
// Bound via ctypes (mjrl_tpu_torch/native/__init__.py).  One departure
// from the JAX package's copy: a path of length 0 reads no bootstrap
// value in gae_advantages (the JAX copy reads values[offset - 1], which
// its loop then never uses).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Pack a ragged concatenation into a padded batch.
//  flat:    (sum_i len_i, dim) row-major input
//  lengths: (n,) per-path lengths
//  out:     (n, max_len, dim) zero-initialized output
//  mask:    (n, max_len) zero-initialized output (1.0 on valid steps)
void pack_paths(const float* flat, const int64_t* lengths, int64_t n,
                int64_t max_len, int64_t dim, float* out, float* mask) {
    int64_t offset = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = std::min(lengths[i], max_len);
        std::memcpy(out + (i * max_len) * dim, flat + offset * dim,
                    sizeof(float) * len * dim);
        float* m = mask + i * max_len;
        for (int64_t t = 0; t < len; ++t) m[t] = 1.0f;
        offset += lengths[i];
    }
}

// Reverse discounted cumulative sums over a ragged batch, in double.
//  x:       (sum_i len_i,) concatenated per-step values
//  lengths: (n,)
//  gamma:   discount
//  out:     (sum_i len_i,) outputs, same ragged layout
void discount_sums(const double* x, const int64_t* lengths, int64_t n,
                   double gamma, double* out) {
    int64_t offset = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = lengths[i];
        double run = 0.0;
        for (int64_t t = len - 1; t >= 0; --t) {
            run = x[offset + t] + gamma * run;
            out[offset + t] = run;
        }
        offset += len;
    }
}

// GAE advantages over a ragged batch.
//  rewards, values: (sum_i len_i,)
//  terminated: (n,) 1 if the episode genuinely ended (bootstrap 0),
//              else bootstrap with values[len-1]
void gae_advantages(const double* rewards, const double* values,
                    const int64_t* lengths, const uint8_t* terminated,
                    int64_t n, double gamma, double lam, double* out) {
    int64_t offset = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = lengths[i];
        const double bootstrap = (terminated[i] || len == 0)
                                     ? 0.0 : values[offset + len - 1];
        double run = 0.0;
        for (int64_t t = len - 1; t >= 0; --t) {
            const double v_next = (t + 1 < len) ? values[offset + t + 1]
                                                : bootstrap;
            const double delta = rewards[offset + t] + gamma * v_next
                                 - values[offset + t];
            run = delta + gamma * lam * run;
            out[offset + t] = run;
        }
        offset += len;
    }
}

}  // extern "C"
