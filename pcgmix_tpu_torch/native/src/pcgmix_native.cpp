// Native host-runtime kernels for pcgmix_tpu_torch (a copy of
// pcgmix_tpu/native/src/pcgmix_native.cpp; the port keeps its own).
//
// These C++ routines accelerate two O(N²) *host-side* hot spots:
//
//  - sample_entropy: the classical feature extractor's most expensive
//    feature (classical.py:984-989 via antropy) — O(N²) Chebyshev template
//    matching per heart-sound state, ~30 M ops per cycle in Python/NumPy;
//  - optimal displacement searches for the saliency-guided (salopt…)
//    augmentations (augmentations.py:60-128) — sliding-window scans per
//    segment per sample inside the training step.
//
// Exposed with C linkage for ctypes; built by pcgmix_tpu_torch/native/
// __init__.py (g++ -O3 -shared -fPIC) at first use.  There is no fallback:
// a failed build raises, and the NumPy scans beside the shim are the plain
// versions the tests hold this library to.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// antropy.sample_entropy semantics: order m (default 2), Chebyshev metric,
// tolerance r (0.2·std upstream).  Returns -log(A/B); NaN when A or B is 0.
double pcg_sample_entropy(const double* y, int64_t n, int64_t order, double r) {
    if (n <= order + 1) return NAN;
    const int64_t m = order;
    int64_t count_m = 0, count_m1 = 0;
    const int64_t n_templates = n - m;  // templates of length m (and m+1 fits
                                        // for i < n - m)
    for (int64_t i = 0; i < n_templates - 1; ++i) {
        for (int64_t j = i + 1; j < n_templates; ++j) {
            double d = 0.0;
            for (int64_t k = 0; k < m; ++k) {
                d = std::max(d, std::fabs(y[i + k] - y[j + k]));
            }
            if (d < r) {
                ++count_m;
                if (i + m < n && j + m < n) {
                    double d1 = std::max(d, std::fabs(y[i + m] - y[j + m]));
                    if (d1 < r) ++count_m1;
                }
            }
        }
    }
    if (count_m == 0 || count_m1 == 0) return NAN;
    return -std::log(static_cast<double>(count_m1) /
                     static_cast<double>(count_m));
}

// optimal_displacement_max_envelope (augmentations.py:60-93): place the
// shorter saliency window inside the longer one maximizing the summed
// elementwise max; the first strict maximum wins (reference tie-breaking).
// Totals are rounded to 12 decimals before comparison, matching the NumPy
// fallback (salopt.py np.round(..., 12)) so near-tie accumulation noise
// resolves to the same displacement with or without the native library.
static inline double round12(double x) {
    return std::nearbyint(x * 1e12) / 1e12;
}

int64_t pcg_opt_disp_env(const double* s_long, int64_t n_long,
                         const double* s_short, int64_t n_short) {
    double total_long = 0.0;
    for (int64_t t = 0; t < n_long; ++t) total_long += s_long[t];
    double best = -INFINITY;
    int64_t best_d = 0;
    for (int64_t d = 0; d + n_short <= n_long; ++d) {
        double s = total_long;
        for (int64_t k = 0; k < n_short; ++k) {
            double a = s_long[d + k], b = s_short[k];
            if (b > a) s += b - a;  // replace window values by the max
        }
        s = round12(s);
        if (s > best) {
            best = s;
            best_d = d;
        }
    }
    return best_d;
}

// optimal_displacement_max_sum, longer-first-argument case
// (augmentations.py:95-113): total = Σs1 − (1−λ)·window_sum(s1) + const
// ⇒ argmin of the window sums of the longer signal.
int64_t pcg_opt_disp_sum_longer(const double* s_long, int64_t n_long,
                                int64_t n_short) {
    double window = 0.0;
    for (int64_t k = 0; k < n_short; ++k) window += s_long[k];
    double best = round12(window);
    int64_t best_d = 0;
    for (int64_t d = 1; d + n_short <= n_long; ++d) {
        window += s_long[d + n_short - 1] - s_long[d - 1];
        double w = round12(window);
        if (w < best) {
            best = w;
            best_d = d;
        }
    }
    return best_d;
}

// shorter-first-argument case (augmentations.py:114-128): argmax of the
// window sums of the longer signal.
int64_t pcg_opt_disp_sum_shorter(const double* s_long, int64_t n_long,
                                 int64_t n_short) {
    double window = 0.0;
    for (int64_t k = 0; k < n_short; ++k) window += s_long[k];
    double best = window;
    int64_t best_d = 0;
    for (int64_t d = 1; d + n_short <= n_long; ++d) {
        window += s_long[d + n_short - 1] - s_long[d - 1];
        if (window > best) {
            best = window;
            best_d = d;
        }
    }
    return best_d;
}

}  // extern "C"
