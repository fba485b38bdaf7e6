// Host kernels of the classical classifier bench (pcgmix_tpu_torch/
// classical/estimators.py): the tree grower of the decision tree, the
// random forest and gradient boosting, the per-sample SGD of the log-loss
// classifier, the SMO solver of the RBF support-vector classifier with its
// Platt scaling, and the half-binomial loss and gradient.
//
// Each follows the arithmetic of scikit-learn 1.9.0 step for step, so that
// the same inputs and seeds give the same trees, weights and support
// vectors:
//
//  - trees: tree/_splitter.pyx (node_split_best: the Fisher-Yates feature
//    draw over rand_r with the constant-feature bookkeeping, the
//    FEATURE_THRESHOLD step rule in float32, the sum-of-halves threshold),
//    tree/_partitioner.pyx (the 3-way introsort of utils/_sorting.pyx and
//    the final partition), tree/_criterion.pyx (Gini and squared error,
//    with the forward or backward update of the running sums) and
//    tree/_tree.pyx (nodes grown depth first, left child before right);
//  - SGD: linear_model/_sgd_fast.pyx.tp (_plain_sgd with the "optimal"
//    schedule, the scaled weight vector of utils/_weight_vector.pyx.tp and
//    the Fisher-Yates shuffle of utils/_seq_dataset.pyx.tp);
//  - SVC: the C-SVC of svm/src/libsvm (second-order working-set selection,
//    shrinking, the float32 kernel column, the 5-fold Platt scaling on a
//    permutation drawn by std::mt19937 with Lemire's bounded draw, and the
//    pairwise-coupling probability).  The dot products go through the BLAS
//    ddot that the caller passes (scipy's, the one scikit-learn calls).
//
// Built with -ffp-contract=off: no fused multiply-adds, as in the reference
// build.  Exposed with C linkage for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

const double kEps = 2.220446049250313e-16;  // np.finfo(np.float64).eps
const float kFeatureThreshold = 1e-7f;
const int64_t kLeaf = -1;
const int64_t kUndefined = -2;
// the bench's trees take scikit-learn's defaults for these
const int64_t kMinSamplesSplit = 2;
const int64_t kMinSamplesLeaf = 1;
const double kMinWeightLeaf = 0.0;
const double kMinImpurityDecrease = 0.0;

// ------------------------------------------------------------------------
// rand_r of sklearn/utils/_random.pxd
// ------------------------------------------------------------------------

inline uint32_t rand_r32(uint32_t* seed) {
    if (*seed == 0) *seed = 1;
    *seed ^= static_cast<uint32_t>(*seed << 13);
    *seed ^= static_cast<uint32_t>(*seed >> 17);
    *seed ^= static_cast<uint32_t>(*seed << 5);
    return *seed % (static_cast<uint32_t>(0x7FFFFFFF) + 1u);
}

inline int64_t rand_int(int64_t low, int64_t high, uint32_t* seed) {
    return low + static_cast<int64_t>(rand_r32(seed)) % (high - low);
}

// ------------------------------------------------------------------------
// simultaneous sort of float32 values and sample indices: introsort with a
// median-of-3 pivot and a 3-way partition, heapsort past the depth limit,
// insertion sort below 16 elements
// ------------------------------------------------------------------------

inline void swap_pair(float* v, int64_t* s, int64_t i, int64_t j) {
    std::swap(v[i], v[j]);
    std::swap(s[i], s[j]);
}

inline float median3(const float* v, int64_t n) {
    float a = v[0], b = v[n / 2], c = v[n - 1];
    if (a < b) {
        if (b < c) return b;
        if (a < c) return c;
        return a;
    }
    if (b < c) {
        if (a < c) return a;
        return c;
    }
    return b;
}

void insertion_sort(float* v, int64_t* s, int64_t n) {
    for (int64_t i = 1; i < n; ++i) {
        float tv = v[i];
        int64_t ti = s[i];
        int64_t j = i;
        while (j > 0 && v[j - 1] > tv) {
            v[j] = v[j - 1];
            s[j] = s[j - 1];
            --j;
        }
        v[j] = tv;
        s[j] = ti;
    }
}

void sift_down(float* v, int64_t* s, int64_t start, int64_t end) {
    int64_t root = start;
    while (true) {
        int64_t child = root * 2 + 1, maxind = root;
        if (child < end && v[maxind] < v[child]) maxind = child;
        if (child + 1 < end && v[maxind] < v[child + 1]) maxind = child + 1;
        if (maxind == root) return;
        swap_pair(v, s, root, maxind);
        root = maxind;
    }
}

void heap_sort(float* v, int64_t* s, int64_t n) {
    int64_t start = (n - 2) / 2, end = n;
    while (true) {
        sift_down(v, s, start, end);
        if (start == 0) break;
        --start;
    }
    for (end = n - 1; end > 0; --end) {
        swap_pair(v, s, 0, end);
        sift_down(v, s, 0, end);
    }
}

void introsort_3way(float* v, int64_t* s, int64_t n, int64_t maxd) {
    while (n > 15) {
        if (maxd <= 0) {
            heap_sort(v, s, n);
            return;
        }
        --maxd;
        float pivot = median3(v, n);
        int64_t i = 0, l = 0, r = n;
        while (i < r) {
            if (v[i] < pivot) {
                swap_pair(v, s, i, l);
                ++i;
                ++l;
            } else if (v[i] > pivot) {
                --r;
                swap_pair(v, s, i, r);
            } else {
                ++i;
            }
        }
        introsort_3way(v, s, l, maxd);
        v += r;
        s += r;
        n -= r;
    }
    insertion_sort(v, s, n);
}

void sort_values(float* v, int64_t* s, int64_t n) {
    if (n == 0) return;
    introsort_3way(v, s, n, 2 * static_cast<int64_t>(std::log2(static_cast<double>(n))));
}

// ------------------------------------------------------------------------
// the tree grower
// ------------------------------------------------------------------------

struct Split {
    int64_t feature = 0, pos = 0;
    double threshold = 0.0, improvement = -HUGE_VAL;
    double impurity_left = HUGE_VAL, impurity_right = HUGE_VAL;
};

struct Grower {
    // inputs
    const float* X;
    int64_t n_features;
    const double* y;
    const double* sw;  // nullptr: unit weights
    int64_t n_classes;  // 0: squared error (regression), else Gini
    int64_t max_features;
    uint32_t rand_state;
    // splitter state
    std::vector<int64_t> samples, features, constant_features;
    std::vector<float> fv;
    int64_t n_samples = 0;
    double weighted_n_samples = 0.0;
    // criterion state
    int64_t start = 0, end = 0, pos = 0;
    double wnn = 0.0, wl = 0.0, wr = 0.0, sq_sum_total = 0.0;
    std::vector<double> sum_total, sum_left, sum_right;

    double weight(int64_t i) const { return sw ? sw[i] : 1.0; }
    int64_t width() const { return n_classes > 0 ? n_classes : 1; }

    void init_samples(int64_t n_rows) {
        samples.resize(n_rows);
        int64_t j = 0;
        weighted_n_samples = 0.0;
        for (int64_t i = 0; i < n_rows; ++i) {
            if (!sw || sw[i] != 0.0) samples[j++] = i;
            weighted_n_samples += sw ? sw[i] : 1.0;
        }
        n_samples = j;
        features.resize(n_features);
        for (int64_t f = 0; f < n_features; ++f) features[f] = f;
        constant_features.assign(n_features, 0);
        fv.assign(n_rows, 0.0f);
        sum_total.assign(width(), 0.0);
        sum_left.assign(width(), 0.0);
        sum_right.assign(width(), 0.0);
    }

    // ---- criterion
    void crit_reset() {
        pos = start;
        std::fill(sum_left.begin(), sum_left.end(), 0.0);
        sum_right = sum_total;
        wl = 0.0;
        wr = wnn;
    }

    void crit_reverse_reset() {
        pos = end;
        std::fill(sum_right.begin(), sum_right.end(), 0.0);
        sum_left = sum_total;
        wr = 0.0;
        wl = wnn;
    }

    void crit_init(int64_t s, int64_t e) {
        start = s;
        end = e;
        wnn = 0.0;
        sq_sum_total = 0.0;
        std::fill(sum_total.begin(), sum_total.end(), 0.0);
        for (int64_t p = s; p < e; ++p) {
            int64_t i = samples[p];
            double w = weight(i);
            if (n_classes > 0) {
                sum_total[static_cast<int64_t>(y[i])] += w;
            } else {
                double wy = w * y[i];
                sum_total[0] += wy;
                sq_sum_total += wy * y[i];
            }
            wnn += w;
        }
        crit_reset();
    }

    void crit_update(int64_t new_pos) {
        if ((new_pos - pos) <= (end - new_pos)) {
            for (int64_t p = pos; p < new_pos; ++p) {
                int64_t i = samples[p];
                double w = weight(i);
                if (n_classes > 0)
                    sum_left[static_cast<int64_t>(y[i])] += w;
                else
                    sum_left[0] += w * y[i];
                wl += w;
            }
        } else {
            crit_reverse_reset();
            for (int64_t p = end - 1; p > new_pos - 1; --p) {
                int64_t i = samples[p];
                double w = weight(i);
                if (n_classes > 0)
                    sum_left[static_cast<int64_t>(y[i])] -= w;
                else
                    sum_left[0] -= w * y[i];
                wl -= w;
            }
        }
        wr = wnn - wl;
        for (int64_t c = 0; c < width(); ++c) sum_right[c] = sum_total[c] - sum_left[c];
        pos = new_pos;
    }

    double node_impurity() const {
        if (n_classes > 0) {
            double sq = 0.0;
            for (int64_t c = 0; c < n_classes; ++c) sq += sum_total[c] * sum_total[c];
            return (1.0 - sq / (wnn * wnn)) / 1.0;
        }
        double imp = sq_sum_total / wnn;
        double m = sum_total[0] / wnn;
        imp -= m * m;
        return imp / 1.0;
    }

    void children_impurity(double* il, double* ir) const {
        if (n_classes > 0) {
            double sl = 0.0, sr = 0.0;
            for (int64_t c = 0; c < n_classes; ++c) {
                sl += sum_left[c] * sum_left[c];
                sr += sum_right[c] * sum_right[c];
            }
            *il = (0.0 + (1.0 - sl / (wl * wl))) / 1.0;
            *ir = (0.0 + (1.0 - sr / (wr * wr))) / 1.0;
            return;
        }
        double sq_left = 0.0;
        for (int64_t p = start; p < pos; ++p) {
            int64_t i = samples[p];
            sq_left += weight(i) * y[i] * y[i];
        }
        double sq_right = sq_sum_total - sq_left;
        double l = sq_left / wl, r = sq_right / wr;
        double ml = sum_left[0] / wl, mr = sum_right[0] / wr;
        l -= ml * ml;
        r -= mr * mr;
        *il = l / 1.0;
        *ir = r / 1.0;
    }

    double proxy_improvement() const {
        if (n_classes > 0) {
            double il, ir;
            children_impurity(&il, &ir);
            return -wr * ir - wl * il;
        }
        double pl = 0.0 + sum_left[0] * sum_left[0];
        double pr = 0.0 + sum_right[0] * sum_right[0];
        return pl / wl + pr / wr;
    }

    double impurity_improvement(double parent, double il, double ir) const {
        return (wnn / weighted_n_samples) * (parent - (wr / wnn * ir) - (wl / wnn * il));
    }

    // ---- splitter
    void sort_feature(int64_t f) {
        for (int64_t i = start; i < end; ++i) fv[i] = X[samples[i] * n_features + f];
        sort_values(&fv[start], &samples[start], end - start);
    }

    void next_p(int64_t* p_prev, int64_t* p) const {
        *p += 1;
        while (*p < end && fv[*p] <= fv[*p - 1] + kFeatureThreshold) *p += 1;
        *p_prev = *p - 1;
    }

    void partition_final(const Split& best) {
        int64_t ps = start, pe = end;
        while (ps < pe) {
            double v = X[samples[ps] * n_features + best.feature];
            if (v <= best.threshold) {
                ++ps;
            } else {
                --pe;
                std::swap(samples[ps], samples[pe]);
            }
        }
    }

    // node_split_best; n_constant in/out
    Split node_split(double impurity, int64_t* n_constant) {
        Split best;
        best.pos = end;
        Split cur;
        double best_proxy = -HUGE_VAL;
        int64_t f_i = n_features, n_visited = 0, n_found = 0, n_drawn = 0;
        const int64_t n_known = *n_constant;
        int64_t n_total = n_known;
        while (f_i > n_total && (n_visited < max_features || n_visited <= n_found + n_drawn)) {
            ++n_visited;
            int64_t f_j = rand_int(n_drawn, f_i - n_found, &rand_state);
            if (f_j < n_known) {
                std::swap(features[n_drawn], features[f_j]);
                ++n_drawn;
                continue;
            }
            f_j += n_found;
            cur.feature = features[f_j];
            sort_feature(cur.feature);
            if (end == start || fv[end - 1] <= fv[start] + kFeatureThreshold) {
                std::swap(features[f_j], features[n_total]);
                ++n_found;
                ++n_total;
                continue;
            }
            --f_i;
            std::swap(features[f_i], features[f_j]);
            crit_reset();
            int64_t p = start, p_prev = start;
            while (p < end) {
                next_p(&p_prev, &p);
                if (p == end) continue;
                if (p - start < kMinSamplesLeaf || end - p < kMinSamplesLeaf) continue;
                cur.pos = p;
                crit_update(p);
                if (wl < kMinWeightLeaf || wr < kMinWeightLeaf) continue;
                double proxy = proxy_improvement();
                if (proxy > best_proxy) {
                    best_proxy = proxy;
                    cur.threshold = static_cast<double>(fv[p_prev]) / 2.0 +
                                    static_cast<double>(fv[p]) / 2.0;
                    best = cur;
                }
            }
        }
        if (best.pos < end) {
            partition_final(best);
            crit_reset();
            crit_update(best.pos);
            children_impurity(&best.impurity_left, &best.impurity_right);
            best.improvement = impurity_improvement(impurity, best.impurity_left,
                                                    best.impurity_right);
        }
        std::memcpy(features.data(), constant_features.data(), sizeof(int64_t) * n_known);
        std::memcpy(constant_features.data() + n_known, features.data() + n_known,
                    sizeof(int64_t) * n_found);
        *n_constant = n_total;
        return best;
    }
};

struct StackRecord {
    int64_t start, end, depth, parent;
    bool is_left;
    double impurity;
    int64_t n_constant;
};

}  // namespace

extern "C" {

// Grows one tree on float32 rows X (n_rows x n_features, C order) and
// targets y (class indices as doubles when n_classes > 0: Gini; else
// squared error), sample weights sw (NULL: all 1; rows of weight 0 are left
// out), depth first, to max_depth.  Node arrays are written up to
// `capacity` nodes; value holds max(n_classes, 1) doubles a node (class
// fractions, or the mean).  Returns the node count, or -1 past the
// capacity.
int64_t pcg_tree_grow(const float* X, int64_t n_rows, int64_t n_features, const double* y,
                      const double* sw, int64_t n_classes, int64_t max_features,
                      int64_t max_depth, uint32_t seed, int64_t capacity, int64_t* left,
                      int64_t* right, int64_t* feature, double* threshold, double* value) {
    Grower g;
    g.X = X;
    g.n_features = n_features;
    g.y = y;
    g.sw = sw;
    g.n_classes = n_classes;
    g.max_features = max_features;
    g.rand_state = seed;
    g.init_samples(n_rows);
    const int64_t width = g.width();

    std::vector<StackRecord> stack;
    stack.push_back({0, g.n_samples, 0, kUndefined, false, HUGE_VAL, 0});
    int64_t count = 0;
    bool first = true;
    while (!stack.empty()) {
        StackRecord rec = stack.back();
        stack.pop_back();
        int64_t n_node = rec.end - rec.start;
        g.crit_init(rec.start, rec.end);
        double wn = g.wnn;
        bool is_leaf = rec.depth >= max_depth || n_node < kMinSamplesSplit ||
                       n_node < 2 * kMinSamplesLeaf || wn < 2 * kMinWeightLeaf;
        double imp = rec.impurity;
        int64_t n_constant = rec.n_constant;
        if (first) {
            imp = g.node_impurity();
            first = false;
        }
        is_leaf = is_leaf || imp <= kEps;
        Split split;
        if (!is_leaf) {
            split = g.node_split(imp, &n_constant);
            is_leaf = split.pos >= rec.end || split.improvement + kEps < kMinImpurityDecrease;
        }
        if (count >= capacity) return -1;
        int64_t id = count++;
        if (rec.parent != kUndefined) (rec.is_left ? left : right)[rec.parent] = id;
        left[id] = right[id] = kLeaf;
        feature[id] = is_leaf ? kUndefined : split.feature;
        threshold[id] = is_leaf ? static_cast<double>(kUndefined) : split.threshold;
        for (int64_t c = 0; c < width; ++c) value[id * width + c] = g.sum_total[c] / g.wnn;
        if (!is_leaf) {
            stack.push_back({split.pos, rec.end, rec.depth + 1, id, false, split.impurity_right,
                             n_constant});
            stack.push_back({rec.start, split.pos, rec.depth + 1, id, true, split.impurity_left,
                             n_constant});
        }
    }
    return count;
}

// The leaf of each row: left while X[row, feature] <= threshold.
void pcg_tree_apply(const float* X, int64_t n_rows, int64_t n_features, const int64_t* left,
                    const int64_t* right, const int64_t* feature, const double* threshold,
                    int64_t* out) {
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t node = 0;
        while (left[node] != kLeaf) {
            double v = X[i * n_features + feature[node]];
            node = v <= threshold[node] ? left[node] : right[node];
        }
        out[i] = node;
    }
}

}  // extern "C"

// ------------------------------------------------------------------------
// the half-binomial loss (sklearn/_loss/_loss.pyx.tp)
// ------------------------------------------------------------------------

namespace {

inline double log1pexp(double x) {
    if (x <= -37) return std::exp(x);
    if (x <= -2) return std::log1p(std::exp(x));
    if (x <= 18) return std::log(1. + std::exp(x));
    if (x <= 33.3) return x + std::exp(-x);
    return x;
}

inline double loss_half_binomial(double y, double raw) {
    return log1pexp(raw) - y * raw;
}

inline double gradient_half_binomial(double y, double raw) {
    if (raw > -37) {
        double e = std::exp(-raw);
        return ((1 - y) - y * e) / (1 + e);
    }
    return std::exp(raw) - y;
}

}  // namespace

extern "C" {

void pcg_half_binomial_gradient(const double* y, const double* raw, int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = gradient_half_binomial(y[i], raw[i]);
}

// loss and gradient together, with the branches of closs_grad_half_binomial
void pcg_half_binomial_loss_gradient(const double* y, const double* raw, int64_t n,
                                     double* loss, double* grad) {
    for (int64_t i = 0; i < n; ++i) {
        double r = raw[i], t = y[i], e;
        if (r <= -37) {
            e = std::exp(r);
            loss[i] = e - t * r;
            grad[i] = e - t;
        } else if (r <= -2) {
            e = std::exp(r);
            loss[i] = std::log1p(e) - t * r;
            grad[i] = ((1 - t) * e - t) / (1 + e);
        } else if (r <= 18) {
            e = std::exp(-r);
            loss[i] = std::log1p(e) + (1 - t) * r;
            grad[i] = ((1 - t) - t * e) / (1 + e);
        } else {
            e = std::exp(-r);
            loss[i] = e + (1 - t) * r;
            grad[i] = ((1 - t) - t * e) / (1 + e);
        }
    }
}

// ------------------------------------------------------------------------
// SGD with the log loss, L2 penalty, the "optimal" learning rate, shuffle,
// fit_intercept, no early stopping, unit sample and class weights
// ------------------------------------------------------------------------

// X: n x d float64 rows; y: 0/1.  Writes the d weights and the intercept;
// returns the epochs run, or -1 on a non-finite weight.
int64_t pcg_sgd_log_loss(const double* X, const double* y, int64_t n, int64_t d, double alpha,
                         int64_t max_iter, double tol, int64_t n_iter_no_change,
                         uint32_t seed, double* weights, double* intercept_out) {
    std::vector<double> w(d, 0.0);
    double wscale = 1.0, sq_norm = 0.0, l1_norm = 0.0, intercept = 0.0, t = 1.0;
    const double l1_ratio = 0.0;
    const double typw = std::sqrt(1.0 / std::sqrt(alpha));
    const double initial_eta0 = typw / std::max(1.0, gradient_half_binomial(1.0, -typw));
    const double optimal_init = 1.0 / (initial_eta0 * alpha);
    std::vector<int> index(n);
    for (int64_t i = 0; i < n; ++i) index[i] = static_cast<int>(i);
    int current = -1;
    const unsigned int train_count = static_cast<unsigned int>(n);
    double best_objective = HUGE_VAL;
    int no_improvement = 0;
    int64_t epoch = 0;
    for (epoch = 0; epoch < max_iter; ++epoch) {
        double objective_sum = 0.0;
        uint32_t s = seed;  // the same seed each epoch, on the current order
        for (unsigned i = 0; i < static_cast<unsigned>(n - 1); ++i) {
            unsigned j = i + rand_r32(&s) % (static_cast<unsigned>(n) - i);
            std::swap(index[i], index[j]);
        }
        for (int64_t k = 0; k < n; ++k) {
            current = current >= n - 1 ? 0 : current + 1;
            const double* x = X + static_cast<int64_t>(index[current]) * d;
            const double yi = y[index[current]];
            double inner = 0.0;
            for (int64_t j = 0; j < d; ++j) inner += w[j] * x[j];
            inner *= wscale;
            double p = inner + intercept;
            double eta = 1.0 / (alpha * (optimal_init + t - 1));
            objective_sum += loss_half_binomial(yi, p);
            double nrm = std::sqrt(sq_norm);
            objective_sum += alpha * ((1 - l1_ratio) * 0.5 * (nrm * nrm) + l1_ratio * l1_norm);
            double dloss = gradient_half_binomial(yi, p);
            if (dloss < -1e12)
                dloss = -1e12;
            else if (dloss > 1e12)
                dloss = 1e12;
            double update = -eta * dloss;
            update *= 1.0 * 1.0;
            // w.scale
            double c = std::max(0.0, 1.0 - ((1.0 - l1_ratio) * eta * alpha));
            wscale *= c;
            sq_norm *= (c * c);
            l1_norm *= std::fabs(c);
            if (wscale < 1e-9) {
                for (int64_t j = 0; j < d; ++j) w[j] *= wscale;
                wscale = 1.0;
            }
            if (update != 0.0) {  // w.add
                double l2 = 0.0, l1 = 0.0;
                for (int64_t j = 0; j < d; ++j) {
                    w[j] += x[j] * (update / wscale);
                    l2 += w[j] * w[j];
                    l1 += std::fabs(w[j]);
                }
                sq_norm = l2 * (wscale * wscale);
                l1_norm = l1 * wscale;
            }
            if (update != 0) intercept += update * 1.0;
            t += 1;
        }
        bool finite = std::isfinite(intercept);
        for (int64_t j = 0; j < d && finite; ++j) finite = std::isfinite(w[j]);
        if (!finite) return -1;
        if (objective_sum / train_count > best_objective - tol)
            ++no_improvement;
        else
            no_improvement = 0;
        if (objective_sum / train_count < best_objective)
            best_objective = objective_sum / train_count;
        if (no_improvement >= n_iter_no_change) break;
    }
    for (int64_t j = 0; j < d; ++j) weights[j] = w[j] * wscale;
    *intercept_out = intercept;
    return epoch + 1 > max_iter ? max_iter : epoch + 1;
}

}  // extern "C"

// ------------------------------------------------------------------------
// the RBF C-SVC with Platt scaling
// ------------------------------------------------------------------------

namespace {

typedef double (*ddot_t)(int*, double*, int*, double*, int*);

struct Svm {
    const double* X;  // n x d rows, scaled
    int64_t n, d;
    double gamma, eps;
    ddot_t ddot;
    std::vector<float> kf;  // float32 kernel of every row pair
    std::mt19937 rng;
    uint32_t seed;

    double dot(const double* a, const double* b) const {
        int m = static_cast<int>(d), one = 1;
        return ddot(&m, const_cast<double*>(a), &one, const_cast<double*>(b), &one);
    }

    void kernel_matrix() {
        std::vector<double> xsq(n);
        for (int64_t i = 0; i < n; ++i) xsq[i] = dot(X + i * d, X + i * d);
        kf.resize(n * n);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t j = 0; j <= i; ++j) {
                double k = std::exp(-gamma * (xsq[i] + xsq[j] - 2 * dot(X + i * d, X + j * d)));
                kf[i * n + j] = kf[j * n + i] = static_cast<float>(k);
            }
    }

    // exp(-gamma |x - sv|^2), the difference's squared norm by ddot
    double k_function(const double* x, const double* sv) const {
        std::vector<double> diff(d);
        for (int64_t i = 0; i < d; ++i) diff[i] = x[i] - sv[i];
        return std::exp(-gamma * dot(diff.data(), diff.data()));
    }

    uint32_t bounded(uint32_t range) {
        uint32_t x = rng();
        uint64_t m = uint64_t(x) * uint64_t(range);
        uint32_t l = uint32_t(m);
        if (l < range) {
            uint32_t t = -range;
            if (t >= range) {
                t -= range;
                if (t >= range) t %= range;
            }
            while (l < t) {
                x = rng();
                m = uint64_t(x) * uint64_t(range);
                l = uint32_t(m);
            }
        }
        return m >> 32;
    }
};

// The SMO solver over rows `rows` (data rows of X), labels ys (+1/-1),
// box bounds C; returns alpha (in problem order) and rho.
struct Solver {
    const Svm& svm;
    int64_t l, active_size;
    std::vector<int64_t> rows;  // data row at each position
    std::vector<signed char> y;
    std::vector<double> G, G_bar, alpha, p, C, QD;
    std::vector<int64_t> active_set;
    std::vector<char> status;  // 0 lower, 1 upper, 2 free
    std::vector<float> qi, qj;
    bool unshrink = false;

    Solver(const Svm& s, const std::vector<int64_t>& r, const std::vector<signed char>& ys,
           const std::vector<double>& cs)
        : svm(s), l(static_cast<int64_t>(r.size())), active_size(l), rows(r), y(ys),
          G(l), G_bar(l, 0.0), alpha(l, 0.0), p(l, -1.0), C(cs), QD(l), active_set(l),
          status(l), qi(l), qj(l) {
        for (int64_t i = 0; i < l; ++i) {
            active_set[i] = i;
            // the diagonal of the RBF kernel: exp(-gamma * 0)
            QD[i] = 1.0;
        }
    }

    // column i of Q over positions [0, len)
    void column(int64_t i, int64_t len, std::vector<float>& out) const {
        const float* kr = &svm.kf[rows[i] * svm.n];
        for (int64_t k = 0; k < len; ++k) {
            float v = kr[rows[k]];
            out[k] = (y[i] * y[k] > 0) ? v : -v;
        }
    }

    void update_status(int64_t i) {
        if (alpha[i] >= C[i])
            status[i] = 1;
        else if (alpha[i] <= 0)
            status[i] = 0;
        else
            status[i] = 2;
    }
    bool upper(int64_t i) const { return status[i] == 1; }
    bool lower(int64_t i) const { return status[i] == 0; }
    bool free_(int64_t i) const { return status[i] == 2; }

    void swap_index(int64_t i, int64_t j) {
        std::swap(rows[i], rows[j]);
        std::swap(y[i], y[j]);
        std::swap(G[i], G[j]);
        std::swap(status[i], status[j]);
        std::swap(alpha[i], alpha[j]);
        std::swap(p[i], p[j]);
        std::swap(active_set[i], active_set[j]);
        std::swap(G_bar[i], G_bar[j]);
        std::swap(C[i], C[j]);
        std::swap(QD[i], QD[j]);
    }

    void reconstruct_gradient() {
        if (active_size == l) return;
        int64_t nr_free = 0;
        for (int64_t j = active_size; j < l; ++j) G[j] = G_bar[j] + p[j];
        for (int64_t j = 0; j < active_size; ++j)
            if (free_(j)) ++nr_free;
        if (nr_free * l > 2 * active_size * (l - active_size)) {
            for (int64_t i = active_size; i < l; ++i) {
                column(i, active_size, qi);
                for (int64_t j = 0; j < active_size; ++j)
                    if (free_(j)) G[i] += alpha[j] * qi[j];
            }
        } else {
            for (int64_t i = 0; i < active_size; ++i)
                if (free_(i)) {
                    column(i, l, qi);
                    double a = alpha[i];
                    for (int64_t j = active_size; j < l; ++j) G[j] += a * qi[j];
                }
        }
    }

    int select_working_set(int64_t* out_i, int64_t* out_j) {
        double gmax = -HUGE_VAL, gmax2 = -HUGE_VAL, obj_diff_min = HUGE_VAL;
        int64_t gmax_idx = -1, gmin_idx = -1;
        for (int64_t t = 0; t < active_size; ++t) {
            if (y[t] == +1) {
                if (!upper(t) && -G[t] >= gmax) {
                    gmax = -G[t];
                    gmax_idx = t;
                }
            } else if (!lower(t) && G[t] >= gmax) {
                gmax = G[t];
                gmax_idx = t;
            }
        }
        int64_t i = gmax_idx;
        if (i != -1) column(i, active_size, qi);
        for (int64_t j = 0; j < active_size; ++j) {
            if (y[j] == +1) {
                if (!lower(j)) {
                    double grad_diff = gmax + G[j];
                    if (G[j] >= gmax2) gmax2 = G[j];
                    if (grad_diff > 0) {
                        double quad = QD[i] + QD[j] - 2.0 * y[i] * qi[j];
                        double obj = quad > 0 ? -(grad_diff * grad_diff) / quad
                                              : -(grad_diff * grad_diff) / 1e-12;
                        if (obj <= obj_diff_min) {
                            gmin_idx = j;
                            obj_diff_min = obj;
                        }
                    }
                }
            } else if (!upper(j)) {
                double grad_diff = gmax - G[j];
                if (-G[j] >= gmax2) gmax2 = -G[j];
                if (grad_diff > 0) {
                    double quad = QD[i] + QD[j] + 2.0 * y[i] * qi[j];
                    double obj = quad > 0 ? -(grad_diff * grad_diff) / quad
                                          : -(grad_diff * grad_diff) / 1e-12;
                    if (obj <= obj_diff_min) {
                        gmin_idx = j;
                        obj_diff_min = obj;
                    }
                }
            }
        }
        if (gmax + gmax2 < svm.eps || gmin_idx == -1) return 1;
        *out_i = gmax_idx;
        *out_j = gmin_idx;
        return 0;
    }

    bool be_shrunk(int64_t i, double gmax1, double gmax2) const {
        if (upper(i)) return y[i] == +1 ? -G[i] > gmax1 : -G[i] > gmax2;
        if (lower(i)) return y[i] == +1 ? G[i] > gmax2 : G[i] > gmax1;
        return false;
    }

    void do_shrinking() {
        double gmax1 = -HUGE_VAL, gmax2 = -HUGE_VAL;
        for (int64_t i = 0; i < active_size; ++i) {
            if (y[i] == +1) {
                if (!upper(i) && -G[i] >= gmax1) gmax1 = -G[i];
                if (!lower(i) && G[i] >= gmax2) gmax2 = G[i];
            } else {
                if (!upper(i) && -G[i] >= gmax2) gmax2 = -G[i];
                if (!lower(i) && G[i] >= gmax1) gmax1 = G[i];
            }
        }
        if (!unshrink && gmax1 + gmax2 <= svm.eps * 10) {
            unshrink = true;
            reconstruct_gradient();
            active_size = l;
        }
        for (int64_t i = 0; i < active_size; ++i)
            if (be_shrunk(i, gmax1, gmax2)) {
                --active_size;
                while (active_size > i) {
                    if (!be_shrunk(active_size, gmax1, gmax2)) {
                        swap_index(i, active_size);
                        break;
                    }
                    --active_size;
                }
            }
    }

    double calculate_rho() const {
        int64_t nr_free = 0;
        double ub = HUGE_VAL, lb = -HUGE_VAL, sum_free = 0;
        for (int64_t i = 0; i < active_size; ++i) {
            double yG = y[i] * G[i];
            if (upper(i)) {
                if (y[i] == -1)
                    ub = std::min(ub, yG);
                else
                    lb = std::max(lb, yG);
            } else if (lower(i)) {
                if (y[i] == +1)
                    ub = std::min(ub, yG);
                else
                    lb = std::max(lb, yG);
            } else {
                ++nr_free;
                sum_free += yG;
            }
        }
        return nr_free > 0 ? sum_free / nr_free : (ub + lb) / 2;
    }

    // alpha_out in the order of the rows given; returns rho
    double solve(std::vector<double>& alpha_out) {
        for (int64_t i = 0; i < l; ++i) {
            update_status(i);
            G[i] = p[i];
        }
        int64_t counter = std::min<int64_t>(l, 1000) + 1;
        while (true) {
            if (--counter == 0) {
                counter = std::min<int64_t>(l, 1000);
                do_shrinking();
            }
            int64_t i, j;
            if (select_working_set(&i, &j) != 0) {
                reconstruct_gradient();
                active_size = l;
                if (select_working_set(&i, &j) != 0) break;
                counter = 1;
            }
            column(i, active_size, qi);
            column(j, active_size, qj);
            double Ci = C[i], Cj = C[j];
            double old_ai = alpha[i], old_aj = alpha[j];
            if (y[i] != y[j]) {
                double quad = QD[i] + QD[j] + 2 * qi[j];
                if (quad <= 0) quad = 1e-12;
                double delta = (-G[i] - G[j]) / quad;
                double diff = alpha[i] - alpha[j];
                alpha[i] += delta;
                alpha[j] += delta;
                if (diff > 0) {
                    if (alpha[j] < 0) {
                        alpha[j] = 0;
                        alpha[i] = diff;
                    }
                } else if (alpha[i] < 0) {
                    alpha[i] = 0;
                    alpha[j] = -diff;
                }
                if (diff > Ci - Cj) {
                    if (alpha[i] > Ci) {
                        alpha[i] = Ci;
                        alpha[j] = Ci - diff;
                    }
                } else if (alpha[j] > Cj) {
                    alpha[j] = Cj;
                    alpha[i] = Cj + diff;
                }
            } else {
                double quad = QD[i] + QD[j] - 2 * qi[j];
                if (quad <= 0) quad = 1e-12;
                double delta = (G[i] - G[j]) / quad;
                double sum = alpha[i] + alpha[j];
                alpha[i] -= delta;
                alpha[j] += delta;
                if (sum > Ci) {
                    if (alpha[i] > Ci) {
                        alpha[i] = Ci;
                        alpha[j] = sum - Ci;
                    }
                } else if (alpha[j] < 0) {
                    alpha[j] = 0;
                    alpha[i] = sum;
                }
                if (sum > Cj) {
                    if (alpha[j] > Cj) {
                        alpha[j] = Cj;
                        alpha[i] = sum - Cj;
                    }
                } else if (alpha[i] < 0) {
                    alpha[i] = 0;
                    alpha[j] = sum;
                }
            }
            double dai = alpha[i] - old_ai, daj = alpha[j] - old_aj;
            for (int64_t k = 0; k < active_size; ++k) G[k] += qi[k] * dai + qj[k] * daj;
            bool ui = upper(i), uj = upper(j);
            update_status(i);
            update_status(j);
            if (ui != upper(i)) {
                column(i, l, qi);
                if (ui)
                    for (int64_t k = 0; k < l; ++k) G_bar[k] -= Ci * qi[k];
                else
                    for (int64_t k = 0; k < l; ++k) G_bar[k] += Ci * qi[k];
            }
            if (uj != upper(j)) {
                column(j, l, qj);
                if (uj)
                    for (int64_t k = 0; k < l; ++k) G_bar[k] -= Cj * qj[k];
                else
                    for (int64_t k = 0; k < l; ++k) G_bar[k] += Cj * qj[k];
            }
        }
        double rho = calculate_rho();
        alpha_out.assign(l, 0.0);
        for (int64_t i = 0; i < l; ++i) alpha_out[active_set[i]] = alpha[i];
        return rho;
    }
};

struct Model {
    int label[2];
    std::vector<int64_t> sv;  // data rows
    std::vector<double> coef;
    double rho = 0.0, probA = 0.0, probB = 0.0;
};

double decision(const Svm& svm, const Model& m, const double* x) {
    std::vector<double> kv(m.sv.size());
    for (size_t k = 0; k < m.sv.size(); ++k) kv[k] = svm.k_function(x, svm.X + m.sv[k] * svm.d);
    double sum = 0;
    for (size_t k = 0; k < m.sv.size(); ++k) sum += m.coef[k] * kv[k];
    return sum - m.rho;
}

void sigmoid_train(int64_t l, const std::vector<double>& dec, const std::vector<double>& labels,
                   double* A_out, double* B_out) {
    double prior1 = 0, prior0 = 0;
    for (int64_t i = 0; i < l; ++i) {
        if (labels[i] > 0)
            prior1 += 1;
        else
            prior0 += 1;
    }
    const int max_iter = 100;
    const double min_step = 1e-10, sigma = 1e-12, eps = 1e-5;
    double hi = (prior1 + 1.0) / (prior1 + 2.0), lo = 1 / (prior0 + 2.0);
    std::vector<double> t(l);
    double A = 0.0, B = std::log((prior0 + 1.0) / (prior1 + 1.0)), fval = 0.0;
    for (int64_t i = 0; i < l; ++i) {
        t[i] = labels[i] > 0 ? hi : lo;
        double f = dec[i] * A + B;
        fval += f >= 0 ? t[i] * f + std::log(1 + std::exp(-f))
                       : (t[i] - 1) * f + std::log(1 + std::exp(f));
    }
    for (int iter = 0; iter < max_iter; ++iter) {
        double h11 = sigma, h22 = sigma, h21 = 0.0, g1 = 0.0, g2 = 0.0;
        for (int64_t i = 0; i < l; ++i) {
            double f = dec[i] * A + B, p, q;
            if (f >= 0) {
                p = std::exp(-f) / (1.0 + std::exp(-f));
                q = 1.0 / (1.0 + std::exp(-f));
            } else {
                p = 1.0 / (1.0 + std::exp(f));
                q = std::exp(f) / (1.0 + std::exp(f));
            }
            double d2 = p * q;
            h11 += dec[i] * dec[i] * d2;
            h22 += d2;
            h21 += dec[i] * d2;
            double d1 = t[i] - p;
            g1 += dec[i] * d1;
            g2 += d1;
        }
        if (std::fabs(g1) < eps && std::fabs(g2) < eps) break;
        double det = h11 * h22 - h21 * h21;
        double dA = -(h22 * g1 - h21 * g2) / det;
        double dB = -(-h21 * g1 + h11 * g2) / det;
        double gd = g1 * dA + g2 * dB;
        double step = 1;
        while (step >= min_step) {
            double nA = A + step * dA, nB = B + step * dB, nf = 0.0;
            for (int64_t i = 0; i < l; ++i) {
                double f = dec[i] * nA + nB;
                nf += f >= 0 ? t[i] * f + std::log(1 + std::exp(-f))
                             : (t[i] - 1) * f + std::log(1 + std::exp(f));
            }
            if (nf < fval + 0.0001 * step * gd) {
                A = nA;
                B = nB;
                fval = nf;
                break;
            }
            step = step / 2.0;
        }
        if (step < min_step) break;
    }
    *A_out = A;
    *B_out = B;
}

// per-label multipliers of C (libsvm's weight_label / weight)
struct Weights {
    int label[2];
    double weight[2];
};

Model train(Svm& svm, const std::vector<int64_t>& rows, const std::vector<double>& labels,
            double C, const Weights& weights, bool probability);

// 5-fold decision values on a permutation, then the sigmoid's A and B
void binary_probability(Svm& svm, const std::vector<int64_t>& rows,
                        const std::vector<double>& ys, double Cp, double Cn, double* A,
                        double* B) {
    int64_t l = static_cast<int64_t>(rows.size());
    std::vector<int64_t> perm(l);
    std::vector<double> dec(l);
    for (int64_t i = 0; i < l; ++i) perm[i] = i;
    for (int64_t i = 0; i < l; ++i) {
        int64_t j = i + svm.bounded(static_cast<uint32_t>(l - i));
        std::swap(perm[i], perm[j]);
    }
    for (int i = 0; i < 5; ++i) {
        int64_t begin = i * l / 5, end = (i + 1) * l / 5;
        std::vector<int64_t> sub_rows;
        std::vector<double> sub_y;
        for (int64_t j = 0; j < l; ++j) {
            if (j >= begin && j < end) continue;
            sub_rows.push_back(rows[perm[j]]);
            sub_y.push_back(ys[perm[j]]);
        }
        int64_t pc = 0, nc = 0;
        for (double v : sub_y) (v > 0 ? pc : nc) += 1;
        if (pc == 0 && nc == 0) {
            for (int64_t j = begin; j < end; ++j) dec[perm[j]] = 0;
        } else if (pc > 0 && nc == 0) {
            for (int64_t j = begin; j < end; ++j) dec[perm[j]] = 1;
        } else if (pc == 0 && nc > 0) {
            for (int64_t j = begin; j < end; ++j) dec[perm[j]] = -1;
        } else {
            Model sub = train(svm, sub_rows, sub_y, 1.0, Weights{{+1, -1}, {Cp, Cn}}, false);
            for (int64_t j = begin; j < end; ++j) {
                dec[perm[j]] = decision(svm, sub, svm.X + rows[perm[j]] * svm.d);
                dec[perm[j]] *= sub.label[0];
            }
        }
    }
    sigmoid_train(l, dec, ys, A, B);
}

// one binary problem: the two labels sorted, rows of the first labelled +1;
// label[0] is -999 when the labels are not two classes
Model train(Svm& svm, const std::vector<int64_t>& rows, const std::vector<double>& labels,
            double C, const Weights& weights, bool probability) {
    svm.rng.seed(svm.seed);
    Model m;
    std::vector<int> seen;
    for (double v : labels)
        if (std::find(seen.begin(), seen.end(), static_cast<int>(v)) == seen.end())
            seen.push_back(static_cast<int>(v));
    if (seen.size() != 2) {
        m.label[0] = -999;
        return m;
    }
    int lab[2] = {std::min(seen[0], seen[1]), std::max(seen[0], seen[1])};
    m.label[0] = lab[0];
    m.label[1] = lab[1];
    double wc[2] = {C, C};
    for (int w = 0; w < 2; ++w)
        for (int c = 0; c < 2; ++c)
            if (weights.label[w] == lab[c]) wc[c] *= weights.weight[w];
    std::vector<int64_t> grouped;
    std::vector<double> ys;
    for (int c = 0; c < 2; ++c)
        for (size_t i = 0; i < rows.size(); ++i)
            if (static_cast<int>(labels[i]) == lab[c]) {
                grouped.push_back(rows[i]);
                ys.push_back(c == 0 ? +1.0 : -1.0);
            }
    if (probability) binary_probability(svm, grouped, ys, wc[0], wc[1], &m.probA, &m.probB);
    std::vector<signed char> ysolve(grouped.size());
    std::vector<double> cs(grouped.size());
    for (size_t i = 0; i < grouped.size(); ++i) {
        ysolve[i] = ys[i] > 0 ? +1 : -1;
        cs[i] = 1.0 * (ys[i] > 0 ? wc[0] : wc[1]);
    }
    Solver solver(svm, grouped, ysolve, cs);
    std::vector<double> alpha;
    m.rho = solver.solve(alpha);
    for (size_t i = 0; i < grouped.size(); ++i) {
        double a = alpha[i] * ysolve[i];
        if (std::fabs(a) > 0) {
            m.sv.push_back(grouped[i]);
            m.coef.push_back(a);
        }
    }
    return m;
}

void multiclass_probability(int k, double** r, double* p) {
    int max_iter = std::max(100, k);
    std::vector<std::vector<double>> Q(k, std::vector<double>(k));
    std::vector<double> Qp(k);
    double eps = 0.005 / k;
    for (int t = 0; t < k; ++t) {
        p[t] = 1.0 / k;
        Q[t][t] = 0;
        for (int j = 0; j < t; ++j) {
            Q[t][t] += r[j][t] * r[j][t];
            Q[t][j] = Q[j][t];
        }
        for (int j = t + 1; j < k; ++j) {
            Q[t][t] += r[j][t] * r[j][t];
            Q[t][j] = -r[j][t] * r[t][j];
        }
    }
    for (int iter = 0; iter < max_iter; ++iter) {
        double pQp = 0;
        for (int t = 0; t < k; ++t) {
            Qp[t] = 0;
            for (int j = 0; j < k; ++j) Qp[t] += Q[t][j] * p[j];
            pQp += p[t] * Qp[t];
        }
        double max_error = 0;
        for (int t = 0; t < k; ++t) max_error = std::max(max_error, std::fabs(Qp[t] - pQp));
        if (max_error < eps) break;
        for (int t = 0; t < k; ++t) {
            double diff = (-Qp[t] + pQp) / Q[t][t];
            p[t] += diff;
            pQp = (pQp + diff * (diff * Q[t][t] + 2 * Qp[t])) / (1 + diff) / (1 + diff);
            for (int j = 0; j < k; ++j) {
                Qp[j] = (Qp[j] + diff * Q[t][j]) / (1 + diff);
                p[j] /= (1 + diff);
            }
        }
    }
}

}  // namespace

extern "C" {

// Fits the RBF C-SVC with probability estimates on the scaled rows X
// (n x d) with labels y (0/1).  sv_out (n) receives the support rows (in
// libsvm's order: those of class 0 first), coef_out their dual
// coefficients; scalars: [rho, probA, probB].  Returns the number of
// support vectors, or -1 when y does not hold two classes.
int64_t pcg_svc_fit(const double* X, const double* y, int64_t n, int64_t d, double C,
                    double gamma, double eps, uint32_t seed, void* ddot, int64_t* sv_out,
                    double* coef_out, double* scalars) {
    Svm svm;
    svm.X = X;
    svm.n = n;
    svm.d = d;
    svm.gamma = gamma;
    svm.eps = eps;
    svm.ddot = reinterpret_cast<ddot_t>(ddot);
    svm.seed = seed;
    svm.kernel_matrix();
    std::vector<int64_t> rows(n);
    std::vector<double> labels(y, y + n);
    for (int64_t i = 0; i < n; ++i) rows[i] = i;
    Model model = train(svm, rows, labels, C, Weights{{0, 1}, {1.0, 1.0}}, true);
    if (model.label[0] == -999) return -1;
    for (size_t k = 0; k < model.sv.size(); ++k) {
        sv_out[k] = model.sv[k];
        coef_out[k] = model.coef[k];
    }
    scalars[0] = model.rho;
    scalars[1] = model.probA;
    scalars[2] = model.probB;
    return static_cast<int64_t>(model.sv.size());
}

// The fitted model (support rows SV, n_sv x d, their coefficients, rho,
// probA, probB) on the scaled rows T (m x d): dec (the decision value,
// > 0 for class 0) and prob (m x 2, the class probabilities).
void pcg_svc_predict(const double* SV, const double* coef, int64_t n_sv, int64_t d,
                     double rho, double probA, double probB, double gamma, void* ddot,
                     const double* T, int64_t m, double* dec, double* prob) {
    Svm svm;
    svm.X = SV;
    svm.n = n_sv;
    svm.d = d;
    svm.gamma = gamma;
    svm.ddot = reinterpret_cast<ddot_t>(ddot);
    Model model;
    model.label[0] = 0;
    model.label[1] = 1;
    for (int64_t k = 0; k < n_sv; ++k) {
        model.sv.push_back(k);
        model.coef.push_back(coef[k]);
    }
    model.rho = rho;
    const double min_prob = 1e-7;
    for (int64_t i = 0; i < m; ++i) {
        double dv = decision(svm, model, T + i * d);
        dec[i] = dv;
        double f = dv * probA + probB;
        double s = f >= 0 ? std::exp(-f) / (1.0 + std::exp(-f)) : 1.0 / (1 + std::exp(f));
        double r01 = std::min(std::max(s, min_prob), 1 - min_prob);
        double r0[2] = {0.0, r01}, r1[2] = {1 - r01, 0.0};
        double* r[2] = {r0, r1};
        multiclass_probability(2, r, prob + 2 * i);
    }
}

}  // extern "C"
