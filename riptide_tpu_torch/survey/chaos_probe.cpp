// The chaos campaign's cache probe: a tiny library built with g++ through
// the build cache (riptide_tpu_torch/utils/exec_cache.py), so that a
// `cache_corrupt` fault has a real stored library to corrupt, detect,
// evict and rebuild. y[i] = 2 x[i] + 1.
extern "C" void chaos_probe(const double* x, double* y, long n) {
    for (long i = 0; i < n; ++i) {
        y[i] = x[i] * 2.0 + 1.0;
    }
}
