// plancore: native host-side planning kernels for cfftpack_jax.
//
// Re-design of the reference's plan machinery — the
// factorization loop (factor_, cfftpack/fftpack.c:
// 6613-6657: radices 4,2,3,5 then ascending odd trial factors), the
// 5-smooth fast-size searches (cfftextra.c:20-82) and the twiddle/
// chirp table fills (tables_, fftpack.c:15124-15166) — exposed through
// a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// The Python layer has pure fallbacks; this library accelerates plan
// construction for large/batch planning workloads (e.g. sweeping
// thousands of candidate sizes) and is the seed of the native runtime
// layer.
//
// Build: python -m cfftpack_jax.native.build
#include <cmath>
#include <cstdint>

extern "C" {

// Greedy factorization into radices (4, 2, 3, 5, then odd primes).
// Returns the number of factors written, or -1 on error/overflow.
int cft_factor(long n, long *out, int cap) {
    if (n < 1 || cap < 1) return -1;
    int k = 0;
    while (n % 4 == 0) {
        if (k >= cap) return -1;
        out[k++] = 4;
        n /= 4;
    }
    static const long small[3] = {2, 3, 5};
    for (int i = 0; i < 3; i++) {
        while (n % small[i] == 0) {
            if (k >= cap) return -1;
            out[k++] = small[i];
            n /= small[i];
        }
    }
    long p = 7;
    while (n > 1) {
        while (n % p == 0) {
            if (k >= cap) return -1;
            out[k++] = p;
            n /= p;
        }
        p += 2;
        if (p * p > n && n > 1) {
            if (k >= cap) return -1;
            out[k++] = n;
            break;
        }
    }
    return k;
}

static int is_smooth(long n) {
    if (n < 1) return 0;
    while (n % 5 == 0) n /= 5;
    while (n % 3 == 0) n /= 3;
    while (n % 2 == 0) n /= 2;
    return n == 1;
}

// Next 5-smooth size >= n (clamped to >= 2 like the reference).
long cft_next_fast_size(long n) {
    if (n < 2) n = 2;
    while (!is_smooth(n)) n++;
    return n;
}

long cft_next_fast_even_size(long n) {
    if (n < 2) n = 2;
    if (n & 1) n++;
    while (!is_smooth(n)) n += 2;
    return n;
}

long cft_next_fast_size_2nm1(long n) {
    if (n < 2) n = 2;
    while (!is_smooth(2 * n - 1)) n++;
    return n;
}

long cft_next_fast_size_2np1(long n) {
    if (n < 1) n = 1;
    while (!is_smooth(2 * n + 1)) n++;
    return n;
}

// Largest prime factor (Bluestein dispatch predicate).
long cft_max_prime_factor(long n) {
    if (n <= 1) return 1;
    long best = 1;
    while (n % 2 == 0) { best = 2; n /= 2; }
    for (long p = 3; p * p <= n; p += 2) {
        while (n % p == 0) { best = p; n /= p; }
    }
    if (n > 1) best = n;
    return best;
}

// Stockham stage twiddles for length n: for each stage with radix p and
// remaining sub-length m, fills tw[k, j] = exp(-2i pi k j / m) of shape
// (p, m/p), concatenated over stages into (re, im) arrays.  Returns the
// total element count written, or -1 if cap is too small.
long cft_stage_twiddles(long n, double *re, double *im, long cap) {
    long fac[64];
    int nf = cft_factor(n, fac, 64);
    if (nf < 0) return -1;
    long m = n, w = 0;
    for (int s = 0; s < nf; s++) {
        long p = fac[s], mn = m / p;
        if (w + p * mn > cap) return -1;
        double ang = -2.0 * M_PI / (double)m;
        for (long k = 0; k < p; k++) {
            for (long j = 0; j < mn; j++) {
                // exact-angle reduction keeps large-n phases accurate
                long kj = (k * j) % m;
                double a = ang * (double)kj;
                re[w] = cos(a);
                im[w] = sin(a);
                w++;
            }
        }
        m = mn;
    }
    return w;
}

// Bluestein chirp: chirp[j] = exp(-i pi j^2 / n) with j^2 reduced
// mod 2n (the plan.py trick for exact angles at large n).
long cft_bluestein_chirp(long n, double *re, double *im) {
    if (n < 1) return -1;
    for (long j = 0; j < n; j++) {
        long jsq = ((j % (2 * n)) * (j % (2 * n))) % (2 * n);
        double a = -M_PI * (double)jsq / (double)n;
        re[j] = cos(a);
        im[j] = sin(a);
    }
    return n;
}

}  // extern "C"
