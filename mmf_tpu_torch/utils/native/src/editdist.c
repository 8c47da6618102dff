/* Edit distance + ANLS kernels for answer evaluation.
 *
 * The ANLS metrics (TextVQA/ST-VQA family) compare every prediction
 * against up to 10 ground-truth answers with an O(n*m) DP per pair; at
 * dataset scale the python DP dominates eval wall-clock, so the inner
 * loops live here (ctypes ABI, no CPython API).
 */

#include <stddef.h>
#include <string.h>

#define MAX_LEN 511

static int min3(int a, int b, int c) {
    int m = a < b ? a : b;
    return m < c ? m : c;
}

/* classic two-row DP; lengths are clamped to MAX_LEN */
int edit_distance(const char *s1, const char *s2) {
    int row0[MAX_LEN + 1], row1[MAX_LEN + 1];
    size_t n1 = strlen(s1), n2 = strlen(s2);
    if (n1 > MAX_LEN) n1 = MAX_LEN;
    if (n2 > MAX_LEN) n2 = MAX_LEN;
    if (n2 == 0) return (int)n1;
    for (size_t j = 0; j <= n2; ++j) row0[j] = (int)j;
    for (size_t i = 0; i < n1; ++i) {
        row1[0] = (int)i + 1;
        for (size_t j = 0; j < n2; ++j) {
            row1[j + 1] = min3(row0[j + 1] + 1, row1[j] + 1,
                               row0[j] + (s1[i] != s2[j]));
        }
        memcpy(row0, row1, (n2 + 1) * sizeof(int));
    }
    return row0[n2];
}

/* max-over-gts ANLS for one prediction.
 * gts: packed NUL-terminated strings, offsets[i] indexes into the pack.
 * Returns the best 1 - dist/maxlen, thresholded at 0.5 (ANLS rule). */
double anls_best(const char *pred, const char *gts_packed,
                 const int *offsets, int n_gts) {
    double best = 0.0;
    size_t np = strlen(pred);
    for (int i = 0; i < n_gts; ++i) {
        const char *gt = gts_packed + offsets[i];
        size_t ng = strlen(gt);
        size_t mx = np > ng ? np : ng;
        if (mx == 0) continue;
        double sim = 1.0 - (double)edit_distance(pred, gt) / (double)mx;
        if (sim < 0.5) sim = 0.0;
        if (sim > best) best = sim;
    }
    return best;
}
