/* PHOC (pyramidal histogram of characters) featurizer.
 *
 * Native counterpart of mmf_tpu_torch/utils/phoc/build_phoc.py — converts a word
 * into the standard 604-dim PHOC vector used by M4C's OCR encoding:
 * 36 unigrams (a-z, 0-9) across pyramid levels 2..5 (14 regions * 36 = 504)
 * plus the 50 most frequent English bigrams at level 2 (100), following the
 * published PHOC construction (Almazan et al., TPAMI 2014; reference
 * mmf/utils/phoc/src/cphoc.c is the behavioral spec).
 *
 * Exposed as a plain C ABI for ctypes (no CPython API): thread-safe, no GIL
 * interaction, batch-friendly.
 */

#include <string.h>

#define PHOC_DIM 604

static const char UNIGRAMS[37] = "abcdefghijklmnopqrstuvwxyz0123456789";

static const char *BIGRAMS[50] = {
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el"};

static int unigram_index(char c) {
  const char *p = strchr(UNIGRAMS, c);
  if (!p || !c) return -1;
  return (int)(p - UNIGRAMS);
}

/* occupancy overlap >= 0.5 of the character span with a pyramid region */
static int occupies(float occ0, float occ1, int region, int level) {
  float r0 = (float)region / (float)level;
  float r1 = (float)(region + 1) / (float)level;
  float o0 = occ0 > r0 ? occ0 : r0;
  float o1 = occ1 < r1 ? occ1 : r1;
  return ((o1 - o0) / (occ1 - occ0)) >= 0.5f;
}

/* Returns 0 on success, -1 if the word contains a character outside the
 * unigram alphabet. out must hold PHOC_DIM floats. */
int phoc_build(const char *word, float *out) {
  memset(out, 0, PHOC_DIM * sizeof(float));
  int n = (int)strlen(word);
  if (n == 0) return 0;

  for (int i = 0; i < n; i++) {
    int ci = unigram_index(word[i]);
    if (ci < 0) return -1;
    float occ0 = (float)i / (float)n;
    float occ1 = (float)(i + 1) / (float)n;
    int level_offset = 0; /* cumulative regions of previous levels */
    for (int level = 2; level <= 5; level++) {
      for (int region = 0; region < level; region++) {
        if (occupies(occ0, occ1, region, level)) {
          out[(level_offset + region) * 36 + ci] = 1.0f;
        }
      }
      level_offset += level;
    }
  }

  const int bigram_offset = 36 * 14; /* 504 */
  for (int i = 0; i + 1 < n; i++) {
    int bi = -1;
    for (int k = 0; k < 50; k++) {
      if (word[i] == BIGRAMS[k][0] && word[i + 1] == BIGRAMS[k][1]) {
        bi = k;
        break;
      }
    }
    if (bi < 0) continue;
    float occ0 = (float)i / (float)n;
    float occ1 = (float)(i + 2) / (float)n;
    for (int region = 0; region < 2; region++) {
      if (occupies(occ0, occ1, region, 2)) {
        out[bigram_offset + region * 50 + bi] = 1.0f;
      }
    }
  }
  return 0;
}

/* Batch API: words packed as NUL-separated bytes; offsets[i] is the start
 * of word i. out is [count, PHOC_DIM]. Returns number of failed words. */
int phoc_build_batch(const char *packed, const int *offsets, int count,
                     float *out) {
  int failures = 0;
  for (int i = 0; i < count; i++) {
    if (phoc_build(packed + offsets[i], out + (long)i * PHOC_DIM) != 0) {
      failures++;
    }
  }
  return failures;
}
