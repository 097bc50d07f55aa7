// hbrj_native — host-side native runtime for hwbloomradixjoin.
//
// Fast deterministic data generation with glibc-rand()-compatible streams
// (needed for bit-compatible Zipf / non-unique key populations: the reference
// generators draw from C rand(), so multiset-exact reproduction requires the
// identical PRNG sequence), plus scalar reference implementations of the join
// count and bloom filter used as ground truth by the test suite.
//
// Semantics mirrored from the reference (see docstrings in
// hwbloomradixjoin/data/generator.py for file:line citations); all code
// here is written fresh against those specs.
//
// Build: make -C native   ->  native/libhbrj_native.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <unordered_map>

// Runs body(i) for i in [0, n) on one contiguous range per hardware thread.
// Plain std::thread: it needs no OpenMP runtime, which not every g++
// installation ships.
template <class F>
static void parallel_for(int64_t n, F body) {
  int64_t nt = std::max<int64_t>(1, std::thread::hardware_concurrency());
  nt = std::min<int64_t>(nt, std::max<int64_t>(1, n / 65536));
  int64_t step = (n + nt - 1) / nt;
  std::vector<std::thread> threads;
  for (int64_t lo = 0; lo < n; lo += step) {
    int64_t hi = std::min(n, lo + step);
    threads.emplace_back([lo, hi, &body] {
      for (int64_t i = lo; i < hi; i++) body(i);
    });
  }
  for (auto& t : threads) t.join();
}

extern "C" {

// ---------------------------------------------------------------------------
// glibc-compatible rand(): TYPE_3 additive-feedback generator (degree 31,
// separation 3), the default for srand()/rand() in glibc.  State is 34 words;
// seeding uses the Park-Miller LCG via Schrage's method and discards the
// first 310 outputs.
// ---------------------------------------------------------------------------

typedef struct {
  int32_t r[344];
  int idx;  // next output index into r[] ring (34-entry window semantics)
} hbrj_rng_t;

static void rng_seed(hbrj_rng_t* g, uint32_t seed) {
  if (seed == 0) seed = 1;
  int32_t* r = g->r;
  r[0] = (int32_t)seed;
  for (int i = 1; i < 31; i++) {
    // r[i] = (16807 * r[i-1]) % 2147483647, overflow-free (Schrage)
    int64_t hi = r[i - 1] / 127773;
    int64_t lo = r[i - 1] % 127773;
    int64_t word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (int32_t)word;
  }
  for (int i = 31; i < 34; i++) r[i] = r[i - 31];
  for (int i = 34; i < 344; i++)
    r[i] = (int32_t)((uint32_t)r[i - 31] + (uint32_t)r[i - 3]);
  g->idx = 344 - 34;  // absolute position 310; next output is position 344
  // We keep a rolling window: copy last 34 values to the front of a ring.
  // Simpler: store absolute; regenerate on the fly in rng_next.
  // Here: maintain full history start; idx points at next write mod ring.
}

// Rolling ring of 34 values is enough: x[n] = x[n-31] + x[n-3].
typedef struct {
  uint32_t ring[34];
  int pos;  // index of next value to produce within ring (mod 34)
} hbrj_rand_t;

static void rand_seed(hbrj_rand_t* s, uint32_t seed) {
  hbrj_rng_t tmp;
  rng_seed(&tmp, seed);
  // positions 310..343 are the live window; next output = position 344
  for (int i = 0; i < 34; i++) s->ring[i] = (uint32_t)tmp.r[310 + i];
  s->pos = 0;
}

static inline int32_t rand_next(hbrj_rand_t* s) {
  // next = window[-31] + window[-3] where window end is current pos+34
  int i31 = s->pos + 3;   // (pos+34) - 31
  int i3 = s->pos + 31;   // (pos+34) - 3
  if (i31 >= 34) i31 -= 34;
  if (i3 >= 34) i3 -= 34;
  uint32_t v = s->ring[i31] + s->ring[i3];
  s->ring[s->pos] = v;
  s->pos = (s->pos + 1) % 34;
  return (int32_t)(v >> 1);
}

static hbrj_rand_t g_rand;

void hbrj_srand(uint32_t seed) { rand_seed(&g_rand, seed); }
int32_t hbrj_rand(void) { return rand_next(&g_rand); }

void hbrj_rand_stream(uint32_t seed, int64_t n, int32_t* out) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  for (int64_t i = 0; i < n; i++) out[i] = rand_next(&s);
}

// ---------------------------------------------------------------------------
// Zipf generator: random alphabet permutation of 1..N + CDF binary search,
// matching the ETH genzipf semantics (alphabet permutation consumes N-1
// rand() draws, then one draw per sample; CDF in double precision with
// ascending summation).
// ---------------------------------------------------------------------------

void hbrj_gen_zipf(uint32_t seed, int64_t stream_size, int64_t alphabet_size,
                   double zipf_factor, int32_t* out_keys) {
  hbrj_rand_t rs;
  rand_seed(&rs, seed);

  std::vector<uint32_t> alphabet((size_t)alphabet_size);
  for (int64_t i = 0; i < alphabet_size; i++) alphabet[i] = (uint32_t)(i + 1);
  for (int64_t i = alphabet_size - 1; i > 0; i--) {
    uint64_t k = (uint64_t)i * (uint64_t)rand_next(&rs) / 2147483647ULL;
    uint32_t t = alphabet[i];
    alphabet[i] = alphabet[k];
    alphabet[k] = t;
  }

  std::vector<double> lut((size_t)alphabet_size);
  double scale = 0.0;
  for (int64_t i = 1; i <= alphabet_size; i++) scale += 1.0 / pow((double)i, zipf_factor);
  double sum = 0.0;
  for (int64_t i = 1; i <= alphabet_size; i++) {
    sum += 1.0 / pow((double)i, zipf_factor);
    lut[i - 1] = sum / scale;
  }

  // rand() draws must be sequential; samples are then independent.
  std::vector<int32_t> draws((size_t)stream_size);
  for (int64_t i = 0; i < stream_size; i++) draws[i] = rand_next(&rs);

  parallel_for(stream_size, [&](int64_t i) {
    double r = ((double)draws[i]) / 2147483647.0;
    int64_t pos;
    if (lut[0] >= r) {
      pos = 0;
    } else {
      int64_t left = 0, right = alphabet_size - 1;
      while (right - left > 1) {
        int64_t m = (left + right) / 2;
        if (lut[m] < r) left = m; else right = m;
      }
      pos = right;
    }
    out_keys[i] = (int32_t)alphabet[pos];
  });
}

// ---------------------------------------------------------------------------
// Uniform / non-unique generators (double-arithmetic RAND_RANGE semantics:
// value = O + rand()/(RAND_MAX+1) * (N - O), truncated).
// ---------------------------------------------------------------------------

static inline int64_t rand_range(hbrj_rand_t* s, int64_t O, int64_t N) {
  return (int64_t)((double)O +
                   (double)rand_next(s) / 2147483648.0 * (double)(N - O));
}

// random_gen: keys uniform in [minid, maxid], payload = index.
void hbrj_random_gen(uint32_t seed, int64_t n, int64_t minid, int64_t maxid,
                     int32_t* out_keys) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  for (int64_t i = 0; i < n; i++)
    out_keys[i] = (int32_t)rand_range(&s, minid, maxid);
}

// Knuth shuffle of keys (payloads stay), reference knuth_shuffle semantics.
// Continues an existing stream: caller provides seed and a number of draws
// already consumed (skip) so composed generators stay aligned.
void hbrj_knuth_shuffle(uint32_t seed, int64_t skip, int64_t n, int32_t* keys) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  for (int64_t i = 0; i < skip; i++) (void)rand_next(&s);
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = rand_range(&s, 0, i);
    int32_t t = keys[i];
    keys[i] = keys[j];
    keys[j] = t;
  }
}

// create_relation_nonunique_from_pk: first ntuples_above keys uniform in
// (threshold, INT_MAX], then FK picks uniform from pkrel, then Knuth shuffle.
void hbrj_nonunique_from_pk(uint32_t seed, const int32_t* pk_keys,
                            int64_t n_pk, int64_t n, int64_t threshold,
                            double selectivity, int32_t* out_keys) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  int64_t ntuples_above = (int64_t)((double)n * (1.0 - selectivity));
  for (int64_t i = 0; i < ntuples_above; i++)
    out_keys[i] = (int32_t)rand_range(&s, threshold + 1, 2147483647LL);
  for (int64_t i = ntuples_above; i < n; i++) {
    int64_t j = rand_range(&s, 0, n_pk);
    out_keys[i] = pk_keys[j];
  }
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = rand_range(&s, 0, i);
    int32_t t = out_keys[i];
    out_keys[i] = out_keys[j];
    out_keys[j] = t;
  }
}

// create_relation_fk_from_pk (--full-range path): layout is
// [below: pk tuples tiled | above: uniform keys in (threshold, INT_MAX]],
// where the ABOVE part is generated first (consuming rand() draws), the below
// part copies pk tuples (keys AND payloads), and a final Knuth pass shuffles
// keys only, continuing the same rand() stream.
void hbrj_fk_from_pk(uint32_t seed, const int32_t* pk_keys,
                     const int32_t* pk_pays, int64_t n_pk, int64_t n,
                     int64_t threshold, double selectivity, int32_t* out_keys,
                     int32_t* out_pays) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  int64_t ntuples_above = (int64_t)((double)n * (1.0 - selectivity));
  int64_t ntuples_below = n - ntuples_above;
  for (int64_t i = 0; i < ntuples_above; i++) {
    out_keys[ntuples_below + i] = (int32_t)rand_range(&s, threshold + 1, 2147483647LL);
    out_pays[ntuples_below + i] = (int32_t)i;
  }
  for (int64_t i = 0; i < ntuples_below; i++) {
    out_keys[i] = pk_keys[i % n_pk];
    out_pays[i] = pk_pays[i % n_pk];
  }
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = rand_range(&s, 0, i);
    int32_t t = out_keys[i];
    out_keys[i] = out_keys[j];
    out_keys[j] = t;
  }
}

// ---------------------------------------------------------------------------
// Scalar ground-truth join: count + payload checksums over all key matches.
// ---------------------------------------------------------------------------

void hbrj_ref_join(const int32_t* r_keys, const int32_t* r_pay, int64_t n_r,
                   const int32_t* s_keys, const int32_t* s_pay, int64_t n_s,
                   uint64_t* out /* [count, sum_rpay, sum_spay] */) {
  std::unordered_map<int32_t, std::pair<uint64_t, uint64_t>> ht;  // key -> (count, sum_rpay)
  ht.reserve((size_t)n_r * 2);
  for (int64_t i = 0; i < n_r; i++) {
    auto& e = ht[r_keys[i]];
    e.first += 1;
    e.second += (uint32_t)(r_pay ? r_pay[i] : 0);
  }
  uint64_t cnt = 0, sr = 0, ss = 0;
  for (int64_t i = 0; i < n_s; i++) {
    auto it = ht.find(s_keys[i]);
    if (it != ht.end()) {
      cnt += it->second.first;
      sr += it->second.second;
      ss += it->second.first * (uint64_t)(uint32_t)(s_pay ? s_pay[i] : 0);
    }
  }
  out[0] = cnt;
  out[1] = sr;
  out[2] = ss;
}

// ---------------------------------------------------------------------------
// Scalar ground-truth bloom filter (basic + blocked, enhanced double
// hashing), matching the reference filter math exactly.
// ---------------------------------------------------------------------------

static inline uint32_t crc32c_u32(uint32_t crc, uint32_t v) {
  crc ^= v;
  for (int i = 0; i < 32; i++)
    crc = (crc >> 1) ^ (0x82F63B78u & (~((crc & 1u) - 1u)));
  return crc;
}

static inline uint32_t crapwow32(uint32_t seed, uint32_t key, uint32_t nbytes) {
  const uint32_t n = 0x5052ACDBu;
  uint32_t h = nbytes;
  uint32_t k = nbytes + seed + n;
  uint64_t p = (uint64_t)key * n;
  h ^= (uint32_t)p;
  k ^= (uint32_t)(p >> 32);
  p = (uint64_t)(h ^ (k + n)) * n;
  h ^= (uint32_t)p;
  k ^= (uint32_t)(p >> 32);
  return k ^ h;
}

// variant: 0=basic, 1=blocked
void hbrj_ref_bloom(int variant, uint64_t m, uint64_t k, uint64_t B,
                    uint32_t seed, const int32_t* add_keys, int64_t n_add,
                    const int32_t* query_keys, int64_t n_query,
                    uint8_t* out_contains, uint8_t* bitmap_out /* m/8 bytes, may be null */) {
  std::vector<uint8_t> bitmap((size_t)(m / 8), 0);
  uint64_t size = (variant == 0) ? m : B;
  uint64_t nblocks = (variant == 0) ? 1 : (m / B);

  for (int64_t i = 0; i < n_add; i++) {
    uint32_t key = (uint32_t)add_keys[i];
    uint64_t base = 0;
    if (variant == 1)
      base = (uint64_t)(crc32c_u32(seed, key) & (nblocks - 1)) * (B / 8);
    uint32_t h = crapwow32(seed, key, 4) & (uint32_t)(size - 1);
    uint32_t y = (key + seed) & (uint32_t)(size - 1);
    for (uint64_t j = 0; j < k; j++) {
      bitmap[base + (h >> 3)] |= (uint8_t)(1u << (h & 7));
      h = (h + y) & (uint32_t)(size - 1);
      y = (uint32_t)(y + j + 1) & (uint32_t)(size - 1);
    }
  }

  parallel_for(n_query, [&](int64_t i) {
    uint32_t key = (uint32_t)query_keys[i];
    uint64_t base = 0;
    if (variant == 1)
      base = (uint64_t)(crc32c_u32(seed, key) & (nblocks - 1)) * (B / 8);
    uint32_t h = crapwow32(seed, key, 4) & (uint32_t)(size - 1);
    uint32_t y = (key + seed) & (uint32_t)(size - 1);
    uint8_t ok = 1;
    for (uint64_t j = 0; j < k; j++) {
      if (!(bitmap[base + (h >> 3)] & (1u << (h & 7)))) { ok = 0; break; }
      h = (h + y) & (uint32_t)(size - 1);
      y = (uint32_t)(y + j + 1) & (uint32_t)(size - 1);
    }
    out_contains[i] = ok;
  });
  if (bitmap_out) memcpy(bitmap_out, bitmap.data(), (size_t)(m / 8));
}

// Knuth-sampling unique key generator in [min, max), as used by the FPR unit
// test (random_unique_gen_range, selection-sampling over the range).  The FPR
// wrapper generates R then S from one continuous rand() stream, so this takes
// a `skip` of already-consumed draws and returns the draws it consumed.
int64_t hbrj_unique_gen_range(uint32_t seed, int64_t skip, int64_t n,
                              int32_t minv, int32_t maxv, int32_t* out_keys) {
  hbrj_rand_t s;
  rand_seed(&s, seed);
  for (int64_t i = 0; i < skip; i++) (void)rand_next(&s);
  int64_t m_options = (int64_t)maxv - (int64_t)minv;
  int64_t inserted = 0;
  int64_t consumed = 0;
  for (int64_t i = 0; i < m_options && inserted < n; i++) {
    int64_t rn = n - inserted;
    int64_t rm = m_options - i;
    consumed++;
    if (rand_next(&s) % rm < rn) {
      out_keys[inserted] = (int32_t)(minv + i);
      inserted++;
    }
  }
  return consumed;
}

}  // extern "C"
