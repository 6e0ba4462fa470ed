// Sanitizer stress driver for the native feature pool (the port's own copy
// of maveric_slam_tpu/runtime/native/pool_stress.cc; ../pool.py builds it).
//
// Exercises the pool API (observe/remove_old/valid_keys/invariant/
// lcd_intersect) across thousands of frames with an adversarial id
// distribution (heavy hash collisions, near-capacity load, full age-out
// cycles) under ASan+UBSan. The reference's analogue is the randomized
// self-exercising driver src/local_feature_matching.c:129-173; this one
// is built with sanitizers (the reference build has none, CMakeLists.txt).
//
// Exit code 0 = all invariants held and no sanitizer report; any memory
// error aborts via -fno-sanitize-recover.

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {
void* pool_create(int capacity, int max_frames);
void pool_destroy(void* handle);
int pool_size(void* handle);
float pool_load_factor(void* handle);
int pool_observe(void* handle, int word_id, int frame_num);
int pool_observe_batch(void* handle, const int* word_ids, int n, int frame_num);
int pool_last_seen(void* handle, int word_id);
void pool_remove_old(void* handle, int current_frame);
int pool_valid_keys(void* handle, int* out, int max_out);
int pool_num_sightings(void* handle, int word_id);
int pool_check_invariant(void* handle, int current_frame);
int lcd_intersect(const int* a, int na, const int* b, int nb);
void lcd_intersect_batch(const int* frames, const int* frame_sizes,
                         int num_frames, int stride, const int* query, int nq,
                         int* out);
}

namespace {

uint32_t g_state = 0x2545F491u;
uint32_t next_rand() {  // xorshift32: deterministic across platforms
  uint32_t x = g_state;
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return g_state = x;
}

int fail(const char* what, int frame, int code) {
  std::fprintf(stderr, "FAIL %s at frame %d (code %d)\n", what, frame, code);
  return 1;
}

}  // namespace

int main() {
  // Small capacity + ids folded into a narrow range maximizes collisions,
  // probe-chain length, and backward-shift deletions.
  constexpr int kCapacity = 257;  // prime, so id%capacity spreads chains
  constexpr int kWindow = 8;
  constexpr int kFrames = 5000;
  constexpr int kPerFrame = 64;

  void* p = pool_create(kCapacity, kWindow);
  if (!p) return fail("pool_create", -1, 0);

  int ids[kPerFrame];
  int keys[kCapacity];
  for (int frame = 0; frame < kFrames; ++frame) {
    for (int k = 0; k < kPerFrame; ++k) {
      // Mix of persistent ids (seen most frames), drifting ids, and noise;
      // ~6% negative ids exercise the skip path.
      uint32_t r = next_rand();
      if (r % 16 == 0) {
        ids[k] = -1;
      } else if (r % 3 == 0) {
        ids[k] = static_cast<int>(r % 40);  // persistent cluster
      } else {
        ids[k] = static_cast<int>(frame / 4 + r % 150);  // drifting
      }
    }
    if (pool_observe_batch(p, ids, kPerFrame, frame) < 0)
      return fail("observe_batch overflow", frame, -1);
    pool_remove_old(p, frame);
    int code = pool_check_invariant(p, frame);
    if (code != 0) return fail("invariant", frame, code);

    int n = pool_valid_keys(p, keys, kCapacity);
    if (n != pool_size(p)) return fail("valid_keys count", frame, n);
    for (int k = 0; k < n; ++k) {
      if (pool_num_sightings(p, keys[k]) < 1)
        return fail("num_sightings", frame, keys[k]);
      int seen = pool_last_seen(p, keys[k]);
      if (seen < frame - kWindow + 1 || seen > frame)
        return fail("last_seen window", frame, seen);
    }
    // Misses must probe safely even through long clusters.
    if (pool_last_seen(p, 1 << 30) != -1) return fail("miss probe", frame, 0);
  }

  // Drive the pool to exactly full, then age everything out at once.
  {
    int frame = kFrames;
    pool_remove_old(p, frame);  // invariants are stated post-age-out
    for (int id = 1000000; pool_size(p) < kCapacity; ++id) {
      if (pool_observe(p, id, frame) < 0) break;
    }
    if (pool_size(p) != kCapacity) return fail("fill to capacity", frame, pool_size(p));
    // One more insert must report overflow, not corrupt memory.
    if (pool_observe(p, 2000000000, frame) != -1)
      return fail("overflow detection", frame, 0);
    if (pool_check_invariant(p, frame) != 0) return fail("full invariant", frame, 0);
    pool_remove_old(p, frame + kWindow + 1);
    if (pool_size(p) != 0) return fail("full age-out", frame, pool_size(p));
    if (pool_check_invariant(p, frame + kWindow + 1) != 0)
      return fail("empty invariant", frame, 0);
  }

  // lcd_intersect: edge cases + a batch sweep.
  {
    int a[8] = {1, 3, 5, 7, 9, 11, 13, 15};
    int b[8] = {0, 3, 4, 7, 8, 11, 12, 16};
    if (lcd_intersect(a, 8, b, 8) != 3) return fail("lcd_intersect", -1, 0);
    if (lcd_intersect(a, 0, b, 8) != 0) return fail("lcd empty a", -1, 0);
    if (lcd_intersect(a, 8, b, 0) != 0) return fail("lcd empty b", -1, 0);
    int frames[4 * 8];
    int sizes[4] = {8, 4, 0, 8};
    for (int f = 0; f < 4; ++f)
      for (int k = 0; k < 8; ++k) frames[f * 8 + k] = f + 2 * k;
    int out[4];
    lcd_intersect_batch(frames, sizes, 4, 8, a, 8, out);
    if (out[2] != 0) return fail("lcd batch empty row", -1, out[2]);
  }

  pool_destroy(p);
  std::printf("pool_stress: OK\n");
  return 0;
}
