// Native host-side runtime: local feature pool + merge-join scoring.
//
// C++ re-design of the reference's map bookkeeping (capability of
// include/local_feature_pool.h: open-addressing hash map keyed by visual
// word id, per-feature ring buffer of last-seen frames, age-out of stale
// features, invariant checking; and src/lcd_main.c:52-74's sorted-list
// intersection). Deletion uses backward-shift compaction, which preserves
// probe chains without the reference's full-table `chain_replacement` scan
// (O(capacity) per delete there; amortized O(cluster) here).
//
// The port's own copy of maveric_slam_tpu/runtime/native/feature_pool.cc.
// Exposed as a C ABI for ctypes (see ../pool.py). Single-threaded by
// design: one pool per tracker thread; the device-resident pool
// (mapping/feature_pool.py) is the device-side variant.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kEmpty = -1;

struct Feature {
  int32_t word_id = kEmpty;
  int32_t frame_ptr = 0;   // index of oldest entry in the ring
  int32_t num_frames = 0;  // live entries in the ring
  int32_t frames[16];      // ring buffer of last-seen frame numbers
  float x = 0.f, y = 0.f, z = 0.f;  // optional 3-D anchor
};

struct Pool {
  int32_t capacity = 0;
  int32_t max_frames = 0;  // ring size actually used (<= 16)
  int32_t size = 0;
  Feature* slots = nullptr;

  int hash(int32_t key) const { return static_cast<uint32_t>(key) % capacity; }
};

// Distance from a slot's home position to its current position (for
// backward-shift deletion).
inline int probe_distance(const Pool& p, int slot_index, int32_t key) {
  int home = p.hash(key);
  return (slot_index - home + p.capacity) % p.capacity;
}

void feature_touch(Feature& f, int32_t frame_num, int max_frames) {
  if (f.num_frames > 0) {
    int newest =
        f.frames[(f.frame_ptr + f.num_frames - 1) % max_frames];
    if (frame_num == newest) return;  // same frame: idempotent
  }
  if (f.num_frames < max_frames) {
    f.frames[(f.frame_ptr + f.num_frames) % max_frames] = frame_num;
    f.num_frames++;
  } else {
    f.frames[f.frame_ptr] = frame_num;
    f.frame_ptr = (f.frame_ptr + 1) % max_frames;
  }
}

}  // namespace

extern "C" {

void* pool_create(int capacity, int max_frames) {
  if (capacity <= 0 || max_frames <= 0 || max_frames > 16) return nullptr;
  Pool* p = new Pool();
  p->capacity = capacity;
  p->max_frames = max_frames;
  p->slots = new Feature[capacity];
  return p;
}

void pool_destroy(void* handle) {
  Pool* p = static_cast<Pool*>(handle);
  if (!p) return;
  delete[] p->slots;
  delete p;
}

int pool_size(void* handle) { return static_cast<Pool*>(handle)->size; }

float pool_load_factor(void* handle) {
  Pool* p = static_cast<Pool*>(handle);
  return static_cast<float>(p->size) / p->capacity;
}

// Insert a sighting of word_id at frame_num. Returns 1 if a new feature was
// created, 0 if an existing one was updated, -1 if the pool is full.
int pool_observe(void* handle, int word_id, int frame_num) {
  Pool* p = static_cast<Pool*>(handle);
  int idx = p->hash(word_id);
  for (int probes = 0; probes < p->capacity; ++probes) {
    Feature& f = p->slots[idx];
    if (f.word_id == word_id) {
      feature_touch(f, frame_num, p->max_frames);
      return 0;
    }
    if (f.word_id == kEmpty) {
      if (p->size >= p->capacity) return -1;
      f.word_id = word_id;
      f.frame_ptr = 0;
      f.num_frames = 1;
      f.frames[0] = frame_num;
      p->size++;
      return 1;
    }
    idx = (idx + 1) % p->capacity;
  }
  return -1;
}

// Batch observe: returns number of NEW features created, or -1 on overflow.
int pool_observe_batch(void* handle, const int* word_ids, int n,
                       int frame_num) {
  int created = 0;
  for (int i = 0; i < n; ++i) {
    if (word_ids[i] < 0) continue;
    int r = pool_observe(handle, word_ids[i], frame_num);
    if (r < 0) return -1;
    created += r;
  }
  return created;
}

int pool_last_seen(void* handle, int word_id) {
  Pool* p = static_cast<Pool*>(handle);
  int idx = p->hash(word_id);
  for (int probes = 0; probes < p->capacity; ++probes) {
    Feature& f = p->slots[idx];
    if (f.word_id == word_id) {
      return f.frames[(f.frame_ptr + f.num_frames - 1) % p->max_frames];
    }
    if (f.word_id == kEmpty) return -1;
    idx = (idx + 1) % p->capacity;
  }
  return -1;
}

namespace {

// Remove slot `idx`, backward-shifting the following cluster so every
// remaining entry stays reachable from its home slot.
void delete_slot(Pool* p, int idx) {
  p->slots[idx].word_id = kEmpty;
  p->slots[idx].num_frames = 0;
  p->size--;
  int hole = idx;
  int next = (idx + 1) % p->capacity;
  while (p->slots[next].word_id != kEmpty) {
    if (probe_distance(*p, next, p->slots[next].word_id) > 0) {
      // Entry is displaced; it can move into the hole only if doing so does
      // not put it before its home slot.
      int home = p->hash(p->slots[next].word_id);
      // Moving from `next` to `hole` keeps the entry reachable iff the hole
      // is within [home, next] in circular probe order.
      int d_next = (next - home + p->capacity) % p->capacity;
      int d_hole = (hole - home + p->capacity) % p->capacity;
      if (d_hole <= d_next) {
        p->slots[hole] = p->slots[next];
        p->slots[next].word_id = kEmpty;
        p->slots[next].num_frames = 0;
        hole = next;
      }
    }
    next = (next + 1) % p->capacity;
    if (next == idx) break;  // full wrap (pathological full table)
  }
}

}  // namespace

// Age out features whose newest sighting predates
// (current_frame - max_frames + 1); drop single old entries from rings
// first (reference remove_old_frame semantics, local_feature_pool.h:49-62).
void pool_remove_old(void* handle, int current_frame) {
  Pool* p = static_cast<Pool*>(handle);
  int oldest_keep = current_frame - p->max_frames + 1;
  for (int i = 0; i < p->capacity; ++i) {
    Feature& f = p->slots[i];
    if (f.word_id == kEmpty) continue;
    while (f.num_frames > 0 && f.frames[f.frame_ptr] < oldest_keep) {
      f.frame_ptr = (f.frame_ptr + 1) % p->max_frames;
      f.num_frames--;
    }
    if (f.num_frames == 0) {
      delete_slot(p, i);
      i--;  // re-examine the slot a shifted entry may now occupy
    }
  }
}

int pool_valid_keys(void* handle, int* out, int max_out) {
  Pool* p = static_cast<Pool*>(handle);
  int n = 0;
  for (int i = 0; i < p->capacity && n < max_out; ++i) {
    if (p->slots[i].word_id != kEmpty) out[n++] = p->slots[i].word_id;
  }
  return n;
}

// Count sightings of word_id within the ring (covisibility weight).
int pool_num_sightings(void* handle, int word_id) {
  Pool* p = static_cast<Pool*>(handle);
  int idx = p->hash(word_id);
  for (int probes = 0; probes < p->capacity; ++probes) {
    Feature& f = p->slots[idx];
    if (f.word_id == word_id) return f.num_frames;
    if (f.word_id == kEmpty) return 0;
    idx = (idx + 1) % p->capacity;
  }
  return 0;
}

// Invariant checker (capability of local_feature_pool_check_invariant,
// local_feature_pool.h:279-336). Returns 0 when consistent, else a code:
// 1 size mismatch, 2 stale feature, 3 non-increasing ring, 4 empty ring,
// 5 unreachable entry (broken probe chain).
int pool_check_invariant(void* handle, int current_frame) {
  Pool* p = static_cast<Pool*>(handle);
  int count = 0;
  for (int i = 0; i < p->capacity; ++i) {
    const Feature& f = p->slots[i];
    if (f.word_id == kEmpty) continue;
    count++;
    if (f.num_frames < 1) return 4;
    int oldest = f.frames[f.frame_ptr];
    if (oldest < current_frame - p->max_frames + 1) return 2;
    for (int j = 1; j < f.num_frames; ++j) {
      int prev = f.frames[(f.frame_ptr + j - 1) % p->max_frames];
      int cur = f.frames[(f.frame_ptr + j) % p->max_frames];
      if (cur <= prev) return 3;
    }
    // Reachability: walking from home to here must not cross an empty slot.
    int idx = p->hash(f.word_id);
    bool reachable = false;
    for (int probes = 0; probes < p->capacity; ++probes) {
      if (idx == i) {
        reachable = true;
        break;
      }
      if (p->slots[idx].word_id == kEmpty) break;
      idx = (idx + 1) % p->capacity;
    }
    if (!reachable) return 5;
  }
  if (count != p->size) return 1;
  return 0;
}

// Sorted-list intersection count (capability of lcd_main.c:52-74).
int lcd_intersect(const int* a, int na, const int* b, int nb) {
  int i = 0, j = 0, n = 0;
  while (i < na && j < nb) {
    if (a[i] == b[j]) {
      n++;
      i++;
      j++;
    } else if (a[i] < b[j]) {
      i++;
    } else {
      j++;
    }
  }
  return n;
}

// Batch scoring of one frame against many (the lcd_main measured loop).
void lcd_intersect_batch(const int* frames, const int* frame_sizes,
                         int num_frames, int stride, const int* query,
                         int nq, int* out) {
  for (int f = 0; f < num_frames; ++f) {
    out[f] = lcd_intersect(frames + f * stride, frame_sizes[f], query, nq);
  }
}

}  // extern "C"
