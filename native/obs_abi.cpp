// Native observation-ABI bridge + async trajectory ring.
//
// The JAX engine keeps environment state as batched device arrays
// (struct-of-arrays). Consumers that want the reference wheel's ABI — the
// cache-line-friendly array-of-structs ObsData layout with per-player deck
// counts and mask heads (reference layout: include/api.h:67-161) — need a
// fast host-side transpose. Doing it per-field in numpy costs a dozen
// Python-level passes per batch; this library does the whole packing in one
// cache-friendly sweep, and provides a lock-free single-producer/
// single-consumer trajectory ring so a training process can consume rollout
// chunks while the dispatch thread keeps feeding the device (the role the
// reference's ThreadedRunner mailboxes played, re-targeted at host<->device
// pipelining).
//
// Plain C ABI (ctypes); no Python dependency.

#include <atomic>
#include <cstdint>
#include <cstring>

extern "C" {

// ---- ObsData packing ------------------------------------------------------
// Field sizes of the reference ABI (bytes, tightly packed by our Python
// dtype definitions in eldorado_tpu/compat):
//   DeckObs: 5*21 u8 = 105
//   ActionMask: 22+22+22+7+19 bool = 92
//   PlayerData: 105 + 92 = 197
//   SharedObservation: 48*48*7 + 1 + 3*4 + 18 = 16159
//   ObsData: 16159 + 4*197 = 16947
static const int N_CARD = 21;
static const int MASK = 92;
static const int MAPB = 48 * 48 * 7;
static const int DECK = 5 * N_CARD;
static const int PD = DECK + MASK;
static const int SHARED = MAPB + 1 + 12 + 18;
static const int OBS = SHARED + 4 * PD;

// Pack n environments into the ObsData array-of-structs layout.
//  map:      n*48*48*7 u8
//  phase:    n i32
//  res:      n*3 f32
//  shop:     n*18 i32 (counter dtype of the engine)
//  piles:    n*4*5*21 i32
//  masks:    n*4*92 u8/bool bytes
//  out:      n*16947 bytes (caller-allocated)
void pack_obs(int64_t n, const uint8_t* map, const int32_t* phase,
              const float* res, const int32_t* shop, const int32_t* piles,
              const uint8_t* masks, uint8_t* out) {
  for (int64_t e = 0; e < n; ++e) {
    uint8_t* o = out + e * OBS;
    std::memcpy(o, map + e * MAPB, MAPB);
    o += MAPB;
    *o++ = static_cast<uint8_t>(phase[e]);
    std::memcpy(o, res + e * 3, 12);
    o += 12;
    const int32_t* sh = shop + e * 18;
    for (int i = 0; i < 18; ++i) o[i] = static_cast<uint8_t>(sh[i]);
    o += 18;
    for (int p = 0; p < 4; ++p) {
      const int32_t* pp = piles + ((e * 4 + p) * 5) * N_CARD;
      for (int i = 0; i < DECK; ++i) o[i] = static_cast<uint8_t>(pp[i]);
      o += DECK;
      std::memcpy(o, masks + (e * 4 + p) * MASK, MASK);
      o += MASK;
    }
  }
}

// Unpack structured ActionData records (n*5 u8) into the planar i32 action
// matrix the device step consumes.
void unpack_actions(int64_t n, const uint8_t* rec, int32_t* out) {
  for (int64_t i = 0; i < n * 5; ++i) out[i] = rec[i];
}

int obs_struct_size() { return OBS; }

// ---- SPSC trajectory ring -------------------------------------------------
// Fixed-capacity ring of fixed-size chunks; one producer (device dispatch
// thread) and one consumer (training/IO thread). Same progress guarantee as
// the reference's jdz SPSC mailboxes (include/runner.h:17-19): acquire/
// release on head/tail only, payloads copied outside the atomics.

struct Ring {
  uint8_t* data;
  int64_t chunk_bytes;
  int64_t capacity;            // number of chunks, power of two
  std::atomic<int64_t> head;   // next write
  std::atomic<int64_t> tail;   // next read
};

void* ring_create(int64_t chunk_bytes, int64_t capacity) {
  Ring* r = new Ring();
  r->data = new uint8_t[chunk_bytes * capacity];
  r->chunk_bytes = chunk_bytes;
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  delete[] r->data;
  delete r;
}

// 1 on success, 0 if full.
int ring_push(void* h, const uint8_t* chunk) {
  Ring* r = static_cast<Ring*>(h);
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;
  std::memcpy(r->data + (head % r->capacity) * r->chunk_bytes, chunk,
              r->chunk_bytes);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// 1 on success, 0 if empty.
int ring_pop(void* h, uint8_t* out) {
  Ring* r = static_cast<Ring*>(h);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return 0;
  std::memcpy(out, r->data + (tail % r->capacity) * r->chunk_bytes,
              r->chunk_bytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

int64_t ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return r->head.load(std::memory_order_acquire)
       - r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
