// Native host-runtime utilities for the streaming path.
//
// The reference's real-time loop is native Rust around JACK
// (src/audio/recorder.rs, src/mac/csma.rs); our equivalents are the
// hot host-side primitives that sit between audio I/O and the
// card's batch boundary: a SPSC ring buffer for capture streaming, the CSMA
// energy detector (src/mac/mod.rs:18-27), CRC8 (src/phy/crc.rs:7-22)
// and frame byte (de)serialization (src/phy/frame.rs:74-143).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// CRC8 (poly 0x07, init 0)
// ---------------------------------------------------------------------

static uint8_t g_crc_table[256];
static bool g_crc_init = false;

static void crc8_init() {
  for (int b = 0; b < 256; b++) {
    uint8_t crc = (uint8_t)b;
    for (int i = 0; i < 8; i++)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
    g_crc_table[b] = crc;
  }
  g_crc_init = true;
}

uint8_t tm_crc8(const uint8_t* data, size_t len) {
  if (!g_crc_init) crc8_init();
  uint8_t crc = 0;
  for (size_t i = 0; i < len; i++) crc = g_crc_table[crc ^ data[i]];
  return crc;
}

// ---------------------------------------------------------------------
// Energy-based carrier sense: any |s| > threshold over >= min_samples
// Returns -1 (not enough samples), 0 (idle), 1 (busy).
// ---------------------------------------------------------------------

int tm_channel_busy(const float* samples, size_t len, float threshold,
                    size_t min_samples) {
  if (len < min_samples) return -1;
  for (size_t i = 0; i < len; i++)
    if (std::fabs(samples[i]) > threshold) return 1;
  return 0;
}

// ---------------------------------------------------------------------
// Frame serialization: [Len:2][CRC:1][Type:1][Seq:1][Src:1][Dst:1][Data]
// ---------------------------------------------------------------------

size_t tm_frame_serialize(uint8_t frame_type, uint8_t seq, uint8_t src,
                          uint8_t dst, const uint8_t* data, size_t data_len,
                          uint8_t* out /* >= 7+data_len */) {
  out[0] = (uint8_t)(data_len >> 8);
  out[1] = (uint8_t)(data_len & 0xFF);
  out[2] = tm_crc8(data, data_len);
  out[3] = frame_type;
  out[4] = seq;
  out[5] = src;
  out[6] = dst;
  memcpy(out + 7, data, data_len);
  return 7 + data_len;
}

// Parse+validate. Returns payload length >= 0, or -1 bad type,
// -2 short buffer, -3 CRC mismatch.  Header fields to hdr_out[4]:
// type, seq, src, dst.
int64_t tm_frame_parse(const uint8_t* raw, size_t len, uint8_t* hdr_out,
                       uint8_t* payload_out /* may be null */) {
  if (len < 7) return -2;
  uint32_t n = ((uint32_t)raw[0] << 8) | raw[1];
  uint8_t type = raw[3];
  if (type != 0x01 && type != 0x02) return -1;
  if (len < 7 + n) return -2;
  if (tm_crc8(raw + 7, n) != raw[2]) return -3;
  hdr_out[0] = type;
  hdr_out[1] = raw[4];
  hdr_out[2] = raw[5];
  hdr_out[3] = raw[6];
  if (payload_out) memcpy(payload_out, raw + 7, n);
  return (int64_t)n;
}

// ---------------------------------------------------------------------
// SPSC float ring buffer (capture streaming between an audio thread and
// the batch-decode consumer)
// ---------------------------------------------------------------------

struct TmRing {
  float* buf;
  size_t capacity;  // power of two
  std::atomic<size_t> head;  // write index
  std::atomic<size_t> tail;  // read index
};

void* tm_ring_create(size_t capacity_pow2) {
  size_t cap = 1;
  while (cap < capacity_pow2) cap <<= 1;
  TmRing* r = new TmRing();
  r->buf = (float*)malloc(sizeof(float) * cap);
  r->capacity = cap;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void tm_ring_destroy(void* ring) {
  TmRing* r = (TmRing*)ring;
  free(r->buf);
  delete r;
}

size_t tm_ring_size(void* ring) {
  TmRing* r = (TmRing*)ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// Returns number of samples written (may be < len if full).
size_t tm_ring_push(void* ring, const float* data, size_t len) {
  TmRing* r = (TmRing*)ring;
  size_t head = r->head.load(std::memory_order_relaxed);
  size_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_slots = r->capacity - (head - tail);
  size_t n = len < free_slots ? len : free_slots;
  for (size_t i = 0; i < n; i++)
    r->buf[(head + i) & (r->capacity - 1)] = data[i];
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Returns number of samples read.
size_t tm_ring_pop(void* ring, float* out, size_t len) {
  TmRing* r = (TmRing*)ring;
  size_t tail = r->tail.load(std::memory_order_relaxed);
  size_t head = r->head.load(std::memory_order_acquire);
  size_t avail = head - tail;
  size_t n = len < avail ? len : avail;
  for (size_t i = 0; i < n; i++)
    out[i] = r->buf[(tail + i) & (r->capacity - 1)];
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------
// Energy-gated segmenter: find [start,end) regions where a moving max
// of |s| exceeds `threshold`, padded by `halo` samples — the host-side
// pre-filter that ships only active regions to the decoder on the card.
// Writes up to max_regions (start,end) int64 pairs; returns count.
// ---------------------------------------------------------------------

size_t tm_active_regions(const float* x, size_t len, float threshold,
                         size_t hang, size_t halo, int64_t* out,
                         size_t max_regions) {
  size_t count = 0;
  size_t i = 0;
  while (i < len && count < max_regions) {
    // find next sample above threshold
    while (i < len && std::fabs(x[i]) <= threshold) i++;
    if (i >= len) break;
    size_t start = i;
    size_t last_hot = i;
    while (i < len && i - last_hot <= hang) {
      if (std::fabs(x[i]) > threshold) last_hot = i;
      i++;
    }
    int64_t s = (int64_t)start - (int64_t)halo;
    int64_t e = (int64_t)last_hot + 1 + (int64_t)halo;
    if (s < 0) s = 0;
    if (e > (int64_t)len) e = (int64_t)len;
    // merge with previous region if overlapping
    if (count > 0 && s <= out[2 * count - 1]) {
      out[2 * count - 1] = e;
    } else {
      out[2 * count] = s;
      out[2 * count + 1] = e;
      count++;
    }
  }
  return count;
}

}  // extern "C"
