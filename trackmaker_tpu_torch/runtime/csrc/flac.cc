// From-scratch FLAC decoder (subset sufficient for production audio
// captures: 8/12/16/20/24-bit, CONSTANT/VERBATIM/FIXED/LPC subframes,
// all stereo decorrelation modes, rice/rice2 residuals incl. escapes).
//
// This is the native data-loader of the framework — the PHY on the card
// consumes whole 48 kHz recordings; this turns FLAC captures into f32
// sample arrays at native speed.  Reference equivalent:
// src/audio/codec.rs:10-148 (symphonia-based decode_flac_to_f32).
// Implemented against the public FLAC format spec (RFC 9639).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t len;       // bytes
  size_t pos_bit;   // absolute bit position
  bool error;

  explicit BitReader(const uint8_t* d, size_t n)
      : data(d), len(n), pos_bit(0), error(false) {}

  inline bool avail(size_t nbits) const {
    return pos_bit + nbits <= len * 8;
  }

  inline uint32_t read_bit() {
    if (!avail(1)) { error = true; return 0; }
    uint32_t b = (data[pos_bit >> 3] >> (7 - (pos_bit & 7))) & 1;
    pos_bit++;
    return b;
  }

  inline uint64_t read_bits(unsigned n) {  // n <= 57
    if (n == 0) return 0;
    if (!avail(n)) { error = true; return 0; }
    uint64_t v = 0;
    size_t p = pos_bit;
    // fast path: gather bytes
    size_t byte = p >> 3;
    unsigned bitoff = p & 7;
    unsigned need = bitoff + n;
    unsigned nbytes = (need + 7) / 8;
    uint64_t acc = 0;
    for (unsigned i = 0; i < nbytes; i++) acc = (acc << 8) | data[byte + i];
    acc >>= (nbytes * 8 - need);
    v = acc & ((n == 64) ? ~0ULL : ((1ULL << n) - 1));
    pos_bit += n;
    return v;
  }

  inline int64_t read_signed(unsigned n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    uint64_t sign = 1ULL << (n - 1);
    return (int64_t)((v ^ sign)) - (int64_t)sign;
  }

  inline uint32_t read_unary() {
    uint32_t q = 0;
    // scan for the terminating 1 bit
    while (true) {
      if (!avail(1)) { error = true; return q; }
      // fast skip over whole zero bytes when aligned-ish
      if ((pos_bit & 7) == 0) {
        size_t byte = pos_bit >> 3;
        while (byte < len && data[byte] == 0) { q += 8; byte++; pos_bit += 8; }
        if (byte >= len) { error = true; return q; }
      }
      uint32_t b = read_bit();
      if (error) return q;
      if (b) return q;
      q++;
    }
  }

  inline void align_byte() {
    pos_bit = (pos_bit + 7) & ~size_t(7);
  }
};

struct StreamInfo {
  uint32_t min_block, max_block;
  uint32_t sample_rate;
  uint32_t channels;
  uint32_t bps;
  uint64_t total_samples;
  uint8_t md5[16];
};

const int kMaxChannels = 8;

bool parse_streaminfo(const uint8_t* data, size_t len, StreamInfo* si,
                      size_t* frames_offset) {
  if (len < 4 + 4 + 34 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool have_si = false;
  while (pos + 4 <= len) {
    uint8_t hdr = data[pos];
    uint32_t btype = hdr & 0x7F;
    bool last = hdr & 0x80;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (blen > len - pos) return false;  // truncated/malformed block
    if (btype == 0 && blen >= 34) {
      const uint8_t* p = data + pos;
      si->min_block = (p[0] << 8) | p[1];
      si->max_block = (p[2] << 8) | p[3];
      uint64_t bits = 0;
      for (int i = 10; i < 18; i++) bits = (bits << 8) | p[i];
      si->sample_rate = (uint32_t)(bits >> 44);
      si->channels = (uint32_t)((bits >> 41) & 0x7) + 1;
      si->bps = (uint32_t)((bits >> 36) & 0x1F) + 1;
      si->total_samples = bits & ((1ULL << 36) - 1);
      memcpy(si->md5, p + 18, 16);
      have_si = true;
    }
    pos += blen;
    if (last) break;
  }
  *frames_offset = pos;
  return have_si && pos < len;
}

// Decode one rice-coded residual partition set into res[blocksize-order..]
bool decode_residual(BitReader& br, uint32_t blocksize, uint32_t order,
                     int64_t* res) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  unsigned pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = (uint32_t)br.read_bits(4);
  uint32_t nparts = 1u << po;
  if ((blocksize >> po) == 0) return false;
  uint32_t idx = 0;
  for (uint32_t part = 0; part < nparts; part++) {
    uint32_t n = blocksize >> po;
    if (part == 0) {
      if (n < order) return false;
      n -= order;
    }
    uint32_t param = (uint32_t)br.read_bits(pbits);
    if (param == escape) {
      uint32_t rawbits = (uint32_t)br.read_bits(5);
      for (uint32_t i = 0; i < n; i++)
        res[idx++] = rawbits ? br.read_signed(rawbits) : 0;
    } else {
      for (uint32_t i = 0; i < n; i++) {
        uint32_t q = br.read_unary();
        uint64_t low = param ? br.read_bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | low;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.error) return false;
  }
  return true;
}

const int kFixedCoeffs[5][4] = {
    {0, 0, 0, 0},
    {1, 0, 0, 0},
    {2, -1, 0, 0},
    {3, -3, 1, 0},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, uint32_t blocksize, uint32_t bps,
                     int64_t* out) {
  if (br.read_bit() != 0) return false;  // padding
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bit()) wasted = br.read_unary() + 1;
  if (br.error || wasted >= bps) return false;
  uint32_t ebps = bps - wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (uint32_t i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; i++) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    uint32_t order = type & 0x07;
    if (order > blocksize) return false;  // warmup would overrun out[]
    for (uint32_t i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    if (!decode_residual(br, blocksize, order, out + order)) return false;
    const int* c = kFixedCoeffs[order];
    for (uint32_t i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (uint32_t j = 0; j < order; j++) pred += (int64_t)c[j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type & 0x20) {  // LPC
    uint32_t order = (type & 0x1F) + 1;
    if (order > blocksize) return false;  // warmup would overrun out[]
    for (uint32_t i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    uint32_t prec = (uint32_t)br.read_bits(4);
    if (prec == 0xF) return false;
    prec += 1;
    int32_t shift = (int32_t)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coeffs[32];
    for (uint32_t i = 0; i < order; i++) coeffs[i] = br.read_signed(prec);
    if (!decode_residual(br, blocksize, order, out + order)) return false;
    for (uint32_t i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (uint32_t j = 0; j < order; j++) pred += coeffs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (br.error) return false;
  if (wasted) {
    for (uint32_t i = 0; i < blocksize; i++) out[i] <<= wasted;
  }
  return true;
}

// skip the UTF-8-style coded frame/sample number
bool skip_coded_number(BitReader& br) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  unsigned extra = 0;
  if ((b0 & 0x80) == 0) extra = 0;
  else if ((b0 & 0xE0) == 0xC0) extra = 1;
  else if ((b0 & 0xF0) == 0xE0) extra = 2;
  else if ((b0 & 0xF8) == 0xF0) extra = 3;
  else if ((b0 & 0xFC) == 0xF8) extra = 4;
  else if ((b0 & 0xFE) == 0xFC) extra = 5;
  else if (b0 == 0xFE) extra = 6;
  else return false;
  for (unsigned i = 0; i < extra; i++) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return false;
  }
  return !br.error;
}

}  // namespace

extern "C" {

// Returns 0 on success.  info_out: [channels, sample_rate, bps,
// total_samples_lo, total_samples_hi].
int tm_flac_info(const uint8_t* data, size_t len, int64_t* info_out) {
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(data, len, &si, &off)) return -1;
  info_out[0] = si.channels;
  info_out[1] = si.sample_rate;
  info_out[2] = si.bps;
  info_out[3] = (int64_t)si.total_samples;
  return 0;
}

// Decode whole stream to interleaved int32.  out must hold
// total_samples * channels entries.  Returns number of inter-channel
// samples decoded, or a negative error code.
int64_t tm_flac_decode(const uint8_t* data, size_t len, int32_t* out,
                       int64_t out_capacity) {
  StreamInfo si;
  size_t off;
  if (!parse_streaminfo(data, len, &si, &off)) return -1;
  if (si.channels > (uint32_t)kMaxChannels) return -2;

  BitReader br(data + off, len - off);
  int64_t* ch_buf[kMaxChannels];
  // Floor the allocation at 33 entries (max LPC order + 1) so even a
  // hostile STREAMINFO max_block smaller than a subframe's order cannot
  // make the warmup loops write past the buffer (defense in depth on
  // top of the order > blocksize rejection in decode_subframe).
  uint32_t maxb = si.max_block ? si.max_block : 65535;
  uint32_t alloc_n = maxb < 33 ? 33 : maxb;
  for (uint32_t c = 0; c < si.channels; c++)
    ch_buf[c] = (int64_t*)malloc(sizeof(int64_t) * alloc_n);

  int64_t written = 0;
  int64_t rc = 0;
  while (written < (int64_t)si.total_samples) {
    br.align_byte();
    if (!br.avail(32)) break;  // end of stream
    // frame header
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (sync != 0x3FFE) { rc = -3; break; }
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();  // reserved
    if (!skip_coded_number(br)) { rc = -4; break; }

    uint32_t blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) blocksize = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.read_bits(16) + 1;
    else if (bs_code >= 8) blocksize = 256u << (bs_code - 8);
    else { rc = -5; break; }

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    else if (sr_code == 15) { rc = -6; break; }

    uint32_t bps = si.bps;
    switch (ss_code) {
      case 0: break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: rc = -7; break;
    }
    if (rc) break;
    br.read_bits(8);  // header CRC8 (not verified here)
    if (blocksize > maxb) { rc = -8; break; }

    uint32_t nch = si.channels;
    if (ch_code <= 7) {
      if (ch_code + 1 != nch) { rc = -9; break; }
      for (uint32_t c = 0; c < nch; c++)
        if (!decode_subframe(br, blocksize, bps, ch_buf[c])) { rc = -10; break; }
    } else if (ch_code >= 8 && ch_code <= 10) {
      if (nch != 2) { rc = -9; break; }
      uint32_t side_ch = (ch_code == 9) ? 0 : 1;
      for (uint32_t c = 0; c < 2; c++) {
        uint32_t b = bps + (c == side_ch ? 1 : 0);
        if (!decode_subframe(br, blocksize, b, ch_buf[c])) { rc = -10; break; }
      }
      if (rc) break;
      if (ch_code == 8) {         // left/side: right = left - side
        for (uint32_t i = 0; i < blocksize; i++)
          ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
      } else if (ch_code == 9) {  // side/right: left = side + right
        for (uint32_t i = 0; i < blocksize; i++)
          ch_buf[0][i] = ch_buf[0][i] + ch_buf[1][i];
      } else {                    // mid/side
        for (uint32_t i = 0; i < blocksize; i++) {
          int64_t mid = ch_buf[0][i];
          int64_t side = ch_buf[1][i];
          mid = (mid << 1) | (side & 1);
          ch_buf[0][i] = (mid + side) >> 1;
          ch_buf[1][i] = (mid - side) >> 1;
        }
      }
    } else {
      rc = -9; break;
    }
    if (rc) break;

    br.align_byte();
    br.read_bits(16);  // frame CRC16 (not verified here)
    if (br.error) { rc = -11; break; }

    int64_t n = blocksize;
    if (written + n > (int64_t)si.total_samples)
      n = (int64_t)si.total_samples - written;
    if ((written + n) * nch > out_capacity) { rc = -12; break; }
    for (int64_t i = 0; i < n; i++)
      for (uint32_t c = 0; c < nch; c++)
        out[(written + i) * nch + c] = (int32_t)ch_buf[c][i];
    written += n;
  }

  for (uint32_t c = 0; c < si.channels; c++) free(ch_buf[c]);
  if (rc && written == 0) return rc;
  return written;
}

}  // extern "C"
