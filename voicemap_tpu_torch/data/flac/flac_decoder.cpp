// FLAC decoder of the PyTorch port: a copy of the JAX package's
// voicemap_tpu/data/flac/flac_decoder.cpp, so that the port builds its own.
//
// The subset of RFC 9639 that LibriSpeech and the synthetic corpora need:
// 16 kHz, 16-bit, mono or stereo, every subframe type (CONSTANT, VERBATIM,
// FIXED 0-4, LPC 1-32), Rice and Rice2 residuals with escape codes, wasted
// bits, every stereo decorrelation mode, CRC-8 and CRC-16 checks.
//
// Exposed as extern "C" for ctypes (voicemap_tpu_torch/data/flac_ext.py):
//   vm_flac_probe(path, &n_samples, &sample_rate, &channels, &bps)
//   vm_flac_decode(path, out_i16, capacity_samples) -> samples written (interleaved)
//   vm_flac_decode_batch(paths, n, outs, caps, lens, n_threads) -> 0 on success
//   vm_flac_last_error() -> const char* for the calling thread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <thread>
#include <atomic>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct BitReader {
  const uint8_t* data;
  size_t size;       // bytes
  size_t byte_pos = 0;
  int bit_pos = 0;   // 0..7, MSB-first within the byte

  bool eof() const { return byte_pos >= size; }

  bool at_frame_end(size_t limit) const { return byte_pos >= limit; }

  // Read up to 32 bits, MSB-first. Returns false on EOF.
  bool read_bits(int n, uint32_t* out) {
    uint32_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) return false;
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      uint32_t chunk =
          (data[byte_pos] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit_pos += take;
      n -= take;
      if (bit_pos == 8) {
        bit_pos = 0;
        ++byte_pos;
      }
    }
    *out = v;
    return true;
  }

  bool read_bits64(int n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      int take = n > 24 ? 24 : n;
      uint32_t chunk;
      if (!read_bits(take, &chunk)) return false;
      v = (v << take) | chunk;
      n -= take;
    }
    *out = v;
    return true;
  }

  // Signed two's-complement n-bit value.
  bool read_signed(int n, int64_t* out) {
    uint64_t u;
    if (!read_bits64(n, &u)) return false;
    if (n < 64 && (u & (1ull << (n - 1)))) u |= ~((1ull << n) - 1ull);
    *out = static_cast<int64_t>(u);
    return true;
  }

  // Unary: count of 0 bits before the terminating 1 bit (libFLAC convention).
  bool read_unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      if (byte_pos >= size) return false;
      // Fast path: whole remaining byte is zero.
      uint8_t cur = data[byte_pos] & ((1u << (8 - bit_pos)) - 1u);
      if (cur == 0) {
        q += 8 - bit_pos;
        bit_pos = 0;
        ++byte_pos;
        continue;
      }
      uint32_t b;
      if (!read_bits(1, &b)) return false;
      if (b) break;
      ++q;
    }
    *out = q;
    return true;
  }

  void align() {
    if (bit_pos) {
      bit_pos = 0;
      ++byte_pos;
    }
  }
};

// CRC-8, polynomial x^8 + x^2 + x^1 + x^0 (0x07), init 0.
uint8_t crc8(const uint8_t* buf, size_t len) {
  uint8_t crc = 0;
  for (size_t i = 0; i < len; ++i) {
    crc ^= buf[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? static_cast<uint8_t>((crc << 1) ^ 0x07)
                         : static_cast<uint8_t>(crc << 1);
  }
  return crc;
}

// CRC-16, polynomial x^16 + x^15 + x^2 + x^0 (0x8005), init 0.
uint16_t crc16(const uint8_t* buf, size_t len) {
  uint16_t crc = 0;
  for (size_t i = 0; i < len; ++i) {
    crc ^= static_cast<uint16_t>(buf[i]) << 8;
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? static_cast<uint16_t>((crc << 1) ^ 0x8005)
                           : static_cast<uint16_t>(crc << 1);
  }
  return crc;
}

struct StreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

struct FrameHeader {
  uint32_t block_size = 0;
  uint32_t sample_rate = 0;
  int channels = 0;
  int channel_assignment = 0;  // 0..7 independent, 8 L/S, 9 R/S, 10 M/S
  int bps = 0;
  uint64_t coded_number = 0;
  bool variable_blocksize = false;
};

// Read at most max_bytes (0 = whole file). The STREAMINFO probe only needs
// the metadata header, so cold-start indexing avoids reading full files.
bool read_file_prefix(const char* path, std::vector<uint8_t>* out,
                      size_t max_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  size_t want = static_cast<size_t>(sz);
  if (max_bytes && want > max_bytes) want = max_bytes;
  out->resize(want);
  size_t got = want ? std::fread(out->data(), 1, want, f) : 0;
  std::fclose(f);
  if (got != want) {
    set_error(std::string("short read on ") + path);
    return false;
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(out->data(), 1, static_cast<size_t>(sz), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(sz)) {
    set_error(std::string("short read on ") + path);
    return false;
  }
  return true;
}

bool parse_streaminfo(BitReader* br, StreamInfo* si) {
  uint32_t magic;
  if (!br->read_bits(32, &magic) || magic != 0x664C6143u /* "fLaC" */) {
    set_error("missing fLaC magic");
    return false;
  }
  bool last = false, have_si = false;
  while (!last) {
    uint32_t hdr, len;
    if (!br->read_bits(8, &hdr) || !br->read_bits(24, &len)) {
      set_error("truncated metadata block header");
      return false;
    }
    last = (hdr & 0x80u) != 0;
    uint32_t type = hdr & 0x7Fu;
    if (type == 0) {  // STREAMINFO
      uint32_t v;
      if (!br->read_bits(16, &si->min_block)) return false;
      if (!br->read_bits(16, &si->max_block)) return false;
      if (!br->read_bits(24, &v)) return false;  // min frame size (unused)
      if (!br->read_bits(24, &v)) return false;  // max frame size (unused)
      if (!br->read_bits(20, &si->sample_rate)) return false;
      if (!br->read_bits(3, &v)) return false;
      si->channels = static_cast<int>(v) + 1;
      if (!br->read_bits(5, &v)) return false;
      si->bps = static_cast<int>(v) + 1;
      uint64_t ts;
      if (!br->read_bits64(36, &ts)) return false;
      si->total_samples = ts;
      // Skip 128-bit MD5.
      for (int i = 0; i < 4; ++i)
        if (!br->read_bits(32, &v)) return false;
      have_si = true;
    } else {
      // Skip any other metadata block.
      br->align();
      br->byte_pos += len;
      if (br->byte_pos > br->size) {
        set_error("metadata block overruns file");
        return false;
      }
    }
  }
  if (!have_si) set_error("no STREAMINFO block");
  return have_si;
}

// UTF-8-style coded number, up to 36 bits (7 bytes).
bool read_utf8_number(BitReader* br, uint64_t* out) {
  uint32_t b0;
  if (!br->read_bits(8, &b0)) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80u) == 0) {
    extra = 0;
    v = b0;
  } else if ((b0 & 0xE0u) == 0xC0u) {
    extra = 1;
    v = b0 & 0x1Fu;
  } else if ((b0 & 0xF0u) == 0xE0u) {
    extra = 2;
    v = b0 & 0x0Fu;
  } else if ((b0 & 0xF8u) == 0xF0u) {
    extra = 3;
    v = b0 & 0x07u;
  } else if ((b0 & 0xFCu) == 0xF8u) {
    extra = 4;
    v = b0 & 0x03u;
  } else if ((b0 & 0xFEu) == 0xFCu) {
    extra = 5;
    v = b0 & 0x01u;
  } else if (b0 == 0xFEu) {
    extra = 6;
    v = 0;
  } else {
    set_error("invalid UTF-8 coded number");
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b;
    if (!br->read_bits(8, &b)) return false;
    if ((b & 0xC0u) != 0x80u) {
      set_error("invalid UTF-8 continuation byte");
      return false;
    }
    v = (v << 6) | (b & 0x3Fu);
  }
  *out = v;
  return true;
}

bool parse_frame_header(BitReader* br, const StreamInfo& si, FrameHeader* fh,
                        size_t header_start) {
  uint32_t sync;
  if (!br->read_bits(14, &sync)) return false;
  if (sync != 0x3FFEu) {
    set_error("bad frame sync code");
    return false;
  }
  uint32_t v;
  if (!br->read_bits(1, &v)) return false;  // reserved
  uint32_t blocking;
  if (!br->read_bits(1, &blocking)) return false;
  fh->variable_blocksize = blocking != 0;
  uint32_t bs_code, sr_code, ch_code, ss_code;
  if (!br->read_bits(4, &bs_code)) return false;
  if (!br->read_bits(4, &sr_code)) return false;
  if (!br->read_bits(4, &ch_code)) return false;
  if (!br->read_bits(3, &ss_code)) return false;
  if (!br->read_bits(1, &v)) return false;  // reserved

  if (!read_utf8_number(br, &fh->coded_number)) return false;

  // Block size.
  switch (bs_code) {
    case 0:
      set_error("reserved block size code 0");
      return false;
    case 1:
      fh->block_size = 192;
      break;
    case 6: {
      if (!br->read_bits(8, &v)) return false;
      fh->block_size = v + 1;
      break;
    }
    case 7: {
      if (!br->read_bits(16, &v)) return false;
      fh->block_size = v + 1;
      break;
    }
    default:
      if (bs_code <= 5)
        fh->block_size = 576u << (bs_code - 2);
      else
        fh->block_size = 256u << (bs_code - 8);
  }

  // Sample rate.
  switch (sr_code) {
    case 0:
      fh->sample_rate = si.sample_rate;
      break;
    case 1: fh->sample_rate = 88200; break;
    case 2: fh->sample_rate = 176400; break;
    case 3: fh->sample_rate = 192000; break;
    case 4: fh->sample_rate = 8000; break;
    case 5: fh->sample_rate = 16000; break;
    case 6: fh->sample_rate = 22050; break;
    case 7: fh->sample_rate = 24000; break;
    case 8: fh->sample_rate = 32000; break;
    case 9: fh->sample_rate = 44100; break;
    case 10: fh->sample_rate = 48000; break;
    case 11: fh->sample_rate = 96000; break;
    case 12: {
      if (!br->read_bits(8, &v)) return false;
      fh->sample_rate = v * 1000;
      break;
    }
    case 13: {
      if (!br->read_bits(16, &v)) return false;
      fh->sample_rate = v;
      break;
    }
    case 14: {
      if (!br->read_bits(16, &v)) return false;
      fh->sample_rate = v * 10;
      break;
    }
    default:
      set_error("invalid sample rate code 15");
      return false;
  }

  // Channels / decorrelation.
  fh->channel_assignment = static_cast<int>(ch_code);
  if (ch_code < 8) {
    fh->channels = static_cast<int>(ch_code) + 1;
  } else if (ch_code <= 10) {
    fh->channels = 2;
  } else {
    set_error("reserved channel assignment");
    return false;
  }

  // Sample size.
  switch (ss_code) {
    case 0: fh->bps = si.bps; break;
    case 1: fh->bps = 8; break;
    case 2: fh->bps = 12; break;
    case 4: fh->bps = 16; break;
    case 5: fh->bps = 20; break;
    case 6: fh->bps = 24; break;
    case 7: fh->bps = 32; break;
    default:
      set_error("reserved sample size code");
      return false;
  }

  // CRC-8 over the header bytes read so far.
  br->align();  // header is byte-aligned here by construction
  uint32_t expect_crc;
  size_t header_len = br->byte_pos - header_start;
  if (!br->read_bits(8, &expect_crc)) return false;
  uint8_t got = crc8(br->data + header_start, header_len);
  if (got != expect_crc) {
    set_error("frame header CRC-8 mismatch");
    return false;
  }
  return true;
}

bool decode_residual(BitReader* br, uint32_t block_size, int predictor_order,
                     int32_t* out /* residuals for [order, block_size) */) {
  uint32_t method;
  if (!br->read_bits(2, &method)) return false;
  if (method > 1) {
    set_error("reserved residual coding method");
    return false;
  }
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t partition_order;
  if (!br->read_bits(4, &partition_order)) return false;
  uint32_t partitions = 1u << partition_order;
  if (block_size % partitions != 0) {
    set_error("block size not divisible by partition count");
    return false;
  }
  uint32_t part_len = block_size >> partition_order;
  // Partition 0's residual count is part_len - order; a crafted stream with
  // order > part_len would underflow the uint32 count into an unbounded
  // out[idx++] loop.
  if (static_cast<uint32_t>(predictor_order) > part_len) {
    set_error("predictor order exceeds partition length");
    return false;
  }
  uint32_t idx = predictor_order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = part_len - (p == 0 ? predictor_order : 0);
    uint32_t param;
    if (!br->read_bits(param_bits, &param)) return false;
    if (param == escape) {
      uint32_t raw_bits;
      if (!br->read_bits(5, &raw_bits)) return false;
      for (uint32_t i = 0; i < count; ++i) {
        if (raw_bits == 0) {
          out[idx++] = 0;
        } else {
          int64_t s;
          if (!br->read_signed(static_cast<int>(raw_bits), &s)) return false;
          out[idx++] = static_cast<int32_t>(s);
        }
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q;
        if (!br->read_unary(&q)) return false;
        uint32_t low = 0;
        if (param && !br->read_bits(static_cast<int>(param), &low))
          return false;
        uint32_t u = (q << param) | low;
        out[idx++] = static_cast<int32_t>((u >> 1) ^ (~(u & 1) + 1));
      }
    }
  }
  return true;
}

const int kFixedCoeffs[5][4] = {
    {},                 // order 0
    {1},                // order 1
    {2, -1},            // order 2
    {3, -3, 1},         // order 3
    {4, -6, 4, -1},     // order 4
};

bool decode_subframe(BitReader* br, uint32_t block_size, int bps,
                     std::vector<int32_t>* out) {
  uint32_t pad;
  if (!br->read_bits(1, &pad)) return false;
  if (pad != 0) {
    set_error("subframe padding bit not zero");
    return false;
  }
  uint32_t type;
  if (!br->read_bits(6, &type)) return false;
  uint32_t wasted_flag;
  if (!br->read_bits(1, &wasted_flag)) return false;
  int wasted = 0;
  if (wasted_flag) {
    uint32_t q;
    if (!br->read_unary(&q)) return false;
    wasted = static_cast<int>(q) + 1;
  }
  int eff_bps = bps - wasted;
  out->assign(block_size, 0);

  if (type == 0) {  // CONSTANT
    int64_t v;
    if (!br->read_signed(eff_bps, &v)) return false;
    for (uint32_t i = 0; i < block_size; ++i) (*out)[i] = static_cast<int32_t>(v);
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) {
      int64_t v;
      if (!br->read_signed(eff_bps, &v)) return false;
      (*out)[i] = static_cast<int32_t>(v);
    }
  } else if ((type & 0x38u) == 0x08u) {  // FIXED, order in low 3 bits
    int order = static_cast<int>(type & 0x07u);
    if (order > 4) {
      set_error("invalid FIXED order");
      return false;
    }
    if (static_cast<uint32_t>(order) > block_size) {
      set_error("FIXED order exceeds block size");
      return false;
    }
    for (int i = 0; i < order; ++i) {
      int64_t v;
      if (!br->read_signed(eff_bps, &v)) return false;
      (*out)[i] = static_cast<int32_t>(v);
    }
    if (!decode_residual(br, block_size, order, out->data())) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += static_cast<int64_t>(kFixedCoeffs[order][j]) * (*out)[i - 1 - j];
      (*out)[i] = static_cast<int32_t>((*out)[i] + pred);
    }
  } else if (type & 0x20u) {  // LPC, order-1 in low 5 bits
    int order = static_cast<int>(type & 0x1Fu) + 1;
    // Warm-up samples write out[0..order); out only holds block_size slots
    // (LPC order reaches 32, a crafted header can claim a smaller block).
    if (static_cast<uint32_t>(order) > block_size) {
      set_error("LPC order exceeds block size");
      return false;
    }
    for (int i = 0; i < order; ++i) {
      int64_t v;
      if (!br->read_signed(eff_bps, &v)) return false;
      (*out)[i] = static_cast<int32_t>(v);
    }
    uint32_t prec_m1;
    if (!br->read_bits(4, &prec_m1)) return false;
    if (prec_m1 == 15) {
      set_error("invalid LPC precision");
      return false;
    }
    int precision = static_cast<int>(prec_m1) + 1;
    int64_t shift;
    if (!br->read_signed(5, &shift)) return false;
    if (shift < 0) {
      set_error("negative LPC shift");
      return false;
    }
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) {
      int64_t c;
      if (!br->read_signed(precision, &c)) return false;
      coefs[i] = c;
    }
    if (!decode_residual(br, block_size, order, out->data())) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += coefs[j] * (*out)[i - 1 - j];
      (*out)[i] = static_cast<int32_t>((*out)[i] + (pred >> shift));
    }
  } else {
    set_error("reserved subframe type");
    return false;
  }

  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) (*out)[i] <<= wasted;
  }
  return true;
}

// Decode everything. out may be null (probe-by-decode). Returns samples/channel
// decoded, or -1 on error.
int64_t decode_stream(const std::vector<uint8_t>& file, int16_t* out,
                      int64_t capacity, StreamInfo* si_out) {
  BitReader br{file.data(), file.size()};
  StreamInfo si;
  if (!parse_streaminfo(&br, &si)) return -1;
  if (si_out) *si_out = si;
  if (si.bps > 16) {
    set_error("only bps <= 16 supported");
    return -1;
  }
  int64_t written = 0;  // samples per channel
  std::vector<std::vector<int32_t>> chans(si.channels);
  while (br.byte_pos < br.size) {
    size_t frame_start = br.byte_pos;
    FrameHeader fh;
    if (!parse_frame_header(&br, si, &fh, frame_start)) return -1;
    if (fh.channels != si.channels) {
      set_error("frame channel count differs from STREAMINFO");
      return -1;
    }
    int nch = fh.channels;
    for (int c = 0; c < nch; ++c) {
      int sub_bps = fh.bps;
      // Side channel carries one extra bit.
      if ((fh.channel_assignment == 8 && c == 1) ||
          (fh.channel_assignment == 9 && c == 0) ||
          (fh.channel_assignment == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(&br, fh.block_size, sub_bps, &chans[c])) return -1;
    }
    br.align();
    // CRC-16 over the whole frame including header, excluding the CRC itself.
    size_t frame_len = br.byte_pos - frame_start;
    uint32_t expect;
    if (!br.read_bits(16, &expect)) {
      set_error("truncated frame CRC-16");
      return -1;
    }
    uint16_t got = crc16(br.data + frame_start, frame_len);
    if (got != expect) {
      set_error("frame CRC-16 mismatch");
      return -1;
    }
    // Undo inter-channel decorrelation.
    if (fh.channel_assignment == 8) {  // left/side
      for (uint32_t i = 0; i < fh.block_size; ++i)
        chans[1][i] = chans[0][i] - chans[1][i];
    } else if (fh.channel_assignment == 9) {  // right/side: ch0=side, ch1=right
      for (uint32_t i = 0; i < fh.block_size; ++i)
        chans[0][i] = chans[1][i] + chans[0][i];
    } else if (fh.channel_assignment == 10) {  // mid/side
      for (uint32_t i = 0; i < fh.block_size; ++i) {
        int32_t mid = chans[0][i];
        int32_t side = chans[1][i];
        mid = (mid << 1) | (side & 1);
        chans[0][i] = (mid + side) >> 1;
        chans[1][i] = (mid - side) >> 1;
      }
    }
    if (out) {
      // capacity counts interleaved int16 slots; the write below touches
      // indices up to (written + i) * nch + nch - 1, so the per-channel
      // check alone would let stereo streams run ~2x past the buffer.
      for (uint32_t i = 0; i < fh.block_size; ++i) {
        if ((written + static_cast<int64_t>(i)) * nch + nch - 1 >= capacity) {
          set_error("output capacity exceeded");
          return -1;
        }
        for (int c = 0; c < nch; ++c)
          out[(written + i) * nch + c] = static_cast<int16_t>(chans[c][i]);
      }
    }
    written += fh.block_size;
    if (si.total_samples && written >= static_cast<int64_t>(si.total_samples)) {
      written = static_cast<int64_t>(si.total_samples);
      break;
    }
  }
  return written;
}

}  // namespace

extern "C" {

const char* vm_flac_last_error() { return g_error.c_str(); }

int vm_flac_probe(const char* path, int64_t* n_samples, int* sample_rate,
                  int* channels, int* bps) {
  // Header-only read first (64 KB covers STREAMINFO + typical metadata);
  // fall back to the full file if metadata blocks overrun the prefix.
  std::vector<uint8_t> file;
  if (!read_file_prefix(path, &file, 64 * 1024)) return -1;
  BitReader br{file.data(), file.size()};
  StreamInfo si;
  if (!parse_streaminfo(&br, &si)) {
    if (!read_file(path, &file)) return -1;
    br = BitReader{file.data(), file.size()};
    if (!parse_streaminfo(&br, &si)) return -1;
  }
  *n_samples = static_cast<int64_t>(si.total_samples);
  *sample_rate = static_cast<int>(si.sample_rate);
  *channels = si.channels;
  *bps = si.bps;
  return 0;
}

int64_t vm_flac_decode(const char* path, int16_t* out, int64_t capacity,
                       int* sample_rate, int* channels) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return -1;
  StreamInfo si;
  int64_t n = decode_stream(file, out, capacity, &si);
  if (n < 0) return -1;
  *sample_rate = static_cast<int>(si.sample_rate);
  *channels = si.channels;
  return n;
}

// Parallel batch decode: one worker pool over n files. outs[i] has caps[i]
// int16 capacity (samples*channels); lens[i] receives samples/channel or -1;
// chans[i] receives the channel count (the caller downmixes interleaved
// multi-channel output, matching the single-file read path).
int vm_flac_decode_batch(const char** paths, int64_t n, int16_t** outs,
                         const int64_t* caps, int64_t* lens, int* chans,
                         int n_threads) {
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int sr, ch = 0;
      int64_t got = vm_flac_decode(paths[i], outs[i], caps[i], &sr, &ch);
      lens[i] = got;
      chans[i] = got < 0 ? 0 : ch;
      if (got < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load() ? -1 : 0;
}

}  // extern "C"
