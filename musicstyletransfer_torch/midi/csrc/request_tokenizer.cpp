// A transfer request's tokens from its MIDI bytes in one pass (bound by
// musicstyletransfer_torch/midi/native_request.py): the first track that
// holds a note event, tokenized and cut to max_len, as the service's Python
// route gives them, smf.parse_midifile and then codec.tokenize_track on
// each track until one has tokens.
//
// The call answers only where that route returns tokens, and then with the
// same tokens. Where the route raises, and where this reader cannot follow
// it exactly, the call declines (returns -1) and the caller runs the route:
// every structure smf.parse_midifile rejects (not SMF, SMPTE division, a
// truncated chunk, event or number, a data byte with no running status, an
// unknown status byte, a SetTempo of other than 3 bytes), a note of pitch
// above 127 in the track tokenized (vocab.note_on_id raises), a file with
// no note, a variable-length number of more than 8 bytes, and ticks that
// sum past 2^62 between two notes. The corpus reader's tokenizer
// (native/midi_tokenizer.cpp) accepts a SetTempo of other than 3 bytes and a
// pitch above 127 and reads a 5-byte number modulo 2^32, hence this reader.
//
// Tokens (midi/vocab.py): a note event of velocity > 0 is a note-on, of
// velocity 0 a note-off, whatever its status byte; before it, the ticks
// since the previous note event as time shifts, delta % 1000 an iteration
// while 1000 is taken off, so gaps over 1000 ticks lose ticks (the
// reference's arithmetic, SURVEY.md section 8.1).

#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t kNoteOnFirst = 3, kNoteOffFirst = 131, kShiftFirst = 259;
constexpr uint64_t kMaxTicks = 1000, kTicksPerBin = 30;
constexpr int kMaxNumberBytes = 8;  // 56 bits: read exactly
constexpr uint64_t kMaxPending = uint64_t(1) << 62;
constexpr int32_t kDeclined = -1;

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t left() const { return static_cast<uint64_t>(end - p); }
};

uint32_t big_endian(const uint8_t* p, int bytes) {
  uint32_t v = 0;
  for (int i = 0; i < bytes; ++i) v = (v << 8) | p[i];
  return v;
}

// smf._read_varlen, for numbers of at most kMaxNumberBytes bytes.
bool read_number(Cursor& c, uint64_t* out) {
  uint64_t v = 0;
  for (int i = 0; i < kMaxNumberBytes && c.p < c.end; ++i) {
    uint8_t byte = *c.p++;
    v = (v << 7) | (byte & 0x7F);
    if (!(byte & 0x80)) {
      *out = v;
      return true;
    }
  }
  return false;
}

// smf._CHANNEL_DATA_BYTES: a channel message's data bytes by its high nibble.
int data_bytes(uint8_t kind) {
  switch (kind) {
    case 0x80: case 0x90: case 0xA0: case 0xB0: case 0xE0: return 2;
    case 0xC0: case 0xD0: return 1;
    default: return -1;
  }
}

// One MTrk body as smf._parse_track reads it. With `out`, the track's
// tokens as codec.tokenize_track gives them, the first max_len of them
// written at out[*n...]. *has_notes says whether the track holds a note
// event. False where the Python route raises, or may.
bool walk_track(const uint8_t* body, uint64_t len, int32_t* out, int32_t max_len,
                int32_t* n, bool* has_notes) {
  Cursor c{body, body + len};
  int running_status = -1;
  uint64_t pending = 0;  // ticks since the last note event
  while (c.p < c.end) {
    uint64_t tick;
    if (!read_number(c, &tick)) return false;
    pending += tick;
    if (pending >= kMaxPending || c.p == c.end) return false;
    uint8_t status = *c.p;
    if (status >= 0x80) {
      ++c.p;
      if (status < 0xF0) running_status = status;
    } else {
      if (running_status < 0) return false;
      status = static_cast<uint8_t>(running_status);
    }

    if (status == 0xFF) {  // meta event
      if (c.p == c.end) return false;
      uint8_t meta_type = *c.p++;
      uint64_t length;
      if (!read_number(c, &length) || length > c.left()) return false;
      if (meta_type == 0x51 && length != 3) return false;
      c.p += length;
      if (meta_type == 0x2F) break;  // end of track
    } else if (status == 0xF0 || status == 0xF7) {  // sysex
      uint64_t length;
      if (!read_number(c, &length) || length > c.left()) return false;
      c.p += length;
    } else {
      uint8_t kind = status & 0xF0;
      int nd = data_bytes(kind);
      if (nd < 0 || c.left() < static_cast<uint64_t>(nd)) return false;
      const uint8_t* data = c.p;
      c.p += nd;
      if (kind != 0x90 && kind != 0x80) continue;
      *has_notes = true;
      if (out != nullptr) {
        if (data[0] > 127) return false;
        for (uint64_t delta = pending; delta > 0 && *n < max_len; delta -= kMaxTicks) {
          out[(*n)++] = kShiftFirst + static_cast<int32_t>(delta % kMaxTicks / kTicksPerBin);
          if (delta <= kMaxTicks) break;
        }
        if (*n < max_len) out[(*n)++] = (data[1] > 0 ? kNoteOnFirst : kNoteOffFirst) + data[0];
      }
      pending = 0;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Writes the request's first max_len tokens to out (max_len entries) and
// returns their number, or returns -1 where the caller has to run the
// Python route (the cases at the top of this file).
int32_t mst_request_tokens(const uint8_t* buf, int64_t len, int32_t max_len, int32_t* out) {
  if (len < 14 || max_len < 0 || std::memcmp(buf, "MThd", 4) != 0) return kDeclined;
  uint64_t size = static_cast<uint64_t>(len);
  uint64_t header_len = big_endian(buf + 4, 4);
  if (header_len < 6) return kDeclined;
  uint32_t n_tracks = big_endian(buf + 10, 2);
  if (big_endian(buf + 12, 2) & 0x8000) return kDeclined;  // SMPTE division
  uint64_t pos = 8 + header_len;
  int32_t n = 0;
  bool found = false;
  for (uint32_t t = 0; t < n_tracks; ++t) {
    if (pos + 8 > size || std::memcmp(buf + pos, "MTrk", 4) != 0) return kDeclined;
    uint64_t length = big_endian(buf + pos + 4, 4);
    if (length > size - pos - 8) return kDeclined;
    bool has_notes = false;
    if (!walk_track(buf + pos + 8, length, found ? nullptr : out, max_len, &n, &has_notes))
      return kDeclined;
    found = found || has_notes;
    pos += 8 + length;
  }
  return found ? n : kDeclined;
}

}  // extern "C"
