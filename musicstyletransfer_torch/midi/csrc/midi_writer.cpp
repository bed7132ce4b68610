// Token rows -> one single-track Standard MIDI File a row, all rows in one
// call, and each row's event ids (bound by
// musicstyletransfer_torch/midi/native_writer.py).
//
// Each file is byte for byte what the Python writer gives for the row,
// smf.dump_midifile(MelodyWriter().to_midifile(melody_from_ids(row))):
// MThd (format 1, one track, the resolution), then one MTrk holding a
// SetTempo at tick 0, a note-on (velocity 127) or note-off (velocity 64) on
// channel 0 for every note token, each carrying the ticks of the time
// shifts since the previous note as its delta, and an EndOfTrack at delta
// 1. Specials and ids past the time-shift range write nothing. A row's event
// ids are its ids that are no special (melody_from_ids's filter). The
// vocabulary is midi/vocab.py's.

#include <cstdint>

namespace {

constexpr int32_t kFeatureOffset = 3;
constexpr int64_t kNoteOnFirst = 3;  // note-ons 3-130, then note-offs 131-258
constexpr int64_t kShiftFirst = 259, kShiftLast = 292;
constexpr uint64_t kTicksPerBin = 30;

// MThd + MTrk header + SetTempo + EndOfTrack.
constexpr int64_t kFileOverhead = 14 + 8 + 7 + 4;
// A note event: a delta of at most ten 7-bit groups and three bytes.
constexpr int64_t kNoteMax = 10 + 3;

inline uint8_t* put_varlen(uint8_t* p, uint64_t value) {
  uint8_t groups[10];
  int n = 0;
  groups[n++] = value & 0x7F;
  value >>= 7;
  while (value) {
    groups[n++] = 0x80 | (value & 0x7F);
    value >>= 7;
  }
  while (n) *p++ = groups[--n];
  return p;
}

inline uint8_t* put_be(uint8_t* p, uint32_t value, int bytes) {
  for (int i = bytes - 1; i >= 0; --i) *p++ = (value >> (8 * i)) & 0xFF;
  return p;
}

// Whether the row offsets never fall and lie within [0, n_tokens].
bool offsets_ok(const int64_t* row_offsets, int32_t n_rows, int64_t n_tokens) {
  if (n_rows < 0 || row_offsets[0] < 0) return false;
  for (int32_t r = 0; r < n_rows; ++r) {
    if (row_offsets[r + 1] < row_offsets[r]) return false;
  }
  return row_offsets[n_rows] <= n_tokens;
}

}  // namespace

extern "C" {

// The bytes that n_tokens tokens in n_rows rows can take at most.
int64_t mst_midi_capacity(int64_t n_rows, int64_t n_tokens) {
  return n_rows * kFileOverhead + n_tokens * kNoteMax;
}

// Copies the ids >= kFeatureOffset of row r (tokens[row_offsets[r]:
// row_offsets[r + 1]]) to ids[id_offsets[r]:id_offsets[r + 1]]; ids holds
// n_tokens entries, id_offsets n_rows + 1. Returns the ids kept, or -2 where
// the offsets fall or leave [0, n_tokens].
int64_t mst_event_ids(const int32_t* tokens, int64_t n_tokens, const int64_t* row_offsets,
                      int32_t n_rows, int32_t* ids, int64_t* id_offsets) {
  if (!offsets_ok(row_offsets, n_rows, n_tokens)) return -2;
  int64_t k = 0;
  for (int32_t r = 0; r < n_rows; ++r) {
    id_offsets[r] = k;
    for (int64_t i = row_offsets[r]; i < row_offsets[r + 1]; ++i) {
      if (tokens[i] >= kFeatureOffset) ids[k++] = tokens[i];
    }
  }
  id_offsets[n_rows] = k;
  return k;
}

// Writes row r (tokens[row_offsets[r]:row_offsets[r + 1]]) as one SMF file
// at out[file_offsets[r]:file_offsets[r + 1]]; file_offsets holds n_rows + 1
// entries. Returns the bytes written, -1 where capacity (at least
// mst_midi_capacity's) is too small, or -2 where the offsets fall or leave
// [0, n_tokens].
int64_t mst_write_midi_rows(const int32_t* tokens, int64_t n_tokens, const int64_t* row_offsets,
                            int32_t n_rows, int32_t resolution, int32_t mpqn, uint8_t* out,
                            int64_t capacity, int64_t* file_offsets) {
  if (!offsets_ok(row_offsets, n_rows, n_tokens)) return -2;
  if (capacity < mst_midi_capacity(n_rows, row_offsets[n_rows] - row_offsets[0])) return -1;
  uint8_t* p = out;
  for (int32_t r = 0; r < n_rows; ++r) {
    file_offsets[r] = p - out;
    static const uint8_t kHeader[] = {'M', 'T', 'h', 'd', 0, 0, 0, 6, 0, 1, 0, 1};
    for (uint8_t b : kHeader) *p++ = b;
    p = put_be(p, static_cast<uint32_t>(resolution), 2);
    *p++ = 'M'; *p++ = 'T'; *p++ = 'r'; *p++ = 'k';
    uint8_t* length = p;
    p += 4;
    uint8_t* body = p;
    *p++ = 0x00; *p++ = 0xFF; *p++ = 0x51; *p++ = 0x03;
    p = put_be(p, static_cast<uint32_t>(mpqn), 3);
    uint64_t delay = 0;
    const int32_t* row_end = tokens + row_offsets[r + 1];  // read once: the byte stores may alias
    for (const int32_t* it = tokens + row_offsets[r]; it < row_end; ++it) {
      const int64_t t = *it;
      const uint64_t note = static_cast<uint64_t>(t - kNoteOnFirst);  // on [0, 128), off [128, 256)
      if (note < 256) {
        const bool off = note >= 128;
        if (delay < 0x80) {
          *p++ = static_cast<uint8_t>(delay);
        } else {
          p = put_varlen(p, delay);
        }
        p[0] = off ? 0x80 : 0x90;
        p[1] = static_cast<uint8_t>(note & 0x7F);
        p[2] = off ? 64 : 127;
        p += 3;
        delay = 0;
      } else if (t >= kShiftFirst && t <= kShiftLast) {
        delay += static_cast<uint64_t>(t - kShiftFirst) * kTicksPerBin;
      }
    }
    *p++ = 0x01; *p++ = 0xFF; *p++ = 0x2F; *p++ = 0x00;
    put_be(length, static_cast<uint32_t>(p - body), 4);
  }
  file_offsets[n_rows] = p - out;
  return p - out;
}

}  // extern "C"
