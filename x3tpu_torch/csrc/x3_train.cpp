// The seed trainer of the port: a copy of what x3h_train_ranked and
// x3h_train_tape need from native/x3host.cpp (the JAX package's host
// codec): its Dict, its find_best_match and the hit/miss walk of
// Codec::encode, then Codec::dump_dict(..., order=1).  It encodes a sample
// and returns the dictionary fragments the sample used most, hottest
// first, ties in insertion order; x3h_train_tape also returns the walk's
// events as seed indices, the warm-start tape (x3tpu_torch/warm.py).
//
// Only what training needs is copied.  The models, the contexts and the
// arithmetic coder shape the stream but never which fragments enter the
// dictionary or how often each is used: a hit or a miss follows from the
// dictionary probe and the window scan alone (x3.c:381-383).  Entries are
// zero-filled past their length, so the strings a caller gets are
// zero-padded.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC x3_train.cpp
// (x3tpu_torch/host.py builds it at first use).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxMatch = 32;  // backend.h:6-10

struct Params {
  int max_match_count;  // -t, backend.c:21
  int64_t window;       // -w, backend.c:8
  int64_t factor1;      // -m, backend.c:33
  int64_t factor2;      // -n, backend.c:34
  int nl_remap;         // -x, x3.c:357-370
};

struct Entry {
  uint8_t s[kMaxMatch];
  int len;
};

// The dictionary by insertion tag with a per-length hash index for the
// longest-prefix probe (x3host.cpp Dict), and each tag's use count.
class Dict {
 public:
  size_t size() const { return entries_.size(); }
  // longest entry that prefixes text (dict.c:105-130); -1 if none
  long find(const uint8_t* text) const {
    for (int l = kMaxMatch; l >= 1; --l) {
      const auto& m = by_len_[l];
      if (m.empty()) continue;
      auto it = m.find(fnv(text, l));
      if (it == m.end()) continue;
      for (size_t t : it->second)
        if (std::memcmp(text, entries_[t].s, l) == 0) return long(t);
    }
    return -1;
  }
  bool has_exact(const uint8_t* frag, int len) const {  // dict.c:148-157
    auto it = by_len_[len].find(fnv(frag, len));
    if (it == by_len_[len].end()) return false;
    for (size_t t : it->second)
      if (std::memcmp(frag, entries_[t].s, len) == 0) return true;
    return false;
  }
  void insert(const uint8_t* frag, int len) {
    Entry e{};
    std::memcpy(e.s, frag, len);
    e.len = len;
    entries_.push_back(e);
    uses_.push_back(0);
    by_len_[len][fnv(frag, len)].push_back(entries_.size() - 1);
  }
  void touch(size_t tag) { ++uses_[tag]; }
  uint64_t uses(size_t tag) const { return uses_[tag]; }
  int len_of(size_t tag) const { return entries_[tag].len; }
  const uint8_t* str_of(size_t tag) const { return entries_[tag].s; }

 private:
  static uint64_t fnv(const uint8_t* p, int len) {
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < len; ++i) { h ^= p[i]; h *= 1099511628211ull; }
    return h;
  }
  std::vector<Entry> entries_;
  std::vector<uint64_t> uses_;
  std::array<std::unordered_map<uint64_t, std::vector<size_t>>,
             kMaxMatch + 1> by_len_;
};

// window scan + threshold sweep + magic vetoes (backend.c:56-100)
size_t find_best_match(const Params& prm, const Dict& dict,
                       const uint8_t* p) {
  size_t count[kMaxMatch] = {0};
  const uint8_t* end = p + prm.window;
  for (const uint8_t* s = p + 1; s < end - kMaxMatch; ++s) {
    for (int i = 0; i < kMaxMatch; ++i) {
      if (p[i] == s[i]) ++count[i]; else break;
    }
  }
  for (int tc = prm.max_match_count; tc > 0; --tc) {
    for (int i = kMaxMatch - 1; i >= 0; --i) {
      if (count[i] > size_t(tc)) {
        if (i >= 2 && prm.factor1 > 0) {
          long d = dict.find(p + i);
          if (d != -1 && uint64_t(dict.len_of(d)) * prm.factor1 >
                             uint64_t(i + 1))
            continue;  // backend.c:79-83
        }
        if (i >= 1 && prm.factor2 > 0) {
          bool vetoed = false;
          for (int o = 1; o <= i; ++o) {
            long d = dict.find(p + o);
            if (d != -1 &&
                (long(dict.len_of(d)) - o) * long(prm.factor2) > i + 1) {
              vetoed = true;  // backend.c:84-90
              break;
            }
          }
          if (vetoed) continue;
        }
        return size_t(i) + 1;
      }
    }
  }
  return 1;
}

size_t nl(const Params& prm, size_t len) {  // x3.c:357-370
  if (!prm.nl_remap) return len;
  switch (len - 1) { case 0: return 1; case 1: return 4;
                     case 2: return 6; case 3: return 8; default: return 9999; }
}

// The dictionary Codec::encode leaves behind, with its use counts.  Where
// tape is not null, one entry an event is appended to it: the hit's tag,
// or -1 for a new fragment (E_NEW resets the context chain, x3.c:423-425;
// x3host.cpp records the same at :620 and :626).
void walk(const Params& prm, const uint8_t* data, size_t size, Dict& dict,
          std::vector<long>* tape = nullptr) {
  // zero-pad the tail so window scans never read past the buffer
  std::vector<uint8_t> buf(size + size_t(prm.window) + kMaxMatch, 0);
  if (size) std::memcpy(buf.data(), data, size);
  const uint8_t* base = buf.data();
  for (size_t p = 0; p < size;) {
    const long tag = dict.find(base + p);  // x3.c:381
    const size_t dlen = tag >= 0 ? size_t(dict.len_of(tag)) : 0;
    const size_t best = find_best_match(prm, dict, base + p);
    if (tag >= 0 && nl(prm, dlen) >= best && p + dlen <= size) {
      dict.touch(size_t(tag));  // a hit: move-to-front, one more use
      if (tape) tape->push_back(tag);
      p += dlen;
    } else {  // a new fragment (x3.c:398-428)
      if (tape) tape->push_back(-1);
      size_t len = best;
      if (p + len > size) len = size - p;
      if (!dict.has_exact(base + p, int(len))) dict.insert(base + p, int(len));
      p += len;
    }
  }
}

// The k most used tags, by descending use count, ties in insertion order
// (x3host.cpp dump_order(k, 1)), written as seeds (strs: k x 32 bytes,
// zero-padded; lens: k).  Returns the kept tags.
std::vector<size_t> dump_ranked(const Dict& dict, size_t k, uint8_t* strs,
                                int32_t* lens) {
  std::vector<size_t> tags(dict.size());
  for (size_t t = 0; t < tags.size(); ++t) tags[t] = t;
  std::stable_sort(tags.begin(), tags.end(), [&dict](size_t a, size_t b) {
    return dict.uses(a) > dict.uses(b);
  });
  tags.resize(std::min(dict.size(), k));
  for (size_t i = 0; i < tags.size(); ++i) {
    std::memcpy(strs + i * kMaxMatch, dict.str_of(tags[i]), kMaxMatch);
    lens[i] = dict.len_of(tags[i]);
  }
  return tags;
}

}  // namespace

extern "C" {

// Encode a sample and write its k most used dictionary fragments (strs:
// k x 32 bytes, zero-padded; lens: k), by descending use count, ties in
// insertion order (x3host.cpp x3h_train_ranked).  Returns the number
// written.
size_t x3h_train_ranked(const uint8_t* data, size_t size,
                        int max_match_count, long window, long factor1,
                        long factor2, int nl_remap, uint8_t* strs,
                        int32_t* lens, size_t k) {
  const Params prm{max_match_count, window, factor1, factor2, nl_remap};
  Dict dict;
  walk(prm, data, size, dict);
  return dump_ranked(dict, k, strs, lens).size();
}

// As x3h_train_ranked, and the warm-start tape (x3host.cpp
// x3h_train_tape): one i32 a training event, the kept-seed index of the
// hit's tag, or -1 for a new fragment or a tag not kept (map_tape).  At
// most tape_cap entries, the head of the sequence; *tape_len gets the
// count written.  Returns the seed count.
size_t x3h_train_tape(const uint8_t* data, size_t size, int max_match_count,
                      long window, long factor1, long factor2, int nl_remap,
                      uint8_t* strs, int32_t* lens, size_t k, int32_t* tape,
                      size_t tape_cap, size_t* tape_len) {
  const Params prm{max_match_count, window, factor1, factor2, nl_remap};
  Dict dict;
  std::vector<long> raw;
  walk(prm, data, size, dict, &raw);
  const std::vector<size_t> kept = dump_ranked(dict, k, strs, lens);
  std::unordered_map<size_t, int32_t> index;
  for (size_t i = 0; i < kept.size(); ++i) index.emplace(kept[i], int32_t(i));
  const size_t n = std::min(raw.size(), tape_cap);
  for (size_t i = 0; i < n; ++i) {
    const auto it = raw[i] >= 0 ? index.find(size_t(raw[i])) : index.end();
    tape[i] = it == index.end() ? -1 : it->second;
  }
  *tape_len = n;
  return kept.size();
}

}  // extern "C"
