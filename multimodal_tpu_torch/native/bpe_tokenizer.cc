// Native CLIP byte-pair-encoding tokenizer (ASCII fast path), the port's own copy of the
// JAX package's native/bpe_tokenizer.cc.
//
// Bit-identical to the Python tokenizer (``data/tokenizer.py``) for ASCII captions without
// HTML entities, which is most of CC12M / LAION text. A caption with a non-ASCII byte or an
// '&' (or any byte outside printable ASCII and whitespace) makes the whole batch come back
// unwritten, and the bindings run the Python tokenizer on it: Unicode normalization and HTML
// unescaping stay in Python.
//
// Per caption: whitespace collapse + lowercase -> CLIP's word pattern, hand-compiled for
// ASCII (the special literals, contractions 's 't 're 've 'm 'll 'd, letter runs, single
// digits, runs of everything else) -> the byte-to-unicode table (the identity on printable
// ASCII) -> iterative lowest-rank pair merges with a per-word cache -> ids, SOT/EOT framing,
// zero padding, truncation that keeps EOT in the last slot.
//
// Unlike the reference's copy this one links nothing beyond the C++ standard library: the
// caller reads the gzipped vocabulary and hands its text to mm_bpe_create as a buffer.
// C ABI consumed through ctypes (native/bindings.py).

#include <cctype>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumMerges = 49152 - 256 - 2;  // the CLIP vocabulary's merge rules

struct Bpe {
  std::unordered_map<std::string, int> encoder;             // token string -> id
  std::unordered_map<std::string, int> merge_rank;          // "a b" -> rank
  std::unordered_map<std::string, std::vector<int>> cache;  // word -> ids
  std::mutex cache_mu;
  int sot = 0, eot = 0;
};

// The byte-to-unicode table is the identity on printable ASCII ('!'..'~'), the only bytes a
// word of the fast path holds.
bool ascii_identity(unsigned char b) { return b >= '!' && b <= '~'; }

Bpe* build(const char* text, int64_t len) {
  if (text == nullptr || len <= 0) return nullptr;
  const std::string data(text, static_cast<size_t>(len));
  auto bpe = new Bpe();
  // Vocabulary layout: 256 byte characters, the same 256 with "</w>", one token a merge rule,
  // then the two specials. Only the tokens ASCII input can reach are kept; the ids keep the
  // full layout. Printable ASCII comes first in the byte table, in order: ids 0..93.
  for (unsigned char b = '!'; b <= '~'; ++b) {
    const int idx = b - '!';
    const std::string ch(1, static_cast<char>(b));
    bpe->encoder[ch] = idx;
    bpe->encoder[ch + "</w>"] = 256 + idx;
  }
  // merge rules: lines 1..kNumMerges (line 0 is a version header)
  size_t pos = data.find('\n');
  int rank = 0;
  while (pos != std::string::npos && rank < kNumMerges) {
    const size_t end = data.find('\n', pos + 1);
    const std::string line =
        data.substr(pos + 1, end == std::string::npos ? std::string::npos : end - pos - 1);
    pos = end;
    if (line.empty()) break;
    const size_t space = line.find(' ');
    if (space == std::string::npos) {
      delete bpe;
      return nullptr;
    }
    bpe->merge_rank[line] = rank;
    std::string merged = line;
    merged.erase(space, 1);
    bpe->encoder[merged] = 512 + rank;  // after the two blocks of 256 byte tokens
    ++rank;
  }
  if (rank != kNumMerges) {
    delete bpe;
    return nullptr;
  }
  bpe->sot = 512 + kNumMerges;      // <|startoftext|> = 49406
  bpe->eot = 512 + kNumMerges + 1;  // <|endoftext|>   = 49407
  bpe->encoder["<|startoftext|>"] = bpe->sot;
  bpe->encoder["<|endoftext|>"] = bpe->eot;
  // the special literals skip the merge loop, as the Python tokenizer's seeded cache does
  bpe->cache["<|startoftext|>"] = {bpe->sot};
  bpe->cache["<|endoftext|>"] = {bpe->eot};
  return bpe;
}

// The merge loop over one word: merge every occurrence of the lowest-ranked adjacent pair,
// left to right, until no pair has a rank. Empty ids signal a token outside the encoder.
std::vector<int> bpe_word(Bpe* bpe, const std::string& word) {
  {
    std::lock_guard<std::mutex> lock(bpe->cache_mu);
    auto it = bpe->cache.find(word);
    if (it != bpe->cache.end()) return it->second;
  }
  std::vector<std::string> parts;
  for (size_t i = 0; i < word.size(); ++i) {
    std::string p(1, word[i]);
    if (i + 1 == word.size()) p += "</w>";
    parts.push_back(p);
  }
  while (parts.size() > 1) {
    int best_rank = INT_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      auto it = bpe->merge_rank.find(parts[i] + " " + parts[i + 1]);
      if (it != bpe->merge_rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT_MAX) break;
    const std::string a = parts[best_i], b = parts[best_i + 1];
    std::vector<std::string> merged;
    for (size_t i = 0; i < parts.size();) {
      if (i + 1 < parts.size() && parts[i] == a && parts[i + 1] == b) {
        merged.push_back(a + b);
        i += 2;
      } else {
        merged.push_back(parts[i]);
        i += 1;
      }
    }
    parts.swap(merged);
  }
  std::vector<int> ids;
  ids.reserve(parts.size());
  for (auto& p : parts) {
    auto it = bpe->encoder.find(p);
    if (it == bpe->encoder.end()) return {};
    ids.push_back(it->second);
  }
  {
    std::lock_guard<std::mutex> lock(bpe->cache_mu);
    bpe->cache.emplace(word, ids);
  }
  return ids;
}

inline bool is_alpha(char c) { return std::isalpha(static_cast<unsigned char>(c)); }
inline bool is_digit(char c) { return std::isdigit(static_cast<unsigned char>(c)); }
inline bool is_space(char c) { return std::isspace(static_cast<unsigned char>(c)); }

// CLIP's word pattern over lowercased ASCII, its alternatives in order: the special
// literals, the contractions, a letter run, one digit, a run of anything else but
// whitespace, letters and digits.
void split_words(const std::string& text, std::vector<std::string>* out) {
  static const std::string kSot = "<|startoftext|>", kEot = "<|endoftext|>";
  size_t i = 0;
  const size_t n = text.size();
  while (i < n) {
    if (is_space(text[i])) {
      ++i;
      continue;
    }
    if (text.compare(i, kSot.size(), kSot) == 0) {
      out->push_back(kSot);
      i += kSot.size();
      continue;
    }
    if (text.compare(i, kEot.size(), kEot) == 0) {
      out->push_back(kEot);
      i += kEot.size();
      continue;
    }
    // a contraction wins wherever the scan stands on its apostrophe (no word boundaries)
    if (text[i] == '\'' && i + 1 < n) {
      const char c1 = text[i + 1];
      const char c2 = i + 2 < n ? text[i + 2] : '\0';
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') {
        out->push_back(text.substr(i, 2));
        i += 2;
        continue;
      }
      if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') || (c1 == 'l' && c2 == 'l')) {
        out->push_back(text.substr(i, 3));
        i += 3;
        continue;
      }
    }
    if (is_alpha(text[i])) {
      size_t j = i;
      while (j < n && is_alpha(text[j])) ++j;
      out->push_back(text.substr(i, j - i));
      i = j;
      continue;
    }
    if (is_digit(text[i])) {  // one digit a word
      out->push_back(text.substr(i, 1));
      ++i;
      continue;
    }
    // greedy: an apostrophe inside such a run belongs to the run
    size_t j = i;
    while (j < n && !is_space(text[j]) && !is_alpha(text[j]) && !is_digit(text[j])) ++j;
    out->push_back(text.substr(i, j - i));
    i = j;
  }
}

bool fast_eligible(const char* text, int64_t len) {
  for (int64_t i = 0; i < len; ++i) {
    const unsigned char c = static_cast<unsigned char>(text[i]);
    if (c >= 0x80 || c == '&') return false;
  }
  return true;
}

}  // namespace

extern "C" {

// A tokenizer over the vocabulary's text (the decompressed merge file), or null when the
// text does not hold the CLIP vocabulary's merge rules.
void* mm_bpe_create(const char* vocab_text, int64_t len) { return build(vocab_text, len); }

void mm_bpe_destroy(void* handle) { delete static_cast<Bpe*>(handle); }

// Tokenize n captions, caption s at blob[offsets[s] .. offsets[s + 1]), into
// out[n, context_length] int32: SOT, the ids, EOT, zeros; an over-long row is cut to
// context_length with EOT in its last slot. 0 on success; -1, with out not fully written,
// when a caption needs the Python tokenizer. Safe to call from many threads at once.
int mm_bpe_encode_batch(void* handle, const char* blob, const int64_t* offsets, int n,
                        int context_length, int32_t* out) {
  auto bpe = static_cast<Bpe*>(handle);
  if (context_length < 1) return -1;
  for (int s = 0; s < n; ++s) {
    if (!fast_eligible(blob + offsets[s], offsets[s + 1] - offsets[s])) return -1;
  }
  for (int s = 0; s < n; ++s) {
    const char* start = blob + offsets[s];
    const int64_t len = offsets[s + 1] - offsets[s];
    // lowercase, whitespace runs to one space, stripped at both ends
    std::string text;
    text.reserve(len);
    bool pending_space = false;
    for (int64_t i = 0; i < len; ++i) {
      const char c = start[i];
      if (is_space(c)) {
        if (!text.empty()) pending_space = true;
        continue;
      }
      if (pending_space) {
        text += ' ';
        pending_space = false;
      }
      text += static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
    }
    std::vector<std::string> words;
    split_words(text, &words);
    std::vector<int> ids;
    ids.push_back(bpe->sot);
    for (auto& w : words) {
      for (char c : w)
        if (!ascii_identity(static_cast<unsigned char>(c))) return -1;
      auto word_ids = bpe_word(bpe, w);
      if (word_ids.empty()) return -1;
      ids.insert(ids.end(), word_ids.begin(), word_ids.end());
    }
    ids.push_back(bpe->eot);
    if (static_cast<int>(ids.size()) > context_length) {
      ids.resize(context_length);
      ids.back() = bpe->eot;
    }
    int32_t* row = out + static_cast<int64_t>(s) * context_length;
    std::memset(row, 0, sizeof(int32_t) * context_length);
    std::copy(ids.begin(), ids.end(), row);
  }
  return 0;
}

}  // extern "C"
