// Native subword tokenizer: BPE training + greedy longest-match encode.
//
// C++ twin of transformer_tpu_torch/data/tokenizer.py (the reference implementation
// and fallback) — the capability counterpart of the native tokenizer the
// reference inherits from tfds (`SubwordTextEncoder.build_from_corpus`,
// reference utils.py:96-111, implemented in TF's C++/py runtime). Both paths
// must produce bit-identical vocabularies and id sequences;
// tests/test_torch_native.py asserts parity.
//
// Conventions (mirroring tokenizer.py):
//   - id 0 is pad and never produced; piece ids run 1..n_pieces.
//   - each whitespace-split word is escaped per codepoint ('_' -> "\u",
//     '\\' -> "\\\\", '<' -> "\<") and suffixed with the word-end marker '_'.
//   - unseen codepoints fall back to byte tokens "<0xNN>", always in the
//     alphabet.
//
// The API crosses the C boundary with '\n'-joined words/pieces: words and
// pieces can never contain whitespace (words are whitespace-split upstream and
// escapes introduce none), so '\n' is an unambiguous separator.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

inline size_t utf8_len(unsigned char lead) {
  if (lead < 0x80) return 1;
  if (lead < 0xE0) return 2;  // 0xC0..0xDF
  if (lead < 0xF0) return 3;
  if (lead < 0xF8) return 4;
  return 1;  // invalid lead byte: consume one byte
}

// Escape one word and append the word-end marker, exactly like
// tokenizer._word_to_symbols joined: per-codepoint escaping of '_', '\\', '<'.
void append_escaped_word(const std::string &word, std::string *out) {
  size_t i = 0;
  while (i < word.size()) {
    unsigned char c = word[i];
    if (c == '_') {
      *out += "\\u";
      ++i;
    } else if (c == '\\') {
      *out += "\\\\";
      ++i;
    } else if (c == '<') {
      *out += "\\<";
      ++i;
    } else {
      size_t L = std::min(utf8_len(c), word.size() - i);
      out->append(word, i, L);
      i += L;
    }
  }
  out->push_back('_');
}

// ----------------------------------------------------------------- encoder

struct TrieNode {
  std::unordered_map<uint8_t, int32_t> kids;
  int32_t piece_id = 0;  // 0 = not a piece end
};

struct Tokenizer {
  std::vector<std::string> pieces;  // index i -> id i+1
  std::vector<TrieNode> trie;      // node 0 = root; byte-labelled edges
  int32_t byte_ids[256];

  void build_index() {
    trie.clear();
    trie.emplace_back();
    for (size_t i = 0; i < pieces.size(); ++i) {
      int32_t node = 0;
      for (unsigned char c : pieces[i]) {
        auto it = trie[node].kids.find(c);
        if (it == trie[node].kids.end()) {
          trie.emplace_back();
          int32_t nn = static_cast<int32_t>(trie.size()) - 1;
          trie[node].kids.emplace(c, nn);
          node = nn;
        } else {
          node = it->second;
        }
      }
      trie[node].piece_id = static_cast<int32_t>(i) + 1;
    }
    char buf[8];
    for (int b = 0; b < 256; ++b) {
      std::snprintf(buf, sizeof buf, "<0x%02X>", b);
      byte_ids[b] = find_piece(buf);
    }
  }

  int32_t find_piece(const char *s) const {
    int32_t node = 0;
    for (const char *p = s; *p; ++p) {
      auto it = trie[node].kids.find(static_cast<uint8_t>(*p));
      if (it == trie[node].kids.end()) return 0;
      node = it->second;
    }
    return trie[node].piece_id;
  }

  // Greedy longest match over the escaped word string. A trie walk finds the
  // longest matching piece in bytes; since pieces are valid UTF-8 and matching
  // starts at a codepoint boundary, longest-in-bytes == longest-in-codepoints,
  // i.e. identical to the Python scan over text[i:j] char slices.
  void encode_escaped(const std::string &text, std::vector<int32_t> *out) const {
    size_t i = 0, n = text.size();
    while (i < n) {
      int32_t node = 0, best_id = 0;
      size_t best_end = i, j = i;
      while (j < n) {
        auto it = trie[node].kids.find(static_cast<uint8_t>(text[j]));
        if (it == trie[node].kids.end()) break;
        node = it->second;
        ++j;
        if (trie[node].piece_id) {
          best_id = trie[node].piece_id;
          best_end = j;
        }
      }
      if (best_id) {
        out->push_back(best_id);
        i = best_end;
      } else {
        size_t L = std::min(utf8_len(static_cast<unsigned char>(text[i])), n - i);
        for (size_t k = 0; k < L; ++k)
          out->push_back(byte_ids[static_cast<uint8_t>(text[i + k])]);
        i += L;
      }
    }
  }
};

// ----------------------------------------------------------------- trainer

// Interned symbol strings: pair comparisons in the merge heap must order by
// the *string* contents (matching Python's tuple comparison of str pairs,
// which UTF-8 byte order reproduces exactly).
struct StrPool {
  std::vector<std::string> strs;
  std::unordered_map<std::string, int32_t> ids;

  int32_t get(const std::string &s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    strs.push_back(s);
    int32_t id = static_cast<int32_t>(strs.size()) - 1;
    ids.emplace(s, id);
    return id;
  }
};

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct HeapEntry {
  int64_t count;
  int32_t a, b;
};

struct Trainer {
  StrPool pool;
  std::vector<std::vector<int32_t>> words;
  std::vector<int64_t> freqs;
  std::unordered_map<uint64_t, int64_t> pair_counts;
  std::unordered_map<uint64_t, std::unordered_set<int32_t>> pair_words;

  struct Cmp {
    const StrPool *pool;
    // priority_queue top = "largest": highest count first, then the
    // lexicographically smallest (a, b) string pair (heapq pops min of
    // (-count, pair)).
    bool operator()(const HeapEntry &x, const HeapEntry &y) const {
      if (x.count != y.count) return x.count < y.count;
      int c = pool->strs[x.a].compare(pool->strs[y.a]);
      if (c != 0) return c > 0;
      return pool->strs[x.b].compare(pool->strs[y.b]) > 0;
    }
  };
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, Cmp> heap;

  Trainer() : heap(Cmp{&pool}) {}

  void bump(int32_t a, int32_t b, int64_t delta, int32_t wi) {
    uint64_t key = pair_key(a, b);
    auto it = pair_counts.find(key);
    int64_t c = (it == pair_counts.end() ? 0 : it->second) + delta;
    if (c <= 0) {
      if (it != pair_counts.end()) pair_counts.erase(it);
    } else {
      pair_counts[key] = c;
      heap.push({c, a, b});
    }
    if (delta > 0) pair_words[key].insert(wi);
  }

  // corpus: '\n'-joined *unique* words in first-occurrence order (Counter
  // insertion order upstream), with a parallel frequency array — so the
  // payload is O(unique words), not O(corpus tokens).
  Tokenizer *train(const char *corpus, int64_t len, const int64_t *counts,
                   int64_t n_words, int32_t target_vocab,
                   int32_t min_pair_count) {
    std::vector<std::string> uniq;
    std::vector<int64_t> uniq_freq;
    uniq.reserve(static_cast<size_t>(n_words));
    uniq_freq.reserve(static_cast<size_t>(n_words));
    {
      const char *p = corpus, *end = corpus + len;
      int64_t wi = 0;
      while (p < end && wi < n_words) {
        const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
        size_t wl = (nl ? nl : end) - p;
        if (wl > 0) {
          uniq.emplace_back(p, wl);
          uniq_freq.push_back(counts[wi]);
          ++wi;
        }
        p = nl ? nl + 1 : end;
      }
    }

    // Alphabet, insertion-ordered: 256 byte tokens, the three escape pieces,
    // the word-end marker, then every symbol as first seen across words.
    std::vector<int32_t> vocab_order;
    std::unordered_set<int32_t> vocab_set;
    auto add_vocab = [&](const std::string &s) {
      int32_t id = pool.get(s);
      if (vocab_set.insert(id).second) vocab_order.push_back(id);
      return id;
    };
    char buf[8];
    for (int b = 0; b < 256; ++b) {
      std::snprintf(buf, sizeof buf, "<0x%02X>", b);
      add_vocab(buf);
    }
    add_vocab("\\u");
    add_vocab("\\\\");
    add_vocab("\\<");
    add_vocab("_");

    // Word symbol sequences (per-codepoint, escaped, '_'-terminated).
    words.reserve(uniq.size());
    freqs = std::move(uniq_freq);
    for (const std::string &w : uniq) {
      std::string esc;
      append_escaped_word(w, &esc);
      std::vector<int32_t> seq;
      size_t i = 0;
      while (i < esc.size()) {
        size_t L;
        unsigned char c = esc[i];
        if (c == '\\' && i + 1 < esc.size())
          L = 2;  // escape pieces are single symbols
        else
          L = std::min(utf8_len(c), esc.size() - i);
        seq.push_back(add_vocab(esc.substr(i, L)));
        i += L;
      }
      words.push_back(std::move(seq));
    }

    // Initial pair statistics + heap.
    for (size_t wi = 0; wi < words.size(); ++wi) {
      const auto &seq = words[wi];
      int64_t f = freqs[wi];
      for (size_t i = 0; i + 1 < seq.size(); ++i) {
        uint64_t key = pair_key(seq[i], seq[i + 1]);
        pair_counts[key] += f;
        pair_words[key].insert(static_cast<int32_t>(wi));
      }
    }
    for (const auto &kv : pair_counts) {
      int32_t a = static_cast<int32_t>(kv.first >> 32);
      int32_t b = static_cast<int32_t>(kv.first & 0xFFFFFFFFu);
      heap.push({kv.second, a, b});
    }

    // Merge loop — identical control flow to the Python trainer (lazy heap
    // with stale-entry skip, neighbour-pair incremental updates).
    while (static_cast<int64_t>(vocab_order.size()) < target_vocab &&
           !heap.empty()) {
      HeapEntry e = heap.top();
      heap.pop();
      uint64_t key = pair_key(e.a, e.b);
      auto it = pair_counts.find(key);
      if (it == pair_counts.end() || it->second != e.count) continue;  // stale
      if (e.count < min_pair_count) break;
      std::string merged_str = pool.strs[e.a] + pool.strs[e.b];
      int32_t merged = pool.get(merged_str);
      if (vocab_set.insert(merged).second) vocab_order.push_back(merged);
      pair_counts.erase(key);
      std::vector<int32_t> affected;
      {
        auto pw = pair_words.find(key);
        if (pw != pair_words.end()) {
          affected.assign(pw->second.begin(), pw->second.end());
          pair_words.erase(pw);
        }
      }
      for (int32_t wi : affected) {
        std::vector<int32_t> &seq = words[wi];
        int64_t f = freqs[wi];
        std::vector<int32_t> out;
        out.reserve(seq.size());
        bool changed = false;
        size_t i = 0;
        while (i < seq.size()) {
          if (i + 1 < seq.size() && seq[i] == e.a && seq[i + 1] == e.b) {
            if (!out.empty()) {
              bump(out.back(), e.a, -f, wi);
              bump(out.back(), merged, f, wi);
            }
            if (i + 2 < seq.size()) {
              bump(e.b, seq[i + 2], -f, wi);
              bump(merged, seq[i + 2], f, wi);
            }
            out.push_back(merged);
            i += 2;
            changed = true;
          } else {
            out.push_back(seq[i]);
            ++i;
          }
        }
        if (changed) seq = std::move(out);
      }
    }

    Tokenizer *tok = new Tokenizer();
    tok->pieces.reserve(vocab_order.size());
    for (int32_t id : vocab_order) tok->pieces.push_back(pool.strs[id]);
    tok->build_index();
    return tok;
  }
};

}  // namespace

extern "C" {

// pieces_blob: '\n'-joined piece strings, ids assigned 1..n in order.
void *tpu_tok_create(const char *pieces_blob, int64_t blob_len) {
  Tokenizer *tok = new Tokenizer();
  const char *p = pieces_blob, *end = pieces_blob + blob_len;
  while (p < end) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
    size_t n = (nl ? nl : end) - p;
    if (n > 0) tok->pieces.emplace_back(p, n);
    p = nl ? nl + 1 : end;
  }
  tok->build_index();
  return tok;
}

// corpus: '\n'-joined unique words in first-occurrence order with a parallel
// counts array (whitespace splitting and counting stay upstream so Python
// str.split()/Counter semantics are preserved exactly).
void *tpu_tok_train(const char *corpus, int64_t len, const int64_t *counts,
                    int64_t n_words, int32_t target_vocab,
                    int32_t min_pair_count) {
  Trainer tr;
  return tr.train(corpus, len, counts, n_words, target_vocab, min_pair_count);
}

void tpu_tok_free(void *t) { delete static_cast<Tokenizer *>(t); }

int32_t tpu_tok_num_pieces(void *t) {
  return static_cast<int32_t>(static_cast<Tokenizer *>(t)->pieces.size());
}

// Writes the '\n'-joined pieces into buf (if cap suffices); returns the
// required byte count.
int64_t tpu_tok_pieces_blob(void *t, char *buf, int64_t cap) {
  Tokenizer *tok = static_cast<Tokenizer *>(t);
  int64_t need = 0;
  for (const auto &p : tok->pieces) need += static_cast<int64_t>(p.size()) + 1;
  if (need > cap || buf == nullptr) return need;
  char *w = buf;
  for (const auto &p : tok->pieces) {
    memcpy(w, p.data(), p.size());
    w += p.size();
    *w++ = '\n';
  }
  return need;
}

// words: '\n'-joined words of one text. Returns the number of ids produced;
// if it exceeds cap the caller must retry with a larger buffer (out is only
// valid up to min(returned, cap)).
int64_t tpu_tok_encode(void *t, const char *words, int64_t len, int32_t *out,
                       int64_t cap) {
  Tokenizer *tok = static_cast<Tokenizer *>(t);
  std::vector<int32_t> ids;
  ids.reserve(static_cast<size_t>(len) + 8);
  std::string esc;
  const char *p = words, *end = words + len;
  while (p < end) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
    size_t n = (nl ? nl : end) - p;
    if (n > 0) {
      esc.clear();
      append_escaped_word(std::string(p, n), &esc);
      tok->encode_escaped(esc, &ids);
    }
    p = nl ? nl + 1 : end;
  }
  int64_t count = static_cast<int64_t>(ids.size());
  if (out != nullptr && cap > 0)
    memcpy(out, ids.data(),
           static_cast<size_t>(std::min(count, cap)) * sizeof(int32_t));
  return count;
}

}  // extern "C"
