// Native WordPiece tokenizer (BERT basic tokenizer + greedy wordpiece).
//
// First-party C++ replacement for the HF `tokenizers` Rust core the
// reference depended on (reference: vltk/dataset/basedataset.py:19-21,
// 225-343 instantiated BertWordPieceTokenizer by name). Tokenization is
// host-side ETL/loader work and a per-entry hot loop, so it lives in the
// native data plane (SURVEY §2.10 N5).
//
// Semantics: BERT basic tokenization (clean control chars, whitespace
// split, ASCII+Latin-1 lowercase, punctuation split, CJK char isolation)
// followed by greedy longest-match-first WordPiece with "##" continuation
// and a 100-char word cap -> [UNK]. Exact parity with
// BertWordPieceTokenizer(lowercase=True) on ASCII text; NFD accent
// stripping of non-ASCII letters is not implemented (the VQA/GQA/caption
// corpora the framework targets are ASCII-dominant).
//
// C ABI only — bound via ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = -1, cls_id = -1, sep_id = -1, pad_id = -1, mask_id = -1;
  bool lowercase = true;
  static constexpr int kMaxWordChars = 100;
};

// ---- UTF-8 helpers ---------------------------------------------------------

inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: treat as single char
}

inline uint32_t utf8_cp(const char* s, int len) {
  const unsigned char* u = reinterpret_cast<const unsigned char*>(s);
  switch (len) {
    case 1: return u[0];
    case 2: return ((u[0] & 0x1Fu) << 6) | (u[1] & 0x3Fu);
    case 3: return ((u[0] & 0x0Fu) << 12) | ((u[1] & 0x3Fu) << 6) | (u[2] & 0x3Fu);
    default:
      return ((u[0] & 0x07u) << 18) | ((u[1] & 0x3Fu) << 12) |
             ((u[2] & 0x3Fu) << 6) | (u[3] & 0x3Fu);
  }
}

inline bool is_whitespace(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0xA0 ||
         cp == 0x2009 || cp == 0x202F || cp == 0x3000;
}

inline bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp <= 0x9F);
}

// BERT treats all ASCII non-alnum as punctuation, plus unicode P* blocks
// (approximated by the common ranges).
inline bool is_punct(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  return (cp >= 0x2000 && cp <= 0x206F) ||   // general punctuation
         (cp >= 0x3000 && cp <= 0x303F) ||   // CJK punctuation
         (cp >= 0xFF00 && cp <= 0xFF0F) || (cp >= 0xFF1A && cp <= 0xFF20) ||
         (cp >= 0xFF3B && cp <= 0xFF40) || (cp >= 0xFF5B && cp <= 0xFF65);
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0xF900 && cp <= 0xFAFF);
}

// lowercase ASCII and Latin-1 uppercase letters in place of full casefold
inline uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 32;  // Latin-1
  return cp;
}

inline void append_cp(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out += static_cast<char>(cp);
  } else if (cp < 0x800) {
    out += static_cast<char>(0xC0 | (cp >> 6));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += static_cast<char>(0xE0 | (cp >> 12));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (cp >> 18));
    out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  }
}

// ---- basic tokenizer -------------------------------------------------------

void basic_tokenize(const WordPiece& wp, const char* text,
                    std::vector<std::string>* words) {
  std::string cur;
  size_t n = std::strlen(text);
  size_t i = 0;
  auto flush = [&]() {
    if (!cur.empty()) {
      words->push_back(cur);
      cur.clear();
    }
  };
  while (i < n) {
    int len = utf8_len(static_cast<unsigned char>(text[i]));
    if (i + len > n) len = 1;
    uint32_t cp = utf8_cp(text + i, len);
    i += len;
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) {
      flush();
      continue;
    }
    if (is_punct(cp) || is_cjk(cp)) {
      flush();
      std::string one;
      append_cp(one, wp.lowercase ? lower_cp(cp) : cp);
      words->push_back(one);
      continue;
    }
    append_cp(cur, wp.lowercase ? lower_cp(cp) : cp);
  }
  flush();
}

// ---- wordpiece -------------------------------------------------------------

// Greedy longest-match-first over utf-8 char boundaries.
void wordpiece_word(const WordPiece& wp, const std::string& word,
                    std::vector<int32_t>* ids) {
  // char start offsets
  std::vector<int> offs;
  for (size_t i = 0; i < word.size();) {
    offs.push_back(static_cast<int>(i));
    i += utf8_len(static_cast<unsigned char>(word[i]));
  }
  offs.push_back(static_cast<int>(word.size()));
  int nchars = static_cast<int>(offs.size()) - 1;
  if (nchars > WordPiece::kMaxWordChars) {
    ids->push_back(wp.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  int start = 0;
  while (start < nchars) {
    int end = nchars;
    int32_t cur_id = -1;
    while (end > start) {
      std::string sub = word.substr(offs[start], offs[end] - offs[start]);
      if (start > 0) sub = "##" + sub;
      auto it = wp.vocab.find(sub);
      if (it != wp.vocab.end()) {
        cur_id = it->second;
        break;
      }
      --end;
    }
    if (cur_id < 0) {
      ids->push_back(wp.unk_id);
      return;  // whole word becomes UNK (BERT behavior)
    }
    pieces.push_back(cur_id);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

void encode_one(const WordPiece& wp, const char* text,
                std::vector<int32_t>* ids) {
  std::vector<std::string> words;
  basic_tokenize(wp, text, &words);
  for (const auto& w : words) wordpiece_word(wp, w, ids);
}

}  // namespace

extern "C" {

void* vltk_wp_new(const char* vocab_path, int lowercase) {
  std::ifstream f(vocab_path);
  if (!f.is_open()) return nullptr;
  auto* wp = new WordPiece();
  wp->lowercase = lowercase != 0;
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    wp->vocab.emplace(line, idx++);
  }
  auto get = [&](const char* t) {
    auto it = wp->vocab.find(t);
    return it == wp->vocab.end() ? -1 : it->second;
  };
  wp->unk_id = get("[UNK]");
  wp->cls_id = get("[CLS]");
  wp->sep_id = get("[SEP]");
  wp->pad_id = get("[PAD]");
  wp->mask_id = get("[MASK]");
  if (wp->unk_id < 0) {
    delete wp;
    return nullptr;
  }
  return wp;
}

void vltk_wp_free(void* h) { delete static_cast<WordPiece*>(h); }

int32_t vltk_wp_vocab_size(void* h) {
  return static_cast<int32_t>(static_cast<WordPiece*>(h)->vocab.size());
}

int32_t vltk_wp_token_id(void* h, const char* token) {
  auto& v = static_cast<WordPiece*>(h)->vocab;
  auto it = v.find(token);
  return it == v.end() ? -1 : it->second;
}

// Encode n texts into row-major (n, max_len) int32 buffers. With
// add_special: [CLS] ids... [SEP], truncated so the SEP always fits
// (matching tokenizers' longest_first truncation for single sequences).
void vltk_wp_encode_batch(void* h, const char** texts, int64_t n,
                          int32_t max_len, int add_special, int32_t* ids,
                          int32_t* mask, int32_t* type_ids,
                          int32_t n_threads) {
  const auto& wp = *static_cast<WordPiece*>(h);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<int32_t> toks;
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      toks.clear();
      encode_one(wp, texts[i], &toks);
      int32_t* row = ids + i * max_len;
      int32_t* mrow = mask ? mask + i * max_len : nullptr;
      int32_t* trow = type_ids ? type_ids + i * max_len : nullptr;
      int32_t pos = 0;
      if (add_special && pos < max_len) row[pos++] = wp.cls_id;
      int32_t budget = add_special ? std::max(max_len - 2, 0) : max_len;
      int32_t take = std::min<int32_t>(static_cast<int32_t>(toks.size()), budget);
      for (int32_t t = 0; t < take; ++t) row[pos++] = toks[t];
      if (add_special && pos < max_len) row[pos++] = wp.sep_id;
      int32_t used = pos;
      for (; pos < max_len; ++pos) row[pos] = wp.pad_id;
      if (mrow)
        for (int32_t t = 0; t < max_len; ++t) mrow[t] = t < used ? 1 : 0;
      if (trow)
        for (int32_t t = 0; t < max_len; ++t) trow[t] = 0;
    }
  };
  int32_t threads = std::max<int32_t>(
      1, std::min<int64_t>(n_threads, n));
  if (threads == 1 || n <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// Per-word sub-token ids (OCR AuxTokenize path): flat ids out + per-word
// counts. Returns the total id count (always positive); words whose copy
// would exceed `cap` are counted but not written — callers compare the
// return value against cap and retry with a bigger buffer (the Python
// wrapper does).
int64_t vltk_wp_encode_words(void* h, const char** words, int64_t n,
                             int32_t* out_ids, int64_t cap,
                             int32_t* word_lens) {
  const auto& wp = *static_cast<WordPiece*>(h);
  int64_t total = 0;
  std::vector<int32_t> toks;
  for (int64_t i = 0; i < n; ++i) {
    toks.clear();
    encode_one(wp, words[i], &toks);
    word_lens[i] = static_cast<int32_t>(toks.size());
    if (total + static_cast<int64_t>(toks.size()) <= cap) {
      std::copy(toks.begin(), toks.end(), out_ids + total);
    }
    total += static_cast<int64_t>(toks.size());
  }
  return total;
}

}  // extern "C"
