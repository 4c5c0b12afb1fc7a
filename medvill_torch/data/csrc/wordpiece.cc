// Native wordpiece tokenizer: the host-side hot loop of the pretrain data
// pipeline (a copy of the JAX package's native/wordpiece.cc, kept here so
// the port builds its own library).
//
// The reference's tokenization runs per sample in DataLoader workers
// (reference: main_origin.py:29-40 tokenize; sc/.../tokenization.py).
// This C++ implementation (BasicTokenizer punctuation split + greedy
// longest-match wordpiece over a flat hash vocab) runs the ASCII fast path
// without the Python interpreter.  Non-ASCII inputs are rejected (return
// -1) and the Python wrapper, medvill_torch/data/native_tokenizer.py,
// falls back to the exact Python implementation, so the ids are the same
// (tests/test_torch_port_native_tokenizer.py).
//
// C ABI (ctypes):
//   void* wp_new(const char* vocab_path, int do_lower, int remap_unused);
//   int   wp_tokenize(void* h, const char* text, int* out_ids, int max_out);
//         -> n ids, or -1 if text has non-ASCII bytes or more than max_out
//            ids (caller falls back)
//   int   wp_vocab_size(void* h);
//   void  wp_free(void* h);

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = -1;
  bool do_lower = true;
};

bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// greedy longest-match-first wordpiece of one word [begin,end)
void wordpiece(const Tokenizer* t, const std::string& word,
               std::vector<int>* out) {
  if (word.size() > 100) {  // max_input_chars_per_word
    out->push_back(t->unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int> pieces;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int cur = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf = "##";
      buf.append(word, start, end - start);
      auto it = t->vocab.find(buf);
      if (it != t->vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(t->unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_new(const char* vocab_path, int do_lower, int remap_unused) {
  auto* t = new Tokenizer();
  t->do_lower = do_lower != 0;
  std::ifstream f(vocab_path);
  if (!f.good()) {
    delete t;
    return nullptr;
  }
  std::string line;
  int index = 0;
  while (std::getline(f, line)) {
    // strip whitespace like python .strip()
    size_t b = line.find_first_not_of(" \t\r\n");
    size_t e = line.find_last_not_of(" \t\r\n");
    std::string tok =
        (b == std::string::npos) ? std::string() : line.substr(b, e - b + 1);
    if (remap_unused) {
      if (tok == "[unused1]") {
        tok = "[X_SEP]";
      } else if (tok.size() > 8 && tok.rfind("[unused", 0) == 0) {
        // [unused2..11] -> [SEP_0..9]
        int n = atoi(tok.substr(7, tok.size() - 8).c_str());
        if (n >= 2 && n <= 11) tok = "[SEP_" + std::to_string(n - 2) + "]";
      }
    }
    t->vocab[tok] = index++;
  }
  auto it = t->vocab.find("[UNK]");
  t->unk_id = (it == t->vocab.end()) ? 0 : it->second;
  return t;
}

int wp_vocab_size(void* h) {
  return static_cast<int>(static_cast<Tokenizer*>(h)->vocab.size());
}

int wp_tokenize(void* h, const char* text, int* out_ids, int max_out) {
  const auto* t = static_cast<Tokenizer*>(h);
  const size_t n = strlen(text);
  // ASCII fast path only: any high byte -> caller falls back to Python
  for (size_t i = 0; i < n; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  std::vector<int> ids;
  ids.reserve(n / 4 + 4);
  std::string word;
  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(t, word, &ids);
      word.clear();
    }
  };
  for (size_t i = 0; i < n; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || iscntrl(c)) {
      if (c == '\t' || c == '\n' || c == '\r') flush();
      continue;  // control chars dropped (BasicTokenizer._clean_text)
    }
    if (isspace(c)) {
      flush();
    } else if (is_punct(c)) {
      flush();
      word.push_back(static_cast<char>(c));
      flush();  // punctuation is its own token
    } else {
      word.push_back(static_cast<char>(
          t->do_lower ? tolower(c) : c));
    }
  }
  flush();
  if (ids.size() > static_cast<size_t>(max_out)) {
    // overflow: signal the caller to use the exact Python fallback rather
    // than silently truncating (the wrapper treats any negative return as
    // "take the fallback path", same as the non-ASCII signal above)
    return -1;
  }
  int count = static_cast<int>(ids.size());
  for (int i = 0; i < count; ++i) out_ids[i] = ids[i];
  return count;
}

void wp_free(void* h) { delete static_cast<Tokenizer*>(h); }

}  // extern "C"
