"""WordPiece tokenizer (BERT-uncased semantics): a copy of
medvill_tpu/data/tokenization.py, kept here so the port imports nothing of
the JAX package.

Matches the vendored tokenizer used by finetune/decode (reference:
sc/pytorch_pretrained_bert/tokenization.py) including its quirks:

- vocab load remaps ``[unused1] -> [X_SEP]`` and ``[unused2..11] ->
  [SEP_0..9]`` (tokenization.py:57-77);
- BasicTokenizer: text cleanup, CJK spacing, lowercase + accent strip,
  punctuation split, with a never-split list;
- WordpieceTokenizer: greedy longest-match-first with ``##`` continuations,
  words over 100 chars -> [UNK].

The pretrain path uses HF ``BertTokenizer`` (reference: main_origin.py:29-40)
whose algorithm is identical modulo the unused-token remap; pass
``remap_unused=False`` for that behavior.
"""
from __future__ import annotations

import collections
import unicodedata
from typing import Dict, Iterable, List

NEVER_SPLIT = ("[UNK]", "[SEP]", "[X_SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(vocab_file: str, remap_unused: bool = True) -> Dict[str, int]:
    extra_map = {}
    if remap_unused:
        extra_map["[unused1]"] = "[X_SEP]"
        for i in range(10):
            extra_map[f"[unused{i + 2}]"] = f"[SEP_{i}]"
    vocab: Dict[str, int] = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as reader:
        for index, line in enumerate(reader):
            token = line.rstrip("\n")
            token = token.strip()
            token = extra_map.get(token, token)
            vocab[token] = index
    return vocab


def build_vocab(tokens: Iterable[str]) -> Dict[str, int]:
    """Small vocab builder for tests/synthetic data: specials first, then
    the given tokens (deduped, order-preserving)."""
    vocab: Dict[str, int] = collections.OrderedDict()
    for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
        vocab[t] = len(vocab)
    for t in tokens:
        if t not in vocab:
            vocab[t] = len(vocab)
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def whitespace_tokenize(text: str) -> List[str]:
    text = text.strip()
    return text.split() if text else []


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True,
                 never_split=NEVER_SPLIT):
        self.do_lower_case = do_lower_case
        self.never_split = never_split

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        orig_tokens = whitespace_tokenize(text)
        split_tokens: List[str] = []
        for token in orig_tokens:
            if self.do_lower_case and token not in self.never_split:
                token = token.lower()
                token = self._strip_accents(token)
            split_tokens.extend(self._split_on_punc(token))
        return whitespace_tokenize(" ".join(split_tokens))

    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_chinese_chars(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    def _split_on_punc(self, text: str) -> List[str]:
        if text in self.never_split:
            return [text]
        chars = list(text)
        output: List[List[str]] = []
        start_new_word = True
        for ch in chars:
            if _is_punctuation(ch):
                output.append([ch])
                start_new_word = True
            else:
                if start_new_word:
                    output.append([])
                start_new_word = False
                output[-1].append(ch)
        return ["".join(x) for x in output]


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        output_tokens: List[str] = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                output_tokens.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens: List[str] = []
            while start < len(chars):
                end = len(chars)
                cur_substr = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur_substr = substr
                        break
                    end -= 1
                if cur_substr is None:
                    is_bad = True
                    break
                sub_tokens.append(cur_substr)
                start = end
            if is_bad:
                output_tokens.append(self.unk_token)
            else:
                output_tokens.extend(sub_tokens)
        return output_tokens


class BertTokenizer:
    """End-to-end tokenizer: basic + wordpiece."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 never_split=NEVER_SPLIT):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab)

    @classmethod
    def from_vocab_file(cls, vocab_file: str, do_lower_case: bool = True,
                        remap_unused: bool = True) -> "BertTokenizer":
        return cls(load_vocab(vocab_file, remap_unused=remap_unused),
                   do_lower_case=do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        split_tokens: List[str] = []
        for token in self.basic_tokenizer.tokenize(text):
            split_tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return split_tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.vocab[t] for t in tokens]

    def tokenize_to_ids(self, text: str) -> List[int]:
        """tokenize + lookup with [UNK] fallback in one call (the native
        backend overrides this with a C++ fast path)."""
        unk = self.vocab["[UNK]"]
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]


def detokenize(tokens: List[str]) -> List[str]:
    """Merge ``##`` continuations back into words (reference:
    sc/generation_decode.py:97-104)."""
    out: List[str] = []
    for tk in tokens:
        if tk.startswith("##") and out:
            out[-1] += tk[2:]
        else:
            out.append(tk)
    return out


def caption_from_ids(tokenizer, ids) -> str:
    """Decoded token ids -> caption text: stop at the first [SEP], merge
    wordpieces (the decode entry's output post-processing,
    generation_decode.py:558-566)."""
    toks: List[str] = []
    for t in ids:
        tok = tokenizer.ids_to_tokens.get(int(t), "[UNK]")
        if tok == "[SEP]":
            break
        toks.append(tok)
    return " ".join(detokenize(toks))
