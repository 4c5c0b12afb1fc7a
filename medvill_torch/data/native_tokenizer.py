"""ctypes binding for the native wordpiece tokenizer (``csrc/wordpiece.cc``):
a copy of medvill_tpu/data/native_tokenizer.py, kept here so the port
imports nothing of the JAX package and builds its own library.

``NativeBertTokenizer`` is ``BertTokenizer`` with a C++ ``tokenize_to_ids``
for pure-ASCII text (radiology reports are ASCII).  Text with non-ASCII
bytes or a literal special-token bracket, and text of more than
``MAX_IDS`` wordpieces, takes the exact Python path, so the ids are always
the Python tokenizer's.  Each thread gets its own id buffer: the
pretrain loader tokenizes on several threads and ctypes releases the
interpreter lock during the call (the JAX binding shares one buffer).

The library is built at first use with ``g++ -O2 -fPIC -std=c++17
-shared`` into ``medvill_torch/ops/_build/libwordpiece.so`` (gitignored),
beside a stamp of the source's sha256: a source that drifted from the
stamp is rebuilt.  The compiler writes a name of its own process and the
library is moved into place (``os.replace``), the stamp after it, so
processes that build at once never load a half-written file.  Nothing is
built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

from medvill_torch.data.tokenization import BertTokenizer, load_vocab

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "csrc", "wordpiece.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "ops", "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libwordpiece.so")
_STAMP_PATH = _LIB_PATH + ".src.sha256"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def _src_digest() -> Optional[str]:
    try:
        with open(_SRC_PATH, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def _stamp() -> Optional[str]:
    try:
        with open(_STAMP_PATH) as f:
            return f.read().strip()
    except OSError:
        return None


def build_library(force: bool = False) -> Optional[str]:
    """The library's path, built first if it is missing, if its stamp is
    not the source's digest, or with ``force``; None where the source or
    ``g++`` is missing or the build fails."""
    digest = _src_digest()
    if digest is None:
        return None
    if not force and os.path.exists(_LIB_PATH) and _stamp() == digest:
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC_PATH], check=True,
                       capture_output=True)
        os.replace(tmp, _LIB_PATH)
        with open(f"{_STAMP_PATH}.{os.getpid()}.tmp", "w") as f:
            f.write(digest + "\n")
        os.replace(f"{_STAMP_PATH}.{os.getpid()}.tmp", _STAMP_PATH)
    except (subprocess.CalledProcessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return _LIB_PATH


def _load(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    lib.wp_new.restype = ctypes.c_void_p
    lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.wp_tokenize.restype = ctypes.c_int
    lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.wp_vocab_size.restype = ctypes.c_int
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeBertTokenizer(BertTokenizer):
    """BertTokenizer with a native tokenize-to-ids fast path
    (``native_available`` says whether the library loaded)."""

    MAX_IDS = 4096

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 remap_unused: bool = True, lib_path: Optional[str] = None):
        super().__init__(load_vocab(vocab_file, remap_unused=remap_unused),
                         do_lower_case=do_lower_case)
        self._handle = None
        self._lib = None
        lib_path = lib_path or build_library()
        if not lib_path:
            return
        try:
            lib = _load(lib_path)
        except OSError:
            return
        handle = lib.wp_new(vocab_file.encode(), int(do_lower_case),
                            int(remap_unused))
        if not handle:
            return
        if lib.wp_vocab_size(handle) != len(self.vocab):
            lib.wp_free(handle)
            return
        self._lib, self._handle = lib, handle
        self._local = threading.local()

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def tokenize_to_ids(self, text: str) -> List[int]:
        """tokenize + convert_tokens_to_ids in one call (unknown words ->
        the [UNK] id)."""
        if self._handle is not None and "[" not in text \
                and "\x00" not in text:
            try:
                encoded = text.encode("ascii")
            except UnicodeEncodeError:
                encoded = None
            if encoded is not None:
                buf = getattr(self._local, "buf", None)
                if buf is None:
                    buf = self._local.buf = (ctypes.c_int * self.MAX_IDS)()
                n = self._lib.wp_tokenize(self._handle, encoded, buf,
                                          self.MAX_IDS)
                if n >= 0:
                    return buf[:n]
        return super().tokenize_to_ids(text)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.wp_free(self._handle)
            self._handle = None
