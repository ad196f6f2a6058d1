"""ctypes binding of the repository's native C++ host runtime (counterpart of
``seamless_communication_tpu/native.py``): ``native/fbank.cpp`` (the
80-mel fbank and WAV decoding), ``native/dataloader.cpp`` (a threaded
WAV -> fbank batch loader) and ``native/spm.cpp`` (the unigram Viterbi).

The three sources build with ``g++`` at first use (the flags of
``native/CMakeLists.txt``) into ``seamless_communication_torch/_build/``,
named by a hash of the sources, the flags and the host CPU's features (the
build is ``-march=native``), so an edited source rebuilds and a copy moved
to another machine does not load a library built for another CPU. A failed
build raises with the compiler's output; nothing falls back silently. The
tracked ``native/build/`` is the JAX package's and is never written here.

``text/spm.py`` keeps its Python Viterbi: this encoder resolves a vocabulary's
duplicate pieces to their first entry, the Python path (the JAX package's
parity reference) to the last.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("fbank.cpp", "dataloader.cpp", "spm.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-march=native", "-shared", "-pthread", "-std=c++17")
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_features() -> bytes:
    """The host CPU's model and flags (``-march=native`` builds for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            info = f.read()
    except OSError:
        return b""
    keep = (b"model name", b"flags", b"Features", b"CPU part")
    lines = sorted({ln for ln in info.splitlines() if ln.startswith(keep)})
    return b"\n".join(lines)


def library_path() -> Path:
    """Where the library builds to: named by a hash of the three sources, the
    flags and the host CPU's features."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode() + b"\0" + _cpu_features())
    return BUILD_DIR / f"libseamless_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises RuntimeError
    with the compiler's output when ``g++`` fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native library needs a C++ compiler: g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed ({' '.join(cmd)}), exit "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.POINTER
    c_i64, c_int = ctypes.c_int64, ctypes.c_int
    sigs = {
        "seamless_fbank": (c_int, [P(ctypes.c_float), c_i64, c_int, ctypes.c_double,
                                   P(ctypes.c_float), c_i64]),
        "seamless_wav_decode": (c_i64, [P(ctypes.c_ubyte), c_i64, P(ctypes.c_float),
                                        c_i64, P(ctypes.c_int32)]),
        "seamless_loader_create": (ctypes.c_void_p, [P(ctypes.c_char_p), c_i64, c_int,
                                                     c_int, c_int, c_int]),
        "seamless_loader_next_meta": (c_int, [ctypes.c_void_p, P(c_i64)]),
        "seamless_loader_next_data": (c_int, [ctypes.c_void_p, c_i64, P(ctypes.c_float),
                                              P(ctypes.c_int32)]),
        "seamless_loader_destroy": (None, [ctypes.c_void_p]),
        "seamless_spm_create": (ctypes.c_void_p, [P(ctypes.c_ubyte), P(c_i64), c_i64,
                                                  P(ctypes.c_float), P(ctypes.c_ubyte),
                                                  P(ctypes.c_int32), ctypes.c_int32]),
        "seamless_spm_encode": (c_i64, [ctypes.c_void_p, P(ctypes.c_ubyte), c_i64,
                                        P(ctypes.c_int32), c_i64]),
        "seamless_spm_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed (raises if it cannot
    be built)."""
    global _LIB
    with _lock:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeSpmEncoder:
    """The C++ unigram Viterbi over a SentencePiece model's pieces; equal to
    ``text.spm.SentencePieceModel.encode`` on a vocabulary without duplicate
    pieces (with duplicates it takes the first entry, the Python path the
    last)."""

    def __init__(self, pieces, scores, matchable, byte_ids: dict, unk_id: int):
        self._lib = get_lib()
        encoded = [p.encode("utf-8") for p in pieces]
        offsets = np.zeros(len(pieces) + 1, np.int64)
        np.cumsum([len(p) for p in encoded], out=offsets[1:])
        self._blob = np.frombuffer(b"".join(encoded), np.uint8).copy()
        self._offsets = offsets
        self._scores = np.asarray(scores, np.float32)
        self._matchable = np.asarray(matchable, np.uint8)
        self._bids = np.full(256, -1, np.int32)
        for b, i in byte_ids.items():
            self._bids[b] = i
        self._h = self._lib.seamless_spm_create(
            _ptr(self._blob, ctypes.c_ubyte), _ptr(offsets, ctypes.c_int64), len(pieces),
            _ptr(self._scores, ctypes.c_float), _ptr(self._matchable, ctypes.c_ubyte),
            _ptr(self._bids, ctypes.c_int32), unk_id)
        if not self._h:
            raise RuntimeError("spm model creation failed")

    @classmethod
    def from_model(cls, spm) -> "NativeSpmEncoder":
        """The encoder of a ``text.spm.SentencePieceModel``."""
        return cls(spm.pieces, spm.scores, spm._matchable, spm._byte_ids, spm.unk_id)

    def encode_normalized(self, text: str) -> list:
        """Ids of an already normalized text (``SentencePieceModel._normalize``)."""
        data = np.frombuffer(text.encode("utf-8"), np.uint8)
        if len(data) == 0:
            return []
        out = np.empty(max(16, 4 * len(data)), np.int32)
        n = self._lib.seamless_spm_encode(self._h, _ptr(data, ctypes.c_ubyte), len(data),
                                          _ptr(out, ctypes.c_int32), len(out))
        if n < 0:
            raise RuntimeError("spm encode failed")
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.seamless_spm_destroy(self._h)
            self._h = None


def fbank_native(waveform: np.ndarray, *, num_mel_bins: int = 80,
                 sample_rate: float = 16000.0) -> np.ndarray:
    """(T, num_mel_bins) log-mel fbank of a 16 kHz waveform, the numpy
    ``audio.fbank.fbank_numpy``'s arithmetic in C++."""
    lib = get_lib()
    wav = np.ascontiguousarray(waveform, np.float32)
    max_frames = max(0, 1 + (len(wav) - 400) // 160)
    out = np.empty((max_frames, num_mel_bins), np.float32)
    if max_frames == 0:
        return out
    n = lib.seamless_fbank(_ptr(wav, ctypes.c_float), len(wav), num_mel_bins, sample_rate,
                           _ptr(out, ctypes.c_float), max_frames)
    if n < 0:
        raise RuntimeError(f"native fbank failed ({n})")
    return out[:n]


class NativeFbankLoader:
    """Threaded C++ WAV -> fbank batch loader. Iterates (fbank (B, T_padded,
    n_mels) float32 zero-padded to a multiple of ``bucket``, lengths (B,)
    int32) in file order; a file that cannot be read or decoded comes back
    with length 0 for the caller to mask. Non-16 kHz files are resampled in
    C++ (windowed sinc)."""

    def __init__(self, paths, *, batch_size: int = 8, n_mels: int = 80,
                 bucket: int = 128, n_threads: int = 4):
        self._lib = get_lib()
        self.paths = [str(p) for p in paths]
        self.n_mels = n_mels
        self._arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._h = self._lib.seamless_loader_create(self._arr, len(self.paths), batch_size,
                                                   n_mels, bucket, n_threads)
        if not self._h:
            raise RuntimeError("loader creation failed")

    def __iter__(self):
        return self

    def __next__(self):
        frames = ctypes.c_int64(0)
        n = self._lib.seamless_loader_next_meta(self._h, ctypes.byref(frames))
        if n <= 0:
            raise StopIteration
        out = np.empty((n, frames.value, self.n_mels), np.float32)
        lengths = np.empty(n, np.int32)
        got = self._lib.seamless_loader_next_data(self._h, frames.value,
                                                  _ptr(out, ctypes.c_float),
                                                  _ptr(lengths, ctypes.c_int32))
        if got != n:
            raise RuntimeError("loader batch copy failed")
        return out, lengths

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.seamless_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def wav_decode_native(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """(mono float32 waveform, sample rate) of a WAV file's bytes, or None
    when the C++ decoder does not take the file (not a PCM WAV it reads)."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)
    max_samples = len(data) // 2 + 16
    out = np.empty(max_samples, np.float32)
    rate = ctypes.c_int32(0)
    n = lib.seamless_wav_decode(_ptr(buf, ctypes.c_ubyte), len(data),
                                _ptr(out, ctypes.c_float), max_samples, ctypes.byref(rate))
    if n < 0:
        return None
    return out[:n].copy(), int(rate.value)
