"""Python binding for the shared-memory episode cache (port of
hulc_tpu/data/shm_store.py).

One process populates a ``/dev/shm`` arena from the npz split; loader
processes attach zero-copy and gather padded windows through the C++
batched-memcpy path (``native/shm_cache.cpp``, a copy of the JAX
package's). The library is built with ``g++`` into ``build/`` at the
repository root at first use (``build()``), named by a hash of its source
and flags. ``wait_ready`` is the cross-process readiness barrier.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Dict, Sequence, Tuple

import numpy as np

SRC_PATH = pathlib.Path(__file__).resolve().parent.parent / "native" / "shm_cache.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build() -> pathlib.Path:
    """Compile ``native/shm_cache.cpp`` into ``build/libhulc_shm-<hash>.so``
    (a no-op when that file exists) and return its path."""
    digest = hashlib.sha256(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhulc_shm-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC_PATH), "-o", str(tmp), "-lrt"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC_PATH.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: another process never loads a partial file
    return lib


class _Lib:
    _instance = None

    @classmethod
    def get(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(str(build()))
            lib.hulc_shm_create.restype = ctypes.c_void_p
            lib.hulc_shm_create.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.hulc_shm_attach.restype = ctypes.c_void_p
            lib.hulc_shm_attach.argtypes = [ctypes.c_char_p]
            lib.hulc_shm_close.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
            lib.hulc_shm_write.restype = ctypes.c_int
            lib.hulc_shm_write.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p,
            ]
            lib.hulc_shm_set_ready.argtypes = [ctypes.c_void_p]
            lib.hulc_shm_is_ready.restype = ctypes.c_int
            lib.hulc_shm_is_ready.argtypes = [ctypes.c_void_p]
            lib.hulc_shm_n_frames.restype = ctypes.c_uint64
            lib.hulc_shm_n_frames.argtypes = [ctypes.c_void_p]
            lib.hulc_shm_key_ptr.restype = ctypes.c_void_p
            lib.hulc_shm_key_ptr.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
            ]
            lib.hulc_shm_gather_windows.restype = ctypes.c_int
            lib.hulc_shm_gather_windows.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
            ]
            lib.hulc_shm_gather_windows_mt.restype = ctypes.c_int
            lib.hulc_shm_gather_windows_mt.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64,
            ]
            cls._instance = lib
        return cls._instance


class ShmEpisodeCache:
    """Writer/reader handle over one split's shared-memory arena."""

    def __init__(self, name: str, handle, key_meta: Dict[str, Tuple[Tuple[int, ...], np.dtype]]):
        self._lib = _Lib.get()
        self.name = name
        self._handle = handle
        self.key_meta = key_meta  # key -> (frame_shape, dtype)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def create(
        cls, name: str, n_frames: int, key_meta: Dict[str, Tuple[Tuple[int, ...], np.dtype]]
    ) -> "ShmEpisodeCache":
        lib = _Lib.get()
        keys = list(key_meta)
        names = (ctypes.c_char_p * len(keys))(*[k.encode() for k in keys])
        fb = (ctypes.c_uint64 * len(keys))(
            *[int(np.prod(s) * np.dtype(d).itemsize) for s, d in key_meta.values()]
        )
        es = (ctypes.c_uint64 * len(keys))(*[np.dtype(d).itemsize for _, d in key_meta.values()])
        handle = lib.hulc_shm_create(name.encode(), n_frames, len(keys), names, fb, es)
        if not handle:
            raise OSError(f"failed to create shm arena {name}")
        return cls(name, handle, key_meta)

    @classmethod
    def attach(
        cls,
        name: str,
        key_meta: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
        timeout_s: float = 0.0,
    ) -> "ShmEpisodeCache":
        lib = _Lib.get()
        deadline = time.time() + timeout_s
        while True:
            handle = lib.hulc_shm_attach(name.encode())
            if handle:
                return cls(name, handle, key_meta)
            if time.time() >= deadline:
                raise FileNotFoundError(f"shm arena {name} not found")
            time.sleep(0.5)

    @staticmethod
    def unlink(name: str) -> None:
        """Remove a (possibly stale) arena by name."""
        p = pathlib.Path("/dev/shm") / name.lstrip("/")
        try:
            p.unlink()
        except FileNotFoundError:
            pass

    @classmethod
    def populate_from_store(cls, name: str, store, chunk: int = 256) -> "ShmEpisodeCache":
        """Fill an arena from an EpisodeStore (the 'warm-up' pass).

        Creation uses O_EXCL: if another process won the race, attach to its
        arena and wait for readiness instead of clobbering it mid-write.
        """
        first = store.get_window(store.episode_ranges[0][0], 1)
        key_meta = {k: (v.shape[1:], v.dtype) for k, v in first.items()}
        n = store._max_frame - store._min_frame + 1
        try:
            cache = cls.create(name, n, key_meta)
        except OSError:
            other = cls.attach(name, key_meta, timeout_s=60.0)
            other.wait_ready()
            other.frame_offset = store._min_frame
            return other
        for off in range(0, n, chunk):
            count = min(chunk, n - off)
            # pooled npz decode (EpisodeStore.load_frames) — the warm-up is
            # decode-bound on real splits and scales with cores
            window = store.load_frames(store._min_frame + off, count)
            for k, v in window.items():
                cache.write(k, off, np.ascontiguousarray(v))
        cache.set_ready()
        cache.frame_offset = store._min_frame
        return cache

    # ------------------------------------------------------------------
    # writer API
    # ------------------------------------------------------------------

    def write(self, key: str, frame_idx: int, frames: np.ndarray) -> None:
        frames = np.ascontiguousarray(frames)
        rc = self._lib.hulc_shm_write(
            self._handle, key.encode(), frame_idx, len(frames),
            frames.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise ValueError(f"shm write failed for {key}@{frame_idx} (rc={rc})")

    def set_ready(self) -> None:
        self._lib.hulc_shm_set_ready(self._handle)

    # ------------------------------------------------------------------
    # reader API
    # ------------------------------------------------------------------

    @property
    def ready(self) -> bool:
        return bool(self._lib.hulc_shm_is_ready(self._handle))

    def wait_ready(self, timeout_s: float = 1800.0) -> None:
        """Block until the writer flags completion (SignalCallback role)."""
        deadline = time.time() + timeout_s
        while not self.ready:
            if time.time() > deadline:
                raise TimeoutError(f"shm arena {self.name} never became ready")
            time.sleep(0.5)

    @property
    def n_frames(self) -> int:
        return int(self._lib.hulc_shm_n_frames(self._handle))

    def key_array(self, key: str) -> np.ndarray:
        """Zero-copy numpy view of a key's full (n_frames, ...) array."""
        fb = ctypes.c_uint64()
        ptr = self._lib.hulc_shm_key_ptr(self._handle, key.encode(), ctypes.byref(fb))
        if not ptr:
            raise KeyError(key)
        shape, dtype = self.key_meta[key]
        n = self.n_frames
        buf = (ctypes.c_uint8 * (fb.value * n)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape((n,) + tuple(shape))

    def gather_windows(
        self,
        key: str,
        starts: Sequence[int],
        lengths: Sequence[int],
        max_window: int,
        n_threads: int = 1,
    ) -> np.ndarray:
        """Padded (B, max_window, ...) batch via the C++ memcpy path.

        n_threads > 1 splits the batch dim over C++ std::threads (ctypes
        releases the GIL for the call, so this is real host parallelism on
        multi-core machines; on a 1-core host it is a wash).
        """
        shape, dtype = self.key_meta[key]
        b = len(starts)
        out = np.empty((b, max_window) + tuple(shape), dtype)
        starts_a = np.ascontiguousarray(starts, np.int64)
        lengths_a = np.ascontiguousarray(lengths, np.int64)
        rc = self._lib.hulc_shm_gather_windows_mt(
            self._handle, key.encode(),
            starts_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lengths_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b, max_window, out.ctypes.data_as(ctypes.c_void_p),
            max(1, int(n_threads)),
        )
        if rc != 0:
            raise ValueError(f"gather_windows failed (rc={rc})")
        return out

    def close(self, unlink: bool = False) -> None:
        if self._handle:
            self._lib.hulc_shm_close(self._handle, int(unlink), self.name.encode())
            self._handle = None
