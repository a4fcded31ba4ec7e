"""Native (C++) host runtime, loaded with ctypes (counterpart of
``trackmaker_tpu/runtime``).

The sources in ``csrc/`` build with ``g++`` at first use, never at import,
into one shared library under ``build/trackmaker_tpu_torch/`` at the
repository root.  Its file name carries a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the library
already built.  A build or load failure raises :class:`RuntimeUnavailable`.
Provides:

* :func:`flac_decode` / :func:`flac_info` / :func:`flac_md5_check` — a
  FLAC decoder written from the format's specification (the loader of
  ``io.load_audio``)
* :func:`crc8` — CRC8, poly 0x07
* :func:`channel_busy` — the CSMA energy detector
* :func:`frame_serialize` / :func:`frame_parse` — the frame byte codec
* :class:`RingBuffer` — a single-producer single-consumer float ring
* :func:`active_regions` — the energy-gated segmenter
* :class:`AudioDuplex` — ALSA, JACK or PortAudio capture and playback
  (loaded with dlopen where the host has them), or a loopback cable
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trackmaker_tpu_torch"
SOURCES = ("tm_runtime.cc", "flac.cc", "tm_audio.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ldl", "-lpthread")
_lib = None


class RuntimeUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    """The library's path: its name carries a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtmruntime-{h.hexdigest()[:16]}.so"


def ensure_built() -> pathlib.Path:
    """Compile ``csrc/*.cc`` unless the library is already built."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeUnavailable("native runtime build failed: no g++ on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeUnavailable(
                f"native runtime build failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeUnavailable(f"native runtime load failed: {e}") from e

    lib.tm_crc8.restype = ctypes.c_uint8
    lib.tm_crc8.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tm_channel_busy.restype = ctypes.c_int
    lib.tm_channel_busy.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, ctypes.c_float,
        ctypes.c_size_t]
    lib.tm_frame_serialize.restype = ctypes.c_size_t
    lib.tm_frame_serialize.argtypes = [
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8)]
    lib.tm_frame_parse.restype = ctypes.c_int64
    lib.tm_frame_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tm_flac_info.restype = ctypes.c_int
    lib.tm_flac_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64)]
    lib.tm_flac_decode.restype = ctypes.c_int64
    lib.tm_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.tm_ring_create.restype = ctypes.c_void_p
    lib.tm_ring_create.argtypes = [ctypes.c_size_t]
    lib.tm_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.tm_ring_size.restype = ctypes.c_size_t
    lib.tm_ring_size.argtypes = [ctypes.c_void_p]
    lib.tm_ring_push.restype = ctypes.c_size_t
    lib.tm_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.tm_ring_pop.restype = ctypes.c_size_t
    lib.tm_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.tm_active_regions.restype = ctypes.c_size_t
    lib.tm_active_regions.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, ctypes.c_float,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t]
    _lib = lib
    return lib


def crc8(data: bytes) -> int:
    lib = _load()
    return lib.tm_crc8(bytes(data), len(data))


def channel_busy(samples: np.ndarray, threshold: float = 0.5,
                 min_samples: int = 20) -> bool | None:
    lib = _load()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    r = lib.tm_channel_busy(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), threshold, min_samples)
    return None if r < 0 else bool(r)


def frame_serialize(frame_type: int, seq: int, src: int, dst: int,
                    payload: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(7 + len(payload))
    n = lib.tm_frame_serialize(
        frame_type, seq, src, dst, bytes(payload), len(payload),
        ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)))
    return out.raw[:n]


def frame_parse(raw: bytes) -> tuple[int, int, int, int, bytes] | None:
    """-> (type, seq, src, dst, payload) or None on invalid/CRC fail."""
    lib = _load()
    hdr = (ctypes.c_uint8 * 4)()
    payload = ctypes.create_string_buffer(max(len(raw), 1))
    n = lib.tm_frame_parse(
        bytes(raw), len(raw), hdr,
        ctypes.cast(payload, ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        return None
    return hdr[0], hdr[1], hdr[2], hdr[3], payload.raw[:n]


def flac_info(data: bytes) -> dict:
    lib = _load()
    info = (ctypes.c_int64 * 4)()
    if lib.tm_flac_info(bytes(data), len(data), info) != 0:
        raise ValueError("not a FLAC stream (or STREAMINFO missing)")
    return {"channels": info[0], "sample_rate": info[1],
            "bits_per_sample": info[2], "total_samples": info[3]}


def flac_decode(data: bytes, as_float: bool = True,
                ) -> tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (samples[channels, n] f32 in [-1,1] or
    int32 PCM, sample_rate).  The decoder does not check the frames'
    CRCs: :func:`flac_md5_check` is what shows that a stream decoded
    exactly."""
    lib = _load()
    info = flac_info(data)
    ch, n = info["channels"], info["total_samples"]
    out = np.zeros(n * ch, dtype=np.int32)
    got = lib.tm_flac_decode(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
    if got < 0:
        raise ValueError(f"FLAC decode failed (code {got})")
    pcm = out[: got * ch].reshape(-1, ch).T
    if as_float:
        scale = float(1 << (info["bits_per_sample"] - 1))
        return (pcm.astype(np.float32) / scale), info["sample_rate"]
    return pcm, info["sample_rate"]


def flac_md5_check(data: bytes) -> bool:
    """Verify decoded PCM against the STREAMINFO MD5 (the MD5 of the
    original unencoded audio)."""
    info = flac_info(data)
    pcm, _ = flac_decode(data, as_float=False)
    bps = info["bits_per_sample"]
    nbytes = (bps + 7) // 8
    inter = pcm.T.reshape(-1)  # interleaved
    if nbytes == 2:
        raw = inter.astype("<i2").tobytes()
    elif nbytes == 1:
        raw = inter.astype("i1").tobytes()
    elif nbytes == 3:
        as32 = inter.astype("<i4").tobytes()
        b = np.frombuffer(as32, dtype=np.uint8).reshape(-1, 4)
        raw = b[:, :3].tobytes()
    else:
        raw = inter.astype("<i4").tobytes()
    md5 = hashlib.md5(raw).digest()
    stored = bytes(data[8 + 18: 8 + 34])
    return md5 == stored


class RingBuffer:
    def __init__(self, capacity: int):
        self._lib = _load()
        self._ptr = self._lib.tm_ring_create(capacity)

    def __del__(self):
        try:
            self._lib.tm_ring_destroy(self._ptr)
        except Exception:
            pass

    def __len__(self) -> int:
        return self._lib.tm_ring_size(self._ptr)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, dtype=np.float32)
        return self._lib.tm_ring_push(
            ctypes.c_void_p(self._ptr),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(data))

    def pop(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.float32)
        got = self._lib.tm_ring_pop(
            ctypes.c_void_p(self._ptr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out[:got]


def active_regions(samples: np.ndarray, threshold: float = 0.05,
                   hang: int = 1024, halo: int = 512,
                   max_regions: int = 4096) -> np.ndarray:
    """-> int64[k, 2] (start, end) active regions."""
    lib = _load()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    out = np.zeros(max_regions * 2, dtype=np.int64)
    k = lib.tm_active_regions(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), ctypes.c_float(threshold), hang, halo,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_regions)
    return out[: 2 * k].reshape(-1, 2)


# ---------------------------------------------------------------------------
# Real-audio capture/playback (tm_audio.cc): ALSA or JACK via dlopen
# when the host has libasound/libjack, else a loopback "virtual cable"
# between the playback and capture rings, with the lock-free ring as the
# cut point between real time and the batched decode.
# ---------------------------------------------------------------------------

BACKEND_ALSA = 0
BACKEND_LOOPBACK = 1          # paced at the sample rate
BACKEND_LOOPBACK_FAST = 2     # unpaced (tests)
BACKEND_JACK = 3              # JACK/PipeWire-JACK client + auto-connect
BACKEND_PORTAUDIO = 4         # PortAudio default duplex (macOS/CoreAudio)


def _audio_bind(lib):
    if getattr(lib, "_audio_bound", False):
        return
    lib.tm_audio_alsa_available.restype = ctypes.c_int
    lib.tm_audio_jack_available.restype = ctypes.c_int
    lib.tm_audio_portaudio_available.restype = ctypes.c_int
    lib.tm_audio_open.restype = ctypes.c_void_p
    lib.tm_audio_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tm_audio_close.argtypes = [ctypes.c_void_p]
    lib._audio_bound = True


def alsa_available() -> bool:
    lib = _load()
    _audio_bind(lib)
    return bool(lib.tm_audio_alsa_available())


def jack_available() -> bool:
    """libjack is loadable (a running server is still needed to open)."""
    lib = _load()
    _audio_bind(lib)
    return bool(lib.tm_audio_jack_available())


def portaudio_available() -> bool:
    """libportaudio is loadable (macOS/CoreAudio hosts; opening can
    still fail when no duplex device exists)."""
    lib = _load()
    _audio_bind(lib)
    return bool(lib.tm_audio_portaudio_available())


class AudioDuplex:
    """Half-duplex audio endpoint over the SPSC rings.

    `capture` pops what arrived from the device (or the loopback
    cable); `play` pushes samples toward it.  The real-time thread lives
    in C++.
    """

    def __init__(self, device: str = "default",
                 backend: int | None = None, rate: int = 48_000,
                 period: int = 256, ring_capacity: int = 1 << 22):
        lib = _load()
        _audio_bind(lib)
        if backend is None:
            # prefer real hardware when a backend library exists (ALSA
            # on Linux, PortAudio elsewhere — macOS/CoreAudio rides it);
            # the loopback cable is the headless/CI fallback
            if lib.tm_audio_alsa_available():
                backend = BACKEND_ALSA
            elif lib.tm_audio_portaudio_available():
                backend = BACKEND_PORTAUDIO
            else:
                backend = BACKEND_LOOPBACK
        self.backend = backend
        self.rate = rate
        self.capture_ring = RingBuffer(ring_capacity)
        self.playback_ring = RingBuffer(ring_capacity)
        self._lib = lib
        self._h = lib.tm_audio_open(
            device.encode(), backend, rate, period,
            ctypes.c_void_p(self.capture_ring._ptr),
            ctypes.c_void_p(self.playback_ring._ptr))
        if not self._h:
            raise RuntimeError(
                f"tm_audio_open failed (backend={backend}); "
                "for ALSA check libasound.so.2 and the device name; "
                "for JACK check libjack.so.0 and that a JACK/PipeWire "
                "server is running; for PortAudio check libportaudio "
                "and that a default duplex device exists")

    def play(self, samples: np.ndarray) -> int:
        return self.playback_ring.push(samples)

    def capture(self, n: int) -> np.ndarray:
        return self.capture_ring.pop(n)

    def pending_capture(self) -> int:
        return len(self.capture_ring)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tm_audio_close(ctypes.c_void_p(self._h))
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
