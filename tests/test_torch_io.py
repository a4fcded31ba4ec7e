"""The port's audio files, native host runtime, batched frame codec, filters
and host utilities (``trackmaker_tpu_torch.io``, ``.runtime``,
``core.framing.build_frame_bytes`` / ``verify_frames``, ``dsp.filters``,
``utils``) against the JAX package's, on the CPU.

Inputs are made from seeds with numpy's ``default_rng``.  Files, bytes,
integers and booleans are compared exactly; the filters, which sum floats,
within 1e-6 of the largest magnitude of JAX's output.  FLAC input comes
from ``chip_smoke.flac_encode`` (the writer that the card's check uses):
CONSTANT, VERBATIM and FIXED subframes with Rice residuals, mono and stereo,
16 bits.  The JAX package is imported only inside the tests.
"""

import pathlib
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (module level: stdlib and NumPy only)
from trackmaker_tpu_torch import io as tio  # noqa: E402
from trackmaker_tpu_torch import runtime as trt  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flac_corpus() -> dict[str, np.ndarray]:
    """16-bit signals, each with the subframe kinds it makes the writer
    choose: silence (CONSTANT), full-scale white noise (VERBATIM), tones
    (FIXED of order 2 and more), noise (FIXED order 0 or 1), stereo, a
    block of one value beside noise, a last block of one sample and a
    stream shorter than a block."""
    rng = np.random.default_rng(26)
    t = np.arange(10_000)
    return {
        "silence": np.zeros(5_000, np.int16),
        "white": rng.integers(-32768, 32768, 9_000).astype(np.int16),
        "tone": (10_000 * np.sin(t * 0.01)).astype(np.int16),
        "noise": rng.normal(0, 800, 8_193).astype(np.int16),
        "stereo": np.stack([(8_000 * np.sin(t * 0.02)).astype(np.int16),
                            rng.integers(-32768, 32768, 10_000).astype(np.int16)]),
        "held": np.concatenate([np.full(4_096, -7, np.int16),
                                rng.normal(0, 300, 3_000).astype(np.int16)]),
        "short": (1_000 * np.sin(np.arange(300) * 0.2)).astype(np.int16),
    }


def outcome(fn, *args):
    """fn's result, or the type of the error it raised."""
    try:
        return fn(*args)
    except Exception as exc:   # noqa: BLE001 - the error type is compared
        return type(exc)


# --- FLAC ------------------------------------------------------------------------


def crc16_bitwise(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


def test_flac_writer_crc16_matches_bitwise():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 300, 5_000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert chip_smoke.flac_crc16(data) == crc16_bitwise(data)


def test_flac_writer_covers_every_subframe_kind():
    kinds = {}
    for pcm in flac_corpus().values():
        for kind, n in chip_smoke.flac_encode(pcm)[1].items():
            kinds[kind] = kinds.get(kind, 0) + n
    assert {"constant", "verbatim"} <= set(kinds)
    assert {k for k in kinds if k.startswith("fixed")} >= {"fixed0", "fixed2"}


@pytest.mark.parametrize("name", sorted(flac_corpus()))
def test_flac_decode_equals_jax_and_source(name):
    from trackmaker_tpu import runtime as jrt

    pcm = flac_corpus()[name]
    data, _ = chip_smoke.flac_encode(pcm)
    src = pcm if pcm.ndim == 2 else pcm[None]
    assert trt.flac_info(data) == jrt.flac_info(data) == {
        "channels": src.shape[0], "sample_rate": 48_000, "bits_per_sample": 16,
        "total_samples": src.shape[1]}
    got, sr = trt.flac_decode(data, as_float=False)
    want, jsr = jrt.flac_decode(data, as_float=False)
    assert sr == jsr == 48_000
    np.testing.assert_array_equal(got, src)
    np.testing.assert_array_equal(got, want)
    gf, _ = trt.flac_decode(data)
    jf, _ = jrt.flac_decode(data)
    assert gf.dtype == np.float32 and np.array_equal(gf, jf)
    assert trt.flac_md5_check(data) and jrt.flac_md5_check(data)
    bad = bytearray(data)
    bad[-40] ^= 0x10          # one bit of the last frame: a wrong sample or a broken frame
    assert outcome(trt.flac_md5_check, bytes(bad)) == outcome(jrt.flac_md5_check, bytes(bad))
    assert outcome(trt.flac_md5_check, bytes(bad)) in (False, ValueError)


def test_load_audio_flac_and_wav_equal_jax(tmp_path):
    from trackmaker_tpu import io as jio

    pcm = flac_corpus()["stereo"]
    (tmp_path / "s.flac").write_bytes(chip_smoke.flac_encode(pcm)[0])
    tio.write_wav(tmp_path / "s.wav", pcm.astype(np.float32) / 32768.0)
    for name in ("s.flac", "s.wav"):
        for mono in (True, False):
            got, sr = tio.load_audio(tmp_path / name, mono=mono)
            want, jsr = jio.load_audio(tmp_path / name, mono=mono)
            assert sr == jsr and got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    got, _ = tio.decode_flac_to_f32(tmp_path / "s.flac")
    np.testing.assert_array_equal(got, pcm / np.float32(32768.0))


def test_flac_rejects_what_jax_rejects():
    from trackmaker_tpu import runtime as jrt

    data, _ = chip_smoke.flac_encode(flac_corpus()["tone"])
    for bad in (b"RIFF" + data[4:], data[:20]):
        for rt in (trt, jrt):
            with pytest.raises(ValueError):
                rt.flac_info(bad)


# --- the runtime's build --------------------------------------------------------------


def test_runtime_builds_from_its_own_sources():
    path = trt.ensure_built()
    assert path.parent == REPO / "build" / "trackmaker_tpu_torch"
    assert path.name.startswith("libtmruntime-") and path.name.endswith(".so")
    assert trt.CSRC == REPO / "trackmaker_tpu_torch" / "runtime" / "csrc"
    assert sorted(p.name for p in trt.CSRC.glob("*.cc")) == sorted(trt.SOURCES)


def test_runtime_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(trt, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(trt.RuntimeUnavailable):
        trt.ensure_built()
    assert not list((tmp_path / "build").glob("*.so"))


# --- the runtime's other entry points ----------------------------------------------------


def test_crc8_and_frame_codec_equal_jax():
    from trackmaker_tpu import runtime as jrt
    from trackmaker_tpu_torch.core import bitops

    rng = np.random.default_rng(2)
    for n in (0, 1, 17, 256, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert trt.crc8(data) == jrt.crc8(data) == bitops.crc8_host(data)
    for _ in range(20):
        payload = rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes()
        fields = [int(v) for v in rng.integers(0, 256, 4)]
        raw = trt.frame_serialize(*fields, payload)
        assert raw == jrt.frame_serialize(*fields, payload)
        bad = bytearray(raw)
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        for r in (raw, bytes(bad), raw[:5], raw + b"\x00"):
            assert trt.frame_parse(r) == jrt.frame_parse(r)


def test_channel_busy_and_active_regions_equal_jax():
    from trackmaker_tpu import runtime as jrt

    rng = np.random.default_rng(3)
    for n in (0, 10, 19, 20, 64, 500):
        x = (rng.random(n) < 0.05) * rng.normal(0, 1, n)
        for thr, mn in ((0.5, 20), (0.2, 5), (2.0, 1)):
            assert trt.channel_busy(x, thr, mn) == jrt.channel_busy(x, thr, mn)
    for _ in range(10):
        x = np.zeros(20_000, np.float32)
        for s in rng.integers(0, 19_000, int(rng.integers(0, 6))):
            x[s:s + int(rng.integers(1, 900))] = rng.normal(0, 0.5)
        for kw in ({}, {"threshold": 0.1, "hang": 256, "halo": 64}, {"max_regions": 2}):
            np.testing.assert_array_equal(trt.active_regions(x, **kw), jrt.active_regions(x, **kw))


def test_ring_buffer_equals_jax():
    from trackmaker_tpu import runtime as jrt

    rng = np.random.default_rng(4)
    rings = (trt.RingBuffer(1000), jrt.RingBuffer(1000))
    for _ in range(50):
        if rng.random() < 0.5:
            data = rng.normal(size=int(rng.integers(0, 700))).astype(np.float32)
            assert rings[0].push(data) == rings[1].push(data)
        else:
            n = int(rng.integers(0, 700))
            np.testing.assert_array_equal(rings[0].pop(n), rings[1].pop(n))
        assert len(rings[0]) == len(rings[1])


def test_audio_duplex_loopback_moves_samples_exactly():
    d = trt.AudioDuplex(backend=trt.BACKEND_LOOPBACK_FAST)
    try:
        x = np.sin(np.arange(30000) * 0.01).astype(np.float32)
        d.play(x)
        got = np.zeros(0, np.float32)
        deadline = time.time() + 10
        while len(got) < len(x) and time.time() < deadline:
            got = np.concatenate([got, d.capture(8192)])
        np.testing.assert_array_equal(got[: len(x)], x)
    finally:
        d.close()


def test_audio_duplex_paced_loopback_roughly_realtime():
    d = trt.AudioDuplex(backend=trt.BACKEND_LOOPBACK, rate=48_000)
    try:
        d.play(np.ones(48_000, np.float32))
        time.sleep(0.25)
        assert 2_000 <= d.pending_capture() <= 48_000
    finally:
        d.close()


def test_audio_duplex_phy_frames_over_loopback_decode():
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.link.stream import StreamingDecodePipeline
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    cfg = PhyConfig()
    frames = [Frame.new_data(i, 1, 2, bytes([65 + i]) * (5 + i)) for i in range(3)]
    wave = PhyEncoder(cfg, device="cpu").encode_frames(frames, gap_samples=1500).numpy()
    d = trt.AudioDuplex(backend=trt.BACKEND_LOOPBACK_FAST)
    try:
        d.play(wave)
        got = np.zeros(0, np.float32)
        deadline = time.time() + 15
        while len(got) < len(wave) and time.time() < deadline:
            got = np.concatenate([got, d.capture(8192)])
    finally:
        d.close()
    pipe = StreamingDecodePipeline(cfg, local_addr=2, device="cpu")
    decoded = pipe.push(got) + pipe.flush()
    assert [f.data for f in decoded] == [f.data for f in frames]


@pytest.mark.parametrize("backend", ["ALSA", "JACK", "PORTAUDIO"])
def test_audio_duplex_hardware_backends_agree_with_jax(backend):
    """Each hardware backend's probe answers as JAX's runtime does, and where
    the library is absent, opening it fails cleanly."""
    from trackmaker_tpu import runtime as jrt

    probe = {"ALSA": "alsa_available", "JACK": "jack_available",
             "PORTAUDIO": "portaudio_available"}[backend]
    have = getattr(trt, probe)()
    assert have == getattr(jrt, probe)()
    code = getattr(trt, f"BACKEND_{backend}")
    assert code == getattr(jrt, f"BACKEND_{backend}")
    if not have:
        with pytest.raises(RuntimeError):
            trt.AudioDuplex(backend=code)


# --- WAV and JSON --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4800,), (2, 3000), (0,)])
def test_wav_files_equal_jax_byte_for_byte(tmp_path, shape):
    from trackmaker_tpu import io as jio

    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.6, shape).astype(np.float32)      # some clip at full scale
    tio.write_wav(tmp_path / "a.wav", x, 44_100)
    jio.write_wav(tmp_path / "b.wav", x, 44_100)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    got, sr = tio.read_wav(tmp_path / "a.wav")
    want, jsr = jio.read_wav(tmp_path / "a.wav")
    assert sr == jsr == 44_100
    np.testing.assert_array_equal(got, want)


def test_read_wav_other_widths_equal_jax(tmp_path):
    import wave

    from trackmaker_tpu import io as jio

    rng = np.random.default_rng(6)
    for width, raw in ((1, rng.integers(0, 256, 600, dtype=np.uint8).tobytes()),
                       (4, rng.integers(-2**31, 2**31, 600, dtype=np.int64).astype("<i4").tobytes())):
        path = tmp_path / f"w{width}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(8_000)
            w.writeframes(raw)
        got, sr = tio.read_wav(path)
        want, _ = jio.read_wav(path)
        assert sr == 8_000 and got.shape == (2, 300)
        np.testing.assert_array_equal(got, want)


def test_json_and_wav_dumps_equal_jax(tmp_path):
    from trackmaker_tpu import io as jio

    x = np.random.default_rng(7).normal(0, 0.3, 500).astype(np.float32)
    a = tio.AudioData(48_000, x)
    assert a.duration == jio.AudioData(48_000, x).duration
    tio.dump_to_json(tmp_path / "a" / "t.json", a)
    jio.dump_to_json(tmp_path / "b" / "t.json", jio.AudioData(48_000, x))
    assert (tmp_path / "a" / "t.json").read_text() == (tmp_path / "b" / "t.json").read_text()
    got, want = tio.load_json(tmp_path / "a" / "t.json"), jio.load_json(tmp_path / "a" / "t.json")
    assert (got.sample_rate, got.channels, got.duration) == (
        want.sample_rate, want.channels, want.duration)
    np.testing.assert_array_equal(got.audio_data, want.audio_data)
    tio.dump_to_wav(tmp_path / "a.wav", a)
    jio.dump_to_wav(tmp_path / "b.wav", jio.AudioData(48_000, x))
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


# --- utils ---------------------------------------------------------------------------


def test_bintxt_equals_jax(tmp_path):
    from trackmaker_tpu.utils import bintxt as jbt
    from trackmaker_tpu_torch.utils import bintxt

    text = b"The quick brown fox \x00\xff"
    assert bintxt.text_to_bits(text) == jbt.text_to_bits(text)
    assert bintxt.text_to_bits("café") == jbt.text_to_bits("café")
    bits = bintxt.text_to_bits(text)
    for b in (bits, " " + bits[:-3] + "\n", "10 1"):
        assert bintxt.bits_to_text(b) == jbt.bits_to_text(b)
    (tmp_path / "in.txt").write_text(bits[:100])
    bintxt.bits_file_to_text(tmp_path / "in.txt", tmp_path / "a.bin")
    jbt.bits_file_to_text(tmp_path / "in.txt", tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    bintxt.text_file_to_bin(tmp_path / "in.txt", tmp_path / "c.bin")
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "in.txt").read_bytes()


def test_progress_bar_draws_as_jax():
    import io as stdio

    from trackmaker_tpu.utils import ProgressBar as JaxProgressBar
    from trackmaker_tpu_torch.utils import ProgressBar

    outs = []
    for cls in (ProgressBar, JaxProgressBar):
        buf = stdio.StringIO()
        bar = cls("SEND", 200, width=20, stream=buf, min_interval=0.0)
        for _ in range(4):
            bar.inc(70)
        bar.finish("done")
        text = buf.getvalue()
        outs.append(text[: text.rindex("(")])    # the last field is the wall time
    assert outs[0] == outs[1]
    assert "SEND [####################] 200/200 (100.0%) done" in outs[0]


# --- the batched frame codec ------------------------------------------------------------


def frame_batch(rng, b: int = 24, max_len: int = 40):
    payload = rng.integers(0, 256, (b, max_len), dtype=np.uint8)
    length = rng.integers(0, max_len + 1, b).astype(np.int32)
    length[:3] = [0, max_len, max_len + 25]          # empty, full, past the maximum
    length[3] = 70_000                               # past 16 bits
    length[4] = -3
    fields = [rng.integers(0, 300, b).astype(np.int32) for _ in range(4)]
    fields[0][:6] = [1, 2, 0, 3, 255, 1]             # data, ack, invalid types
    return payload, length, fields


def test_build_frame_bytes_equals_jax():
    import jax.numpy as jnp

    from trackmaker_tpu.core import framing as jframing
    from trackmaker_tpu_torch.core import framing

    payload, length, fields = frame_batch(np.random.default_rng(8))
    got = framing.build_frame_bytes(torch.from_numpy(payload), torch.from_numpy(length),
                                    *(torch.from_numpy(f) for f in fields))
    want = jframing.build_frame_bytes(jnp.asarray(payload), jnp.asarray(length),
                                      *(jnp.asarray(f) for f in fields))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r in range(6, len(length)):            # each row the host Frame's bytes
        f = framing.Frame(int(fields[0][r]) & 0xFF, int(fields[1][r]) & 0xFF,
                          int(fields[2][r]) & 0xFF, int(fields[3][r]) & 0xFF,
                          payload[r, :length[r]].tobytes())
        assert got[r, :7 + length[r]].numpy().tobytes() == f.to_bytes()


def test_verify_frames_equals_jax():
    import jax.numpy as jnp

    from trackmaker_tpu.core import framing as jframing
    from trackmaker_tpu_torch.core import framing

    rng = np.random.default_rng(9)
    payload, length, fields = frame_batch(rng)
    fb = np.asarray(jframing.build_frame_bytes(jnp.asarray(payload), jnp.asarray(length),
                                               *(jnp.asarray(f) for f in fields)))
    fb = np.concatenate([fb, rng.integers(0, 256, (8, fb.shape[1]), dtype=np.uint8)])
    for r in range(6, 14):                     # bad CRCs: a flipped payload bit or CRC byte
        col = 2 if r % 2 else 7 + int(rng.integers(0, max(int(length[r]), 1)))
        fb[r, col] ^= 1 << int(rng.integers(0, 8))
    got = framing.verify_frames(torch.from_numpy(fb))
    want = jframing.verify_frames(jnp.asarray(fb))
    assert set(got) == set(want) and "crc_ok" in got
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
    ok = got["crc_ok"].numpy()
    assert ok[:2].all() and not ok[6:14:2].all()


# --- filters -------------------------------------------------------------------------


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n_taps", [1, 2, 7, 8, 31, 32])
def test_fir_filter_equals_jax(n_taps):
    import jax.numpy as jnp

    from trackmaker_tpu.dsp import filters as jf
    from trackmaker_tpu_torch.dsp import filters

    rng = np.random.default_rng(10 + n_taps)
    x = rng.normal(size=(3, 2, 700)).astype(np.float32)
    taps = rng.normal(size=n_taps).astype(np.float32)
    for mode in ("same", "full", "valid"):
        close(filters.fir_filter(torch.from_numpy(x), torch.from_numpy(taps), mode),
              jf.fir_filter(jnp.asarray(x), jnp.asarray(taps), mode))
    close(filters.fir_filter(torch.from_numpy(x[0, 0]), taps),
          jf.fir_filter(jnp.asarray(x[0, 0]), jnp.asarray(taps)))
    with pytest.raises(ValueError):
        filters.fir_filter(torch.from_numpy(x), taps, "causal")


def test_box_smooth_truncated_equals_jax():
    import jax.numpy as jnp

    from trackmaker_tpu.dsp import filters as jf
    from trackmaker_tpu_torch.dsp import filters

    x = np.random.default_rng(11).normal(size=(4, 300)).astype(np.float32)
    for half in (0, 1, 5, 12):
        close(filters.box_smooth_truncated(torch.from_numpy(x), half),
              jf.box_smooth_truncated(jnp.asarray(x), half))


@pytest.mark.parametrize("n_taps,lo,hi", [(101, 2_000.0, 4_000.0), (64, 500.0, 1_000.0),
                                          (31, 6_000.0, 12_000.0), (8, 100.0, 20_000.0)])
def test_sinc_and_bandpass_taps_equal_jax(n_taps, lo, hi):
    from trackmaker_tpu.dsp import filters as jf
    from trackmaker_tpu_torch.dsp import filters

    close(filters.sinc_lowpass_taps(n_taps, hi, 48_000, device="cpu"),
          jf.sinc_lowpass_taps(n_taps, hi, 48_000))
    close(filters.bandpass_taps(n_taps, lo, hi, 48_000, device="cpu"),
          jf.bandpass_taps(n_taps, lo, hi, 48_000))
