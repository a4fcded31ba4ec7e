"""The port's streaming receive path (``trackmaker_tpu_torch.phy.decoder.
PhyDecoder`` and ``trackmaker_tpu_torch.link.stream``) against the JAX
package's, on the CPU, and on the card against the port's CPU run.

On the CPU the JAX ``PhyDecoder`` runs its exact scan (its speculative
route needs a TPU) while the port's runs the speculative decode's cursor
(the kernels' plain versions), so each call's frames, the samples it
searched and the buffer it keeps must agree between the two routes.  The
corpora are built by the port (its encoder, NumPy noise), so the tests
marked ``gpu`` build them on a card without JAX: this module imports JAX
only inside its tests.

Tolerances: none.  Frames, ``searched``, buffer lengths, segment regions
and the pipeline's counters are integers and bytes, and must be equal.
"""

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link import stream
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.decoder import PhyDecoder
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits

CFG = PhyConfig()
CFG4 = PhyConfig(line_coding=FOUR_B_FIVE_B)
CFG_EXACT = PhyConfig(max_frame_data_size=64)   # spec_supported_cfg rejects it

# (line code, chunk, max_frames, local address): every chunk, cap and
# address meets both line codes
FEEDS = [(coding, chunk, max_frames, addr) for coding in (MANCHESTER, FOUR_B_FIVE_B)
         for chunk, max_frames, addr in ((480, 8, 3), (1200, 16, -1), (4097, 8, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg: PhyConfig):
    import dataclasses

    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig

    return JaxPhyConfig(**dataclasses.asdict(cfg))


# --- the corpora (no JAX) -------------------------------------------------------------


def decoder_track(cfg: PhyConfig, seed: int = 0) -> np.ndarray:
    """A live-capture track: data frames for addresses 2, 3 and 255 of 1 to
    `max_frame_data_size` bytes with random gaps, a frame cut at 60%, a
    back-to-back burst of 20 ACKs, 16 of them to address 2 (a 4,097-sample
    chunk holds more than 8), a stretch of loud noise, all under noise
    sigma 0.05."""
    rng = np.random.default_rng(seed)
    enc = PhyEncoder(cfg, device="cpu")
    top = cfg.max_frame_data_size

    def data(i: int, dst: int, n: int) -> np.ndarray:
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        return enc.encode_frame(Frame.new_data(i, 1, dst, payload)).numpy()

    parts = [np.zeros(3000, np.float32)]
    for i, (dst, n) in enumerate([(2, 40), (3, top), (2, 1), (255, 77), (2, top), (3, 9)]):
        parts += [data(i, dst, n), np.zeros(int(rng.integers(48, 2000)), np.float32)]
    cut = data(6, 2, top)
    parts += [cut[:int(0.6 * len(cut))], np.zeros(1500, np.float32), data(7, 2, 20)]
    acks = [Frame.new_ack(s, 1, 2 if s < 16 else 3) for s in range(20)]
    parts += [np.zeros(700, np.float32), enc.encode_frames(acks).numpy(),
              np.zeros(900, np.float32), rng.normal(0, 0.3, 5000).astype(np.float32),
              data(8, 3, 30), np.zeros(2000, np.float32)]
    x = np.concatenate(parts)
    return (x + rng.normal(0, 0.05, len(x))).astype(np.float32)


def sparse_capture(cfg: PhyConfig, n_frames: int, silence: int = 20_000, seed: int = 0):
    """tests/test_stream_pipeline.py's corpus: (frames, wave)."""
    rng = np.random.default_rng(seed)
    enc = PhyEncoder(cfg, device="cpu")
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 48, dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    parts = [np.zeros(silence, np.float32)]
    for f in frames:
        parts += [enc.encode_frame(f).numpy(), np.zeros(silence, np.float32)]
    return frames, np.concatenate(parts)


def pipeline_corpora() -> dict[str, tuple[PhyConfig, np.ndarray, int]]:
    """(configuration, wave, chunk) of each streaming corpus: those of
    tests/test_stream_pipeline.py, and the sparse one in 4B5B."""
    _, sparse = sparse_capture(CFG, 6)
    _, quiet = sparse_capture(CFG, 3, silence=30_000, seed=1)
    noisy = quiet + np.random.default_rng(2).normal(0, 0.015, len(quiet)).astype(np.float32)
    _, sparse4 = sparse_capture(CFG4, 6, seed=3)
    return {"sparse": (CFG, sparse, 4096), "noise_floor": (CFG, noisy, 8192),
            "silence": (CFG, np.zeros(100_000, np.float32), 100_000),
            "sparse_4b5b": (CFG4, sparse4, 4096)}


def segment_inputs() -> dict[str, tuple[np.ndarray, float, int, int]]:
    """(x, threshold, hang, halo) around the segmenter's edges."""
    thr, hang, halo = 0.05, 400, 110

    def hot(n: int, at: list[int], v: float = 0.5) -> np.ndarray:
        x = np.zeros(n, np.float32)
        x[at] = v
        return x

    rng = np.random.default_rng(7)
    bursty = rng.normal(0, 0.02, 30_000).astype(np.float32)
    for s in (50, 4_000, 4_350, 12_000, 29_900):
        bursty[s:s + 60] += 0.6
    at_thr = hot(2_000, [100, 900])
    at_thr[[500, 501]] = np.float32(thr)
    return {
        "empty": (np.zeros(0, np.float32), thr, hang, halo),
        "silent": (np.zeros(5_000, np.float32), thr, hang, halo),
        "gap_hang": (hot(3_000, [1_000, 1_000 + hang]), thr, hang, halo),
        "gap_hang_plus_1": (hot(3_000, [1_000, 1_001 + hang]), thr, hang, halo),
        "halo_clipped_both_ends": (hot(600, [3, 590]), thr, 2, halo),
        # split bursts (a gap above 100) whose halos overlap, touch, or not
        "halos_merge": (hot(3_000, [500, 500 + 2 * halo]), thr, 100, halo),
        "halos_touch": (hot(3_000, [500, 501 + 2 * halo]), thr, 100, halo),
        "halos_apart": (hot(3_000, [500, 502 + 2 * halo]), thr, 100, halo),
        "at_threshold": (at_thr, thr, 100, 20),
        "negative": (-hot(2_000, [10, 1_500]), thr, 100, 20),
        "bursty_noise": (bursty, thr, hang, halo),
    }


# --- the recorders --------------------------------------------------------------------


class RecordingDecoder(PhyDecoder):
    """The port's PhyDecoder, recording each decode's route, length and
    searched prefix."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = []   # (route, n, searched)

    def _decode_with_cursor(self, padded, n):
        exact = self.exact_calls
        res, searched = super()._decode_with_cursor(padded, n)
        self.calls.append(("exact" if self.exact_calls > exact else "spec", n, searched))
        return res, searched


def _feed(dec, x: np.ndarray, chunk: int) -> list[tuple]:
    """Per call: (frames as tuples, buffer length after it)."""
    out = []
    for i in range(0, len(x), chunk):
        frames = dec.process_samples(x[i:i + chunk])
        out.append(([(f.frame_type, f.sequence, f.src, f.dst, f.data) for f in frames],
                    len(dec._buf)))
    return out


def _jax_feed(cfg: PhyConfig, addr: int, max_frames: int, x: np.ndarray, chunk: int):
    """The JAX PhyDecoder's per-call results and its searched prefixes."""
    from trackmaker_tpu.phy.decoder import PhyDecoder as JaxPhyDecoder

    class Recording(JaxPhyDecoder):
        def _decode_with_cursor(self, padded, n):
            res, searched = super()._decode_with_cursor(padded, n)
            self.calls.append((n, int(searched)))
            return res, searched

    dec = Recording(_jcfg(cfg), addr, max_frames)
    dec.calls = []
    return _feed(dec, x, chunk), dec.calls


def _port_feed(cfg: PhyConfig, addr: int, max_frames: int, x: np.ndarray, chunk: int,
               device="cpu"):
    dec = RecordingDecoder(cfg, addr, max_frames, device=device)
    return _feed(dec, x, chunk), dec.calls


# --- PhyDecoder -----------------------------------------------------------------------


@pytest.mark.parametrize("coding,chunk,max_frames,addr", FEEDS)
def test_phy_decoder_matches_jax_call_for_call(coding, chunk, max_frames, addr):
    cfg = CFG if coding == MANCHESTER else CFG4
    x = decoder_track(cfg, seed=chunk)
    got, got_calls = _port_feed(cfg, addr, max_frames, x, chunk)
    want, want_calls = _jax_feed(cfg, addr, max_frames, x, chunk)
    assert [(n, s) for _, n, s in got_calls] == want_calls
    assert got == want
    routes = [r for r, _, _ in got_calls]
    if coding == MANCHESTER:
        assert routes.count("exact") <= 2, routes
    else:
        # a 4B5B frame cut by the buffer's end reads the bucket's zero
        # padding as near-zero levels, which sends that call to the exact
        # scan (the speculative decode's rule, as in the JAX package)
        assert 0 < routes.count("spec") < len(routes), routes
    assert sum(len(f) for f, _ in got) >= 6
    if chunk == 4097:
        # the ACK burst leaves more than 8 frames in one buffer: the
        # cursor, not the end of the candidates, sets the drop there
        assert any(len(f) == max_frames for f, _ in got)


def test_phy_decoder_exact_route_matches_jax():
    """A configuration the speculative decode is not specialized for takes
    the exact scan on every call."""
    assert not sd.spec_supported_cfg(CFG_EXACT)
    x = decoder_track(CFG_EXACT, seed=5)
    got, got_calls = _port_feed(CFG_EXACT, 2, 8, x, 1200)
    want, want_calls = _jax_feed(CFG_EXACT, 2, 8, x, 1200)
    assert {r for r, _, _ in got_calls} == {"exact"}
    assert [(n, s) for _, n, s in got_calls] == want_calls
    assert got == want
    assert sum(len(f) for f, _ in got) >= 6


def test_phy_decoder_reset_and_short_buffers():
    dec = PhyDecoder(CFG, 2, device="cpu")
    assert dec.process_samples(np.zeros(CFG.preamble_len + CFG.header_samples - 1,
                                        np.float32)) == []
    assert len(dec._buf) == CFG.preamble_len + CFG.header_samples - 1
    dec.reset()
    assert len(dec._buf) == 0
    assert PhyDecoder._bucket(1) == 4096 and PhyDecoder._bucket(4097) == 8192


def test_phy_decoder_default_device_is_the_card():
    dec = PhyDecoder(CFG, 2)
    assert dec.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            dec.process_samples(np.zeros(5_000, np.float32))


# --- the segmenter ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(segment_inputs()))
def test_segmenter_matches_jax_native_and_numpy(name):
    from trackmaker_tpu import runtime
    from trackmaker_tpu.link.stream import StreamingDecodePipeline as JaxPipeline

    x, thr, hang, halo = segment_inputs()[name]
    got = stream.active_regions(x, thr, hang, halo)
    native = runtime.active_regions(x, threshold=thr, hang=hang, halo=halo)
    jpipe = JaxPipeline(_jcfg(CFG), 2, energy_threshold=thr, use_native=False)
    jpipe.hang, jpipe.halo = hang, halo
    numpy_branch = jpipe._regions(x)
    assert got.dtype == np.int64 and got.shape[1:] == (2,)
    np.testing.assert_array_equal(got, native.reshape(-1, 2))
    np.testing.assert_array_equal(got, numpy_branch.reshape(-1, 2))
    expect = {"empty": 0, "silent": 0, "gap_hang": 1, "gap_hang_plus_1": 2,
              "halo_clipped_both_ends": 2, "halos_merge": 1, "halos_touch": 1,
              "halos_apart": 2}
    if name in expect:
        assert len(got) == expect[name]
    if name == "halo_clipped_both_ends":
        assert got[0, 0] == 0 and got[-1, 1] == len(x)


# --- StreamingDecodePipeline ----------------------------------------------------------


def _run_pipeline(pipe, x: np.ndarray, chunk: int):
    pushed = []
    for i in range(0, len(x), chunk):
        pushed.append([(f.sequence, f.data) for f in pipe.push(x[i:i + chunk])])
    flushed = [(f.sequence, f.data) for f in pipe.flush()]
    return pushed, flushed, (pipe.segments_decoded, pipe.samples_shipped, pipe.samples_seen)


@pytest.mark.parametrize("name", list(pipeline_corpora()))
def test_streaming_pipeline_matches_jax(name):
    from trackmaker_tpu.link.stream import StreamingDecodePipeline as JaxPipeline

    cfg, x, chunk = pipeline_corpora()[name]
    got = _run_pipeline(stream.StreamingDecodePipeline(cfg, 2, device="cpu"), x, chunk)
    want = _run_pipeline(JaxPipeline(_jcfg(cfg), 2), x, chunk)
    assert got == want
    pushed, flushed, (segments, shipped, seen) = got
    frames = [f for call in pushed for f in call] + flushed
    if name == "silence":
        assert frames == [] and segments == 0
    elif name == "noise_floor":
        assert len(frames) == 3
    else:
        # the point of the gate: a fraction of the stream reaches the decoder
        assert len(frames) == 6 and shipped < 0.6 * seen


def test_packed_decode_round_trip():
    """The pack's fields, read back, give the speculative decode's frames;
    a pack whose decode is not ok parses to (False, [])."""
    _, x = sparse_capture(CFG, 2, silence=500)
    xn = stream.padded_segment(x)
    b = len(xn) - 1
    assert b == 8192 and xn[b] == len(x) and not xn[len(x):b].any()
    arr = stream.packed_decode(CFG, torch.from_numpy(xn), 2, 8)
    assert arr.dtype == torch.uint8 and arr.shape == (8, sd.FRAME_BYTES + 4)
    ok, frames = stream.parse_packed(arr.numpy())
    res, ok_s = sd.decode_capture_spec(CFG, torch.from_numpy(xn[None, :b]), 2, max_frames=8,
                                       valid_len=len(x))
    assert ok and bool(ok_s[0]) and frames == res.to_frames(0) and len(frames) == 2
    bad = arr.numpy().copy()
    bad[:, -1] = 0
    assert stream.parse_packed(bad) == (False, [])


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("coding,chunk,max_frames,addr", FEEDS)
def test_phy_decoder_on_the_card_equals_the_cpu(cuda, coding, chunk, max_frames, addr):
    cfg = CFG if coding == MANCHESTER else CFG4
    x = decoder_track(cfg, seed=chunk)
    got, got_calls = _port_feed(cfg, addr, max_frames, x, chunk, device=cuda)
    want, want_calls = _port_feed(cfg, addr, max_frames, x, chunk)
    assert got == want and got_calls == want_calls


@pytest.mark.gpu
def test_phy_decoder_exact_route_on_the_card_equals_the_cpu(cuda):
    x = decoder_track(CFG_EXACT, seed=5)
    assert _port_feed(CFG_EXACT, 2, 8, x, 1200, device=cuda) == _port_feed(
        CFG_EXACT, 2, 8, x, 1200)


@pytest.mark.gpu
def test_phy_decoder_launches_per_call(cuda):
    """A speculative call launches #1, the attempt and the walk once each; a
    call on a buffer shorter than a preamble and a header launches none.
    Nearly every Manchester call is speculative; about half the 4B5B calls
    fall to the exact scan (their buffer ends inside a frame)."""
    for cfg, attempt in ((CFG, sd.attempt_manchester), (CFG4, sd.attempt_4b5b)):
        x = decoder_track(cfg, seed=1)
        dec = PhyDecoder(cfg, 2, 8, device=cuda)
        kernels = (xcorr_hits, attempt, sd.spec_walk)
        speculative = 0
        for i in range(0, len(x), 1200):
            before = [k.launches for k in kernels]
            calls, exact = dec.decode_calls, dec.exact_calls
            dec.process_samples(x[i:i + 1200])
            torch.cuda.synchronize()
            launched = [k.launches - b for k, b in zip(kernels, before)]
            if dec.exact_calls == exact:
                speculative += dec.decode_calls - calls
                assert launched == [dec.decode_calls - calls] * 3
        calls = len(x) // 1200
        assert speculative >= (calls - 2 if cfg is CFG else calls // 3), speculative


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(pipeline_corpora()))
def test_streaming_pipeline_on_the_card_equals_the_cpu(cuda, name):
    cfg, x, chunk = pipeline_corpora()[name]
    got = _run_pipeline(stream.StreamingDecodePipeline(cfg, 2, device=cuda), x, chunk)
    want = _run_pipeline(stream.StreamingDecodePipeline(cfg, 2, device="cpu"), x, chunk)
    assert got == want


class HostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts every operator call that reads a CUDA tensor's data to the
    host (a copy from the card to the CPU, a scalar read by ``item``,
    ``tolist`` or ``bool``, an op whose output size depends on the data)
    and every copy from the CPU to the card.  A dispatch mode sees each
    operator call of this thread, so none is lost."""

    SYNCING = ("aten._local_scalar_dense", "aten.nonzero", "aten.equal", "aten.is_nonzero",
               "aten.masked_select", "aten.unique")

    def __init__(self):
        super().__init__()
        self.reads, self.h2d = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name in ("aten._to_copy", "aten.copy_"):
            src, dst = (args[1], args[0]) if name == "aten.copy_" else (args[0], out)
            if src.device.type == "cuda" and dst.device.type == "cpu":
                self.reads.append(name)
            elif src.device.type == "cpu" and dst.device.type == "cuda":
                self.h2d.append(name)
        elif name in self.SYNCING and any(
                isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args):
            self.reads.append(name)
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, CFG4], ids=[MANCHESTER, FOUR_B_FIVE_B])
def test_streaming_segment_reads_back_once(cuda, cfg):
    """A segment on the speculative path copies its padded samples to the
    card and reads one pack back: one device-to-host read, no other."""
    frames, x = sparse_capture(cfg, 2, silence=3000, seed=4)
    pipe = stream.StreamingDecodePipeline(cfg, 2, device=cuda)
    pipe._decode_segment(x)              # warm: build and load the kernels
    torch.cuda.synchronize()
    counter = HostReads()
    with counter:
        got = pipe._decode_segment(x)
    assert [f.data for f in got] == [f.data for f in frames]
    assert counter.reads == ["aten._to_copy"], counter.reads
    assert counter.h2d, "the padded segment was not copied to the card"


def test_host_reads_counter_needs_no_card():
    """The counter's rule on CPU tensors: no read of a card, no copy to one."""
    counter = HostReads()
    with counter:
        t = torch.arange(5)
        t.sum().item()
        torch.nonzero(t)
        t.cpu().tolist()
    assert counter.reads == [] and counter.h2d == []
