"""The port's blocked decode of one long capture
(trackmaker_tpu_torch/parallel/stream.py) against the JAX package's
(trackmaker_tpu/parallel/stream.py), on the CPU.

The corpora are those of tests/test_blocked_spec.py and
tests/test_parallel_adversarial.py, encoded by the port's encoder: frames
that straddle block seams, some with a payload that embeds a preamble and
a CRC-valid frame (so consumption, not only detection, crosses a seam),
chains of such frames across several seams, blocks smaller than the halo,
and a 4B5B frame with a zeroed level across a seam.  JAX's speculative
route runs its Pallas kernels in interpret mode, its exact route as on any
CPU; the port runs its kernels' plain versions.  Each JAX reference runs
once per module.

Tolerances: the valid masks, ok flags and the valid-masked frame fields
(bytes, length, type, sequence, addresses, start) are exactly equal, the
correlation at each frame within 1e-5 (sum order).  Against the port's own
sequential exact scan the decoded frames are equal as a set of (start,
sequence, bytes): the blocked and the sequential decodes keep them in
other slots."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.parallel import stream as jstream
from trackmaker_tpu.phy import pallas_decode as pd
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel import stream
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.decoder import decode_capture
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits_plain, xcorr_hits_refine_plain

CORR_ATOL = 1e-5
LOCAL = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(coding: str):
    jcfg = JaxPhyConfig(line_coding=coding)
    return jcfg, convert.phy_config_from_fields(dataclasses.asdict(jcfg))


def _raw(data: bytes, seq=0, src=1, dst=2, ftype=1) -> bytes:
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype, seq, src, dst]) + data


def _evil_frame(seq: int, payload: bytes) -> Frame:
    """A frame whose payload embeds the preamble's bytes and a CRC-valid
    frame (sequence 99) after them."""
    return Frame.new_data(seq, 1, 2, bytes([0x33, 0x5A]) + _raw(payload, seq=99))


def _place(cfg, total: int, placed) -> np.ndarray:
    enc = PhyEncoder(cfg, device="cpu")
    wave = np.zeros(total, np.float32)
    for pos, frame in placed:
        w = enc.encode_frame(frame).numpy()
        wave[pos: pos + len(w)] = w
    return wave


def _evil_seam(cfg) -> np.ndarray:
    block = 16000
    return _place(cfg, 6 * block, [
        (block - 200, _evil_frame(1, b"EVIL-EMBEDDED")),         # straddles seam 0|1
        (2 * block - 40, Frame.new_data(2, 1, 2, b"plain-straddler")),
        (3 * block + 500, _evil_frame(3, b"MID-BLOCK")),
        (4 * block - 150, Frame.new_data(4, 1, 9, b"not-for-us")),
        (5 * block + 100, Frame.new_data(5, 1, 2, b"tail")),
    ])


def _chain(cfg, n_blocks: int, max_frames: int) -> np.ndarray:
    """Back-to-back evil frames from just before seam 0|1, each crossing a
    new seam, in blocks barely longer than the halo."""
    w = PhyEncoder(cfg, device="cpu").encode_frame(_evil_frame(7, b"CHAIN")).numpy()
    block = stream.halo_size(cfg) + 200
    total = n_blocks * block
    wave = np.zeros(total, np.float32)
    pos, k = block - 60, 0
    while pos + len(w) < total - block and k < max_frames:
        wave[pos: pos + len(w)] = w
        pos += len(w)
        k += 1
    return wave


def _small_blocks(cfg, n_blocks: int, div: int) -> np.ndarray:
    """An evil frame spanning several blocks of halo // div samples, and a
    frame at the end."""
    block = stream.halo_size(cfg) // div
    total = n_blocks * block
    tail_len = len(PhyEncoder(cfg, device="cpu").encode_frame(
        Frame.new_data(2, 1, 2, b"tail")))
    return _place(cfg, total, [(block - 60, _evil_frame(1, b"WIDE")),
                               (total - tail_len - 10, Frame.new_data(2, 1, 2, b"tail"))])


def _zeroed(cfg) -> np.ndarray:
    """A 4B5B frame straddling seam 0|1 with one level's samples zeroed."""
    w = PhyEncoder(cfg, device="cpu").encode_frame(Frame.new_data(1, 1, 2, b"zeroed-lv")).numpy()
    lv = cfg.preamble_len + 20 * 15 + 3
    w[lv: lv + 3] = 0.0
    wave = np.zeros(4 * 8000, np.float32)
    wave[8000 - 80: 8000 - 80 + len(w)] = w
    return wave


# name -> (line code, corpus, n_blocks, max_frames_per_block, n_cand, sequential max_frames)
CORPORA = {
    "evil-manchester": (MANCHESTER, _evil_seam, 6, 8, 32, 32),
    "evil-4b5b": (FOUR_B_FIVE_B, _evil_seam, 6, 8, 32, 32),
    "chain": (MANCHESTER, lambda c: _chain(c, 6, 4), 6, 8, 64, 16),
    "chain-8": (MANCHESTER, lambda c: _chain(c, 8, 6), 8, 8, 128, 32),
    "small-blocks": (MANCHESTER, lambda c: _small_blocks(c, 6, 2), 6, 8, 32, 16),
    "small-blocks-10": (MANCHESTER, lambda c: _small_blocks(c, 10, 3), 10, 8, 32, 16),
    "zeroed-4b5b": (FOUR_B_FIVE_B, _zeroed, 4, 8, 32, 32),
}
SPEC_CASES = ["evil-manchester", "evil-4b5b", "chain", "small-blocks", "zeroed-4b5b"]
EXACT_CASES = ["evil-manchester", "evil-4b5b", "chain-8"]
FOLD_CASES = ["evil-manchester", "evil-4b5b"]


def _corpus(name: str):
    coding, build, n_blocks, mfpb, n_cand, seq_mf = CORPORA[name]
    jcfg, cfg = _configs(coding)
    return jcfg, cfg, build(cfg), n_blocks, mfpb, n_cand, seq_mf


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's result of (route, corpus), computed at first use and kept:
    route "spec" and "fold" (the speculative route, the fold on) return
    (frames, ok), "exact" the frames of its exact route."""
    cache = {}

    def get(route: str, name: str):
        if (route, name) not in cache:
            jcfg, _, wave, n_blocks, mfpb, n_cand, _ = _corpus(name)
            if route == "exact":
                out = jstream.decode_blocked_single_chip(
                    jcfg, wave, LOCAL, n_blocks=n_blocks, max_frames_per_block=mfpb)
                cache[route, name] = jax.tree_util.tree_map(np.asarray, out)
            else:
                old = pd.SYNC_FOLD
                pd.SYNC_FOLD = route == "fold"
                try:
                    res, ok = jstream._decode_blocked_spec(
                        jcfg, jnp.asarray(wave), LOCAL, n_blocks, mfpb, len(wave), n_cand,
                        interpret=True)
                finally:
                    pd.SYNC_FOLD = old
                cache[route, name] = (jax.tree_util.tree_map(np.asarray, res),
                                      bool(np.asarray(ok)))
        return cache[route, name]

    return get


def _assert_frames_equal(got, want, what: str) -> None:
    """Valid masks equal; every field of the valid slots equal, the corr
    within CORR_ATOL."""
    valid = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), valid), what
    for name in got._fields[1:]:
        g, w = getattr(got, name).numpy()[valid], np.asarray(getattr(want, name))[valid]
        if name == "corr":
            assert np.abs(g - w).max(initial=0.0) <= CORR_ATOL, what
        else:
            assert np.array_equal(g, w), (what, name)


def _decoded_set(res) -> list:
    valid = res.valid.numpy()
    return sorted((int(st), int(sq), fb[: 7 + int(ln)].tobytes())
                  for v, st, sq, ln, fb in zip(valid, res.start.numpy(), res.sequence.numpy(),
                                               res.length.numpy(), res.frame_bytes.numpy())
                  if v)


@pytest.mark.parametrize("name", SPEC_CASES)
def test_spec_route_equals_jax(jax_ref, name):
    _, cfg, wave, n_blocks, mfpb, n_cand, _ = _corpus(name)
    want, want_ok = jax_ref("spec", name)
    got, ok, _ = stream.decode_blocked_spec(cfg, torch.from_numpy(wave), LOCAL, n_blocks, mfpb,
                                            n_cand)
    assert bool(ok) == want_ok == (name != "zeroed-4b5b")
    _assert_frames_equal(got, want, name)
    if name.startswith("evil"):
        seqs = {sq for _, sq, _ in _decoded_set(got)}
        assert 1 in seqs and 99 not in seqs   # the evil frame, not the frame it embeds


@pytest.mark.parametrize("name", FOLD_CASES)
def test_spec_route_fold_equals_jax_and_legacy(jax_ref, monkeypatch, name):
    _, cfg, wave, n_blocks, mfpb, n_cand, _ = _corpus(name)
    x = torch.from_numpy(wave)
    legacy = stream.decode_blocked_spec(cfg, x, LOCAL, n_blocks, mfpb, n_cand)
    monkeypatch.setattr(sd, "SYNC_FOLD", True)
    got, ok, _ = stream.decode_blocked_spec(cfg, x, LOCAL, n_blocks, mfpb, n_cand)
    want, want_ok = jax_ref("fold", name)
    assert bool(ok) and want_ok
    _assert_frames_equal(got, want, name)
    for g, w in zip([*got, ok], [*legacy[0], legacy[1]]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", EXACT_CASES)
def test_exact_route_equals_jax(jax_ref, name):
    _, cfg, wave, n_blocks, mfpb, _, _ = _corpus(name)
    got = stream.decode_blocked_exact(cfg, torch.from_numpy(wave), LOCAL, n_blocks, mfpb)
    _assert_frames_equal(got, jax_ref("exact", name), name)


@pytest.mark.parametrize("name", list(CORPORA))
def test_single_chip_equals_sequential(monkeypatch, name):
    _, cfg, wave, n_blocks, mfpb, n_cand, seq_mf = _corpus(name)
    x = torch.from_numpy(wave)
    exact_calls = []
    exact = stream.decode_blocked_exact

    def counted(*args):
        exact_calls.append(args)
        return exact(*args)

    monkeypatch.setattr(stream, "decode_blocked_exact", counted)
    got = stream.decode_blocked_single_chip(cfg, x, LOCAL, n_blocks, mfpb, n_cand)
    want = _decoded_set(decode_capture(cfg, x, LOCAL, max_frames=seq_mf))
    assert _decoded_set(got) == want
    # only the 4B5B frame with a zeroed level sends the capture to the exact
    # route, and no route decodes that frame
    assert len(exact_calls) == (name == "zeroed-4b5b")
    assert bool(want) == (name != "zeroed-4b5b")
    assert all(sq != 99 for _, sq, _ in want)


ATTEMPTS = {
    "manchester": (MANCHESTER, False, sd.attempt_manchester_plain),
    "manchester-fold": (MANCHESTER, True, sd.attempt_manchester_fold_plain),
    "4b5b": (FOUR_B_FIVE_B, False, sd.attempt_4b5b_plain),
    "4b5b-fold": (FOUR_B_FIVE_B, True, sd.attempt_4b5b_fold_plain),
}


def _shared_inputs(cfg, wave: np.ndarray, n_blocks: int, n_cand: int, fold: bool):
    """The flat capture expanded to every block, f32[n_blocks, T] with a
    row stride of 0, and its per-block candidate tables, as spec_phase_a's
    flat mode makes them: (x, arguments after x)."""
    t = len(wave)
    block = t // n_blocks
    x = torch.from_numpy(wave)[None]
    vlens = torch.full((n_blocks,), t, dtype=torch.int32)
    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    if fold:
        rows = xcorr_hits_refine_plain(
            x, vlens[:1], pre, sync, cfg.correlation_threshold,
            sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
            n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)
    else:
        rows = xcorr_hits_plain(x, pre, cfg.correlation_threshold)[1]
    rows = rows[0].reshape(n_blocks, block // 128, -1)
    if fold:
        _, _, n_valid, _, fs = sd.compact_hit_rows(rows, n_cand, with_fs=True)
        return x.expand(n_blocks, -1), (fs, n_valid)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, n_cand)
    return x.expand(n_blocks, -1), (cand, n_valid, vlens, sync, preamble_energy(sync))


@pytest.mark.parametrize("form", list(ATTEMPTS))
def test_shared_plain_attempts_equal_batched(form):
    """Each shared-capture plain attempt on the evil-seam capture equals the
    batched plain attempt on the capture repeated for every block; some
    frames read past their block's end."""
    coding, fold, attempt = ATTEMPTS[form]
    _, cfg = _configs(coding)
    wave = _evil_seam(cfg)
    n_blocks, n_cand = 6, 32
    x, args = _shared_inputs(cfg, wave, n_blocks, n_cand, fold)
    got = attempt(x, *args)
    want = attempt(x.contiguous(), *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fs, live = got[1], sd._live(got[1], args[1])
    body = (sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES if coding == MANCHESTER
            else sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES)
    block_end = (torch.arange(n_blocks)[:, None] + 1) * (len(wave) // n_blocks)
    assert bool((live & (fs + body > block_end)).any())


def test_flat_mode_and_shared_form_check_their_capture():
    """The flat mode refuses a capture that is not n_blocks whole blocks,
    and the attempts' argument check (run before a launch) takes one
    capture expanded to the tables' rows but refuses one row for several,
    or rows that are not contiguous."""
    _, cfg = _configs(MANCHESTER)
    wave = _evil_seam(cfg)
    x, args = _shared_inputs(cfg, wave, 6, 32, False)
    with pytest.raises(ValueError, match="flat_blocks"):
        sd.spec_phase_a(cfg, x[0, :-1], LOCAL, 32, args[2], flat_blocks=(6, 16000))
    sd._check_attempt_args(x, *args[:4], 48)
    for bad in (x[:1], x[:, ::2]):
        with pytest.raises(ValueError, match="x must be"):
            sd._check_attempt_args(bad, *args[:4], 48)


@pytest.fixture(scope="module")
def past_2_24():
    """A capture of 20 blocks of 891,392 samples (2^24 + 1,050,624 in all;
    a block is a whole number of 128-sample hit rows, so both routes cut
    the capture at the same seams), silent but for four frames past 2^24,
    one across the last seam."""
    _, cfg = _configs(MANCHESTER)
    n_blocks, block = 20, 891_392
    t = n_blocks * block
    assert stream.spec_block(t, n_blocks) == block == -(-t // n_blocks)
    seam = (n_blocks - 1) * block
    starts = [2**24 + 1001, 2**24 + 9003, seam - 1000, 2**24 + 600_007]
    frames = [Frame.new_data(i, 1, 2, bytes([7 + i]) * 33) for i in range(len(starts))]
    x = torch.zeros(t)
    enc = PhyEncoder(cfg, device="cpu")
    for s, f in zip(starts, frames):
        w = enc.encode_frame(f)
        x[s: s + len(w)] = w
    assert 2**24 < seam - 1000 < seam < seam - 1000 + len(w)   # a straddler past 2^24
    return cfg, x, n_blocks, starts, frames


@pytest.mark.parametrize("route", ["spec", "exact"])
def test_positions_past_2_24_stay_exact(past_2_24, route):
    cfg, x, n_blocks, starts, frames = past_2_24
    if route == "spec":
        res, ok, _ = stream.decode_blocked_spec(cfg, x, LOCAL, n_blocks, 4, n_cand=16)
        assert bool(ok)
    else:
        res = stream.decode_blocked_exact(cfg, x, LOCAL, n_blocks, 4)
    valid = res.valid
    assert res.start[valid].tolist() == starts
    assert [f.data for f in res.to_frames()] == [f.data for f in frames]
