"""The port's CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` build the kernels with nvcc and run them on a CUDA
card; without one they skip.  On the card (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The other tests run anywhere: a wrapper given CPU tensors runs the plain
version and launches nothing.

Tolerances: correlations within atol 1e-5 (sum order); hit rows equal
except rows holding a lag within 1e-5 of the threshold; attempt bytes,
frame starts, first invalid and near-zero symbols, and walk outputs
exactly equal (kernel and plain version add in the same order).  The
normalized correlation at any length and its row stats: corr and row maxima
within atol 1e-5 of the plain versions (sum order), positions equal on rows
whose two largest lags differ by more; at L <= 128 exactly the correlation
kernel's dense corr and its reduction by row (the same sums in the same
order).  The equalized decode on the card: the equalized captures within
1e-4 of the CPU's, the decoded frames equal.  The ASK
kernels (sliding dot, fire rule, record chain, walk) equal their plain
versions exactly: the sliding dot adds its taps in one order in both, the
others only take maxima, compare and move integers.  The hit kernel's
refine entry and the attempt kernels' fold forms: hit rows as above, the
refine deltas and everything the attempts return exactly equal (the
refines add the same way in the kernels and the plain versions); the
refine entry's columns 0..8 and the batch-folded entry's rows equal the
hit kernel's bit for bit; the fold decode on the card equals the legacy
decode in every field.  The attempt kernels' shared-capture forms (one flat
capture read by every block's table) return exactly what their plain
versions and the per-row kernels on the capture repeated for every block
return.  The experiments' kernels (attempt tiles, offset add) equal their
plain versions exactly: both sum in k order, and the tools' inputs make
every product exact (ternary and 0/1 tables, small integers).  The hit
kernel's corr at a lag that ties the threshold equals the plain version's
bit for bit (both divide, and the sums are exact integers there).  The
robustness paths on the card (clock search, timing gate,
decision-directed decode): every field but the correlation equal to the
CPU's run; ``clock_offset`` bit for bit; the dense-hit extraction exactly.
The Viterbi kernel equals its plain version bit for bit (both add each
path's four branch metrics in trellis order, and every branch metric is one
rounded sum of exact products); the coded decodes on the card equal the
CPU's in starts, bits and frames."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import chip_smoke
from trackmaker_tpu_torch import PhyConfig, _build, decode_blocked_exact, decode_blocked_single_chip
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.core import convcode
from trackmaker_tpu_torch.dsp import channel, equalizer, timing
from trackmaker_tpu_torch.dsp.osc import chirp_np
from trackmaker_tpu_torch.parallel.stream import spec_block
from trackmaker_tpu_torch.phy import ask, ask_spec, ofdm, ofdm_adaptive, ofdm_v2
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
from trackmaker_tpu_torch.sync import find_pattern_starts
from trackmaker_tpu_torch.sync.correlate import pattern_norm, preamble_energy
from trackmaker_tpu_torch.sync.sliding_dot import sliding_dot_scaled, sliding_dot_scaled_plain
from trackmaker_tpu_torch.sync.xcorr_hits import (
    hit_rows_plain,
    xcorr_hits,
    xcorr_hits_batched,
    xcorr_hits_batched_plain,
    xcorr_hits_plain,
    xcorr_hits_refine,
    xcorr_hits_refine_plain,
)
from trackmaker_tpu_torch.sync.xcorr_norm import (
    normalized_xcorr_dense,
    normalized_xcorr_dense_plain,
    xcorr_rowstats,
    xcorr_rowstats_plain,
)
from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
from trackmaker_tpu_torch.tools import exp_offset_add as eo
from trackmaker_tpu_torch.tools import exp_xcorr_streams as ex
from trackmaker_tpu_torch.tools import health, prof_fused

# the edge inputs, from the CPU tests beside this file
from test_torch_ask_fire_chain_design import (
    CHAIN_GUARDS,
    CHAIN_WS,
    FIRE_MAX_W,
    FIRE_TS,
    FIRE_WS,
    chain_edge_rows,
    fire_cfg,
    fire_edge_inputs,
)
from test_torch_ask_walk_4b5b_design import (
    ASK_C1S,
    ASK_MFS,
    FOURB_FORMS,
    ask_edge_tables,
    ask_walk_serial,
    attempt_4b5b_call,
    fourb5b_edge_inputs,
)
from test_torch_channel_timing import GATE_CORPORA, gate_corpus, hit_vectors, skewed_capture
from test_torch_coded import KINDS as CODED_KINDS
from test_torch_coded import batch_corpus, port_phy
from test_torch_ofdm_adaptive import batch_corpus as adaptive_corpus
from test_torch_convcode import viterbi_corpora
from test_torch_equalizer_dd import CORPORA as DD_CORPORA
from test_torch_probe_offset_design import (
    PROBE_EDGES,
    SHIFT_HEADS,
    assert_probe_equal,
    error_bound,
    offset_random_input,
    probe_edge_input,
    reference64,
)
from test_torch_tiles_streams_design import (
    STREAM_LS,
    STREAM_THR,
    STREAM_TS,
    TILE_EDGE_VARIANTS,
    TILE_RINGS,
    assert_rows_agree,
    stream_edge_input,
    tile_edge_input,
)


CSRC = Path(_build.__file__).parent / "csrc"


class CardWork(TorchDispatchMode):
    """Every operator call of this thread that touches a tensor on the card:
    the copies from the host to the card (`h2d`) and the calls that run
    work there (`work`: any call but allocating a tensor or viewing one).
    A dispatch mode sees each operator call, so none is lost, where a
    profiler's trace can drop events.  The kernels themselves launch
    through ctypes, past the dispatcher: each wrapper's `launches` counts
    them, and `csrc_copies` reads what their sources could copy."""

    ALLOC = frozenset({"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
                       "aten.new_empty_strided"})

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.h2d, self.work = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        if any(t.device.type == self.device_type for t in tensors):
            if name in ("aten._to_copy", "aten.copy_"):
                src, dst = (args[1], args[0]) if name == "aten.copy_" else (args[0], out)
                if src.device.type == "cpu" and dst.device.type == self.device_type:
                    self.h2d.append(name)
                    return out
            if name not in self.ALLOC and not func.is_view:
                self.work.append(name)
        return out


def csrc_copies(*sources: str) -> list[str]:
    """The CUDA copy calls (``cudaMemcpy*``, ``cuMemcpy*``) in
    csrc/<source>.cu and the headers it includes from csrc/: a kernel's C
    entry can copy host to device only through one."""
    found = []
    for source in sources:
        text = (CSRC / f"{source}.cu").read_text()
        for header in re.findall(r'#include "([^"]+)"', text):
            text += (CSRC / header).read_text()
        found += [f"{source}: {m}" for m in re.findall(r"\bcu(?:da)?Memcpy\w*", text)]
    return found


def launches_of(*wrappers) -> list[int]:
    """Each wrapper's launches so far, its shared-capture form's included."""
    return [w.launches + getattr(w, "shared_launches", 0) for w in wrappers]
from test_torch_walk_attempt_design import (
    ATTEMPT_FORMS,
    WALK_CS,
    attempt_call,
    attempt_edge_inputs,
    walk_edge_tables,
)

CFG = PhyConfig()
PRE = preamble_waveform(CFG)
SYNC = PRE[48:]
CFG4 = PhyConfig(line_coding="4b5b")
PRE4 = preamble_waveform(CFG4)
SYNC4 = PRE4[30:]
THR = CFG.correlation_threshold
BIGI = 2**30
ACFG = ask.AskConfig()
ASK_KERNELS = (sliding_dot_scaled, ask_spec.dense_fire_candidates, ask.ask_chain,
               ask_spec.ask_walk)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _captures(b: int = 4, n_frames: int = 12, seed: int = 3, cfg=CFG) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 20 + 9 * i,
                                                   dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    wave = PhyEncoder(cfg, device="cpu").encode_frames(frames, gap_samples=200).numpy()
    return (wave[None] + rng.normal(0, 0.05, (b, len(wave)))).astype(np.float32)


def _tables(rng, b=8, c=128, mf=72):
    pos = np.full((b, c), BIGI, np.int64)
    for i in range(b):
        k = int(rng.integers(0, c + 1))
        pos[i, :k] = np.sort(rng.integers(0, 40_000, k))
    fields = np.stack([pos, rng.integers(1, 3000, (b, c)), rng.random((b, c)) < 0.25,
                       rng.random((b, c)) < 0.6], axis=1).astype(np.int32)
    return (torch.from_numpy(fields), torch.from_numpy(rng.integers(0, 30_000, b).astype(np.int32)),
            torch.from_numpy(rng.choice([20_000, 41_000, BIGI], b).astype(np.int32)), mf)


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch.  Torch runs on one thread here: on several, the CPU
    conv1d behind the plain correlation may sum in another order in a
    process's first call than in its second, and the two calls below
    compare bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cpu_tensors_run_the_plain_versions()
    finally:
        torch.set_num_threads(threads)


def _cpu_tensors_run_the_plain_versions():
    x = torch.from_numpy(_captures(b=2, n_frames=3))
    counts = [f.launches for f in (xcorr_hits, sd.attempt_manchester, sd.spec_walk)]
    corr, rows = xcorr_hits(x, PRE, THR, emit_corr=True)
    corr_p, rows_p = xcorr_hits_plain(x, PRE, THR, emit_corr=True)
    assert torch.equal(corr, corr_p) and torch.equal(rows, rows_p)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, 128)
    vlen = torch.full((2,), x.shape[1], dtype=torch.int32)
    args = (x, cand, n_valid, vlen, SYNC, preamble_energy(SYNC))
    assert all(torch.equal(p, q) for p, q in zip(sd.attempt_manchester(*args),
                                                 sd.attempt_manchester_plain(*args)))
    table = _tables(np.random.default_rng(0))
    assert all(torch.equal(p, q) for p, q in zip(sd.spec_walk(*table), sd.spec_walk_plain(*table)))
    assert [f.launches for f in (xcorr_hits, sd.attempt_manchester, sd.spec_walk)] == counts


def test_cpu_tensors_run_the_plain_4b5b_attempt():
    x = torch.from_numpy(_captures(b=2, n_frames=3, cfg=CFG4))
    before = sd.attempt_4b5b.launches
    _, rows = xcorr_hits(x, PRE4, THR)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, 128)
    vlen = torch.full((2,), x.shape[1], dtype=torch.int32)
    args = (x, cand, n_valid, vlen, SYNC4, preamble_energy(SYNC4))
    got = sd.attempt_4b5b(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, sd.attempt_4b5b_plain(*args)))
    assert sd.attempt_4b5b.launches == before
    # every frame decodes whole: the first invalid symbol lies past its
    # 2 * (7 + payload) symbols
    assert n_valid.tolist() == [3, 3]
    assert bool((got[2][:, :3] >= torch.tensor([54, 72, 90], dtype=torch.int32)).all())


def test_dispatch_rule_refuses_mixed_and_other_devices():
    x = torch.zeros((1, 500))
    assert _build.on_cuda(x) is False
    with pytest.raises(ValueError):
        _build.on_cuda(x, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        _build.on_cuda(torch.zeros(1, device="meta"))


def test_build_names_track_the_sources():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert path == _build.library_path(name)


@pytest.mark.gpu
def test_kernels_build(cuda):
    for path in _build.build_all():
        assert path.exists()


@pytest.mark.gpu
def test_xcorr_hits_kernel_matches_plain(cuda):
    x = torch.from_numpy(_captures()).to(cuda)
    x[1, -3000:] = 0.0
    corr, rows = xcorr_hits(x, PRE, THR, emit_corr=True)
    torch.cuda.synchronize()
    corr_p, rows_p = xcorr_hits_plain(x, PRE, THR, emit_corr=True)
    assert (corr - corr_p).abs().max().item() <= 1e-5
    near = torch.nn.functional.pad((corr_p - THR).abs() < 1e-5,
                                   (0, rows.shape[1] * 128 - corr.shape[1]))
    near = near.reshape(rows.shape[0], rows.shape[1], 128).any(-1)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1) & (rows[..., 9:] == rows_p[..., 9:]).all(-1)
    assert bool((same | near).all())
    vals = rows[..., 5:9].contiguous().view(torch.float32)
    vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    assert (vals - vals_p)[same].abs().max().item() <= 1e-5
    _, rows_only = xcorr_hits(x, PRE, THR)
    assert torch.equal(rows_only, rows)


@pytest.mark.gpu
def test_attempt_kernel_matches_plain(cuda):
    x = torch.from_numpy(_captures()).to(cuda)
    _, rows = xcorr_hits(x, PRE, THR)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, 128)
    vlen = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=cuda)
    vlen[2] -= 3000                       # cut one capture's valid length
    args = (x, cand, n_valid, vlen, SYNC, preamble_energy(SYNC))
    byts, fs = sd.attempt_manchester(*args)
    torch.cuda.synchronize()
    byts_p, fs_p = sd.attempt_manchester_plain(*args)
    assert torch.equal(byts, byts_p) and torch.equal(fs, fs_p)
    assert int(n_valid.min()) >= 12


@pytest.mark.gpu
def test_attempt_4b5b_kernel_matches_plain(cuda):
    x = torch.from_numpy(_captures(cfg=CFG4)).to(cuda)
    x[3, 1220:1223] = 0.0                 # a zero level inside frame 1
    x[1, -2000:] = 0.0
    _, rows = xcorr_hits(x, PRE4, THR)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, 128)
    vlen = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=cuda)
    vlen[2] -= 2500                       # cut one capture's valid length
    args = (x, cand, n_valid, vlen, SYNC4, preamble_energy(SYNC4))
    before = sd.attempt_4b5b.launches
    got = sd.attempt_4b5b(*args)
    torch.cuda.synchronize()
    assert sd.attempt_4b5b.launches == before + 1
    want = sd.attempt_4b5b_plain(*args)
    for name, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, want):
        assert torch.equal(g, w), name
    assert int(n_valid.min()) >= 12 and bool((got[3] < sd.ZERO_SYMBOLS).any())


@pytest.mark.gpu
def test_4b5b_decode_on_the_card_equals_the_cpu(cuda):
    x = torch.from_numpy(_captures(cfg=CFG4))
    x[3, 1220:1223] = 0.0                 # a zero level: row 3 goes to the exact scan
    kernels = (xcorr_hits, sd.attempt_4b5b, sd.spec_walk)
    before = [f.launches for f in kernels]
    res, ok = sd.decode_capture_spec(CFG4, x.to(cuda), 2, max_frames=16)
    assert [f.launches for f in kernels] == [b + 1 for b in before]
    res_p, ok_p = sd.decode_capture_spec(CFG4, x, 2, max_frames=16)
    assert ok.cpu().tolist() == ok_p.tolist() == [True, True, True, False]
    for name, g, w in zip(res._fields, res, res_p):
        if name == "corr":
            assert (g.cpu() - w).abs().max().item() <= 1e-5
        else:
            assert torch.equal(g.cpu(), w), name
    fast = decode_capture_fast(CFG4, x.to(cuda), 2, max_frames=16)
    exact = decode_capture(CFG4, x[3].to(cuda), 2, max_frames=16)
    assert all(torch.equal(f[3], e) for f, e in zip(fast, exact))
    assert fast.count.tolist()[:3] == [12] * 3


@pytest.mark.gpu
def test_threshold_tie_on_the_card(cuda):
    """The 4B5B preamble's first n samples before a frame: lag 0 correlates
    to 54/60 = 0.9 in exact arithmetic.  The hit kernel divides as its plain
    version does, so its corr at lag 0 equals the plain version's bit for
    bit, just below the threshold, and the decodes find the frame at n."""
    frame = Frame.new_data(5, 1, 2, b"hello")
    wave = PhyEncoder(CFG4, device="cpu").encode_frames([frame], gap_samples=0)
    for n in (39, 48, 57):
        x = torch.cat([torch.from_numpy(PRE4[:n]), wave])[None].to(cuda)
        corr, _ = xcorr_hits(x, PRE4, THR, emit_corr=True)
        corr_p, _ = xcorr_hits_plain(x.cpu(), PRE4, THR, emit_corr=True)
        assert corr[0, 0].item() == corr_p[0, 0].item() < THR
        assert abs(corr[0, 0].item() - THR) < 1e-6
        for res in (decode_capture_fast(CFG4, x, 2, max_frames=4),
                    decode_capture(CFG4, x[0], 2, max_frames=4)):
            valid = res.valid.reshape(-1)
            assert int(valid.sum()) == 1 and int(res.start.reshape(-1)[valid].item()) == n
            assert res.to_frames(0 if res.valid.ndim == 2 else None)[0].data == b"hello"


@pytest.mark.gpu
def test_walk_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    for mf in (1, 2, 5, 72, 128, 256):
        fields, cur0, limit, _ = _tables(rng)
        args = (fields.to(cuda), cur0.to(cuda), limit.to(cuda), mf)
        got = sd.spec_walk(*args)
        torch.cuda.synchronize()
        want = sd.spec_walk_plain(*args)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), (mf, name)


@pytest.mark.gpu
def test_positions_past_2_24_stay_exact(cuda):
    """Frames past sample 2^24, where float32 no longer holds every
    integer: starts and frame bytes come out exact, in the batch decode and
    in both routes of the blocked decode, whose one seam (2 blocks of
    2^24 + 2^19 samples) lies past 2^24 with a frame across it."""
    enc = PhyEncoder(CFG, device="cpu")
    starts = [2**24 + 1001, 2**24 + 9003]
    x = torch.zeros((1, 2**24 + 20_000))
    frames = [Frame.new_data(i, 1, 2, bytes([7 + i]) * 33) for i in range(2)]
    for s, f in zip(starts, frames):
        wave = enc.encode_frame(f)
        x[0, s:s + wave.shape[0]] = wave
    x = x.to(cuda)
    res, ok = sd.decode_capture_spec(CFG, x, 2, max_frames=4)
    assert bool(ok.all())
    assert res.start[0, :2].tolist() == starts
    assert [f.data for f in res.to_frames(row=0)] == [f.data for f in frames]
    t = x.shape[1]
    got = _attempt_forms_equal_plain(x, [[*starts, t - 5_000, t - 1, t, BIGI]], [5])
    assert got[:2] == [s + 96 for s in starts]          # each frame's exact start

    seam = 2**24 + 2**19
    starts = [2**24 + 1001, seam - 1000, seam + 5003]
    frames = [Frame.new_data(i, 1, 2, bytes([9 + i]) * 33) for i in range(3)]
    long = torch.zeros(2 * seam)
    for s, f in zip(starts, frames):
        wave = enc.encode_frame(f)
        long[s:s + wave.shape[0]] = wave
    assert starts[1] + wave.shape[0] > seam
    long = long.to(cuda)
    _attempt_forms_equal_plain(long.expand(2, -1), [[starts[0], starts[1], seam - 7, seam - 1],
                                                    [starts[2], 2 * seam - 9_000, 2 * seam - 2,
                                                     BIGI]], [4, 3])
    before = sd.attempt_manchester.shared_launches
    for res in (decode_blocked_single_chip(CFG, long, 2, n_blocks=2, max_frames_per_block=4),
                decode_blocked_exact(CFG, long, 2, 2, 4)):
        assert res.start[res.valid].tolist() == starts
        assert [f.data for f in res.to_frames()] == [f.data for f in frames]
    assert sd.attempt_manchester.shared_launches == before + 1


def _attempt_forms_equal_plain(x, cand, n_valid) -> list[int]:
    """Both Manchester attempt forms on x (on the card, rows or one capture
    expanded) at the candidates `cand` and the expected frame starts, each
    equal to its plain version; the legacy frame starts of row 0."""
    dev = x.device
    b, t = x.shape
    cand = torch.tensor(cand, dtype=torch.int32, device=dev)
    n_valid = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    vlen = torch.full((b,), t, dtype=torch.int32, device=dev)
    fs = torch.minimum(cand, torch.tensor(t, dtype=torch.int32, device=dev)) + 96
    forms = ((sd.attempt_manchester, sd.attempt_manchester_plain,
              (cand, n_valid, vlen, SYNC, preamble_energy(SYNC))),
             (sd.attempt_manchester_fold, sd.attempt_manchester_fold_plain, (fs, n_valid)))
    for wrapper, plain, args in forms:
        got = wrapper(x, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, plain(x, *args)):
            assert torch.equal(g, w), wrapper.__name__
        if wrapper is sd.attempt_manchester:
            starts = got[1][0].tolist()
    return starts


@pytest.mark.gpu
def test_decode_on_the_card_equals_the_cpu(cuda):
    x = torch.from_numpy(_captures())
    before = [f.launches for f in (xcorr_hits, sd.attempt_manchester, sd.spec_walk)]
    res, ok = sd.decode_capture_spec(CFG, x.to(cuda), 2, max_frames=16)
    after = [f.launches for f in (xcorr_hits, sd.attempt_manchester, sd.spec_walk)]
    assert all(a == b + 1 for a, b in zip(after, before))
    res_p, ok_p = sd.decode_capture_spec(CFG, x, 2, max_frames=16)
    assert torch.equal(ok.cpu(), ok_p) and bool(ok_p.all())
    for name, g, w in zip(res._fields, res, res_p):
        if name == "corr":
            assert (g.cpu() - w).abs().max().item() <= 1e-5
        else:
            assert torch.equal(g.cpu(), w), name
    assert res.count.tolist() == [12] * 4


def _ask_tracks(b: int = 3, n_frames: int = 6) -> np.ndarray:
    frames = ask.build_frames(b"the quick brown fox", ACFG, num_frames=n_frames)
    waves = [ask.build_track(ACFG, frames, seed=7 + r) for r in range(b)]
    caps = np.zeros((b, max(len(w) for w in waves)), np.float32)
    for r, w in enumerate(waves):
        caps[r, :len(w)] = w
    return caps


def _chain_rows(rng, n: int, win: int):
    vals = np.full((n, win), -np.inf, np.float32)
    mask = rng.random((n, win)) < 0.05
    vals[mask] = rng.normal(1, 0.5, mask.sum()).astype(np.float32)
    vals[3, 40] = vals[3, 60] = np.float32(2.5)            # a tie
    vals[4] = -np.inf                                       # no update at all
    vals[5, :] = np.float32(0.5)                            # one update, then ties only
    base = rng.integers(0, 1 << 20, n).astype(np.int32)
    return torch.from_numpy(vals), torch.from_numpy(base)


def _walk_table(rng, b: int = 8, c1: int = 97) -> torch.Tensor:
    fields = np.stack([rng.random((b, c1)) < 0.95, rng.random((b, c1)) < 0.95,
                       rng.random((b, c1)) < 0.95, rng.integers(-5, 400_000, (b, c1)),
                       rng.integers(-1, c1, (b, c1)), rng.random((b, c1)) < 0.03], axis=1)
    return torch.from_numpy(fields.astype(np.int32))


def test_cpu_tensors_run_the_plain_ask_kernels():
    """On CPU tensors the ASK kernel wrappers return their plain versions'
    results and count no launch."""
    rng = np.random.default_rng(1)
    before = [f.launches for f in ASK_KERNELS]
    x = torch.from_numpy(rng.normal(0, 1, (2, 3000)).astype(np.float32))
    pre = ask._chirp_np(ACFG)
    assert torch.equal(sliding_dot_scaled(x, pre, 0.005), sliding_dot_scaled_plain(x, pre, 0.005))
    upd = x > 0.5
    assert torch.equal(ask_spec.dense_fire_candidates(ACFG, x, upd),
                       ask_spec.dense_fire_candidates_plain(ACFG, x, upd))
    vals, base = _chain_rows(rng, 8, 1024)
    assert all(torch.equal(p, q) for p, q in zip(ask.ask_chain(vals, base, 200),
                                                 ask.ask_chain_plain(vals, base, 200)))
    table = _walk_table(rng)
    assert all(torch.equal(p, q) for p, q in zip(ask_spec.ask_walk(table, 20),
                                                 ask_spec.ask_walk_plain(table, 20)))
    assert [f.launches for f in ASK_KERNELS] == before


@pytest.mark.gpu
def test_sliding_dot_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (3, 5001)).astype(np.float32)).to(cuda)
    x[1, 2000:] = 0.0
    for pattern, scale in ((ask._chirp_np(ACFG), 1 / 200), (ask._demod_dense_tables_np(ACFG)[0], 1.0),
                           (np.ones(1, np.float32), 2.0),
                           (rng.normal(0, 1, 512).astype(np.float32), 0.3)):
        got = sliding_dot_scaled(x, pattern, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, sliding_dot_scaled_plain(x, pattern, scale)), len(pattern)


@pytest.mark.gpu
def test_ask_fire_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    for t in (1, 202, 1024, 1025, 9000):
        sync = torch.from_numpy(rng.normal(0, 1, (2, t)).astype(np.float32)).to(cuda)
        upd = torch.from_numpy(rng.random((2, t)) < 0.3).to(cuda)
        upd[1] = True
        got = ask_spec.dense_fire_candidates(ACFG, sync, upd)
        torch.cuda.synchronize()
        assert torch.equal(got, ask_spec.dense_fire_candidates_plain(ACFG, sync, upd)), t


@pytest.mark.gpu
def test_ask_chain_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    for win in (1000, 1024, 4096):
        vals, base = _chain_rows(rng, 70, win)
        vals, base = vals.to(cuda), base.to(cuda)
        fired, peak = ask.ask_chain(vals, base, 200)
        torch.cuda.synchronize()
        fired_p, peak_p = ask.ask_chain_plain(vals, base, 200)
        assert torch.equal(fired, fired_p) and torch.equal(peak, peak_p), win
        assert not fired[4] and int(peak[4]) == -BIGI
        assert fired[5] and int(peak[5]) == int(base[5])    # the first of equal values holds


@pytest.mark.gpu
def test_ask_walk_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    for mf in (1, 72, 128):
        table = _walk_table(rng).to(cuda)
        got = ask_spec.ask_walk(table, mf)
        torch.cuda.synchronize()
        for g, w in zip(got, ask_spec.ask_walk_plain(table, mf)):
            assert torch.equal(g, w), mf


@pytest.mark.gpu
def test_ask_receiver_on_the_card_equals_the_cpu(cuda):
    """The speculative ASK receiver launches each of its kernels and equals
    its run on the CPU; a 2-candidate table sends every row through
    demodulate_fast's exact scan on the card."""
    x = torch.from_numpy(_ask_tracks())
    before = [f.launches for f in ASK_KERNELS]
    res, ok = ask_spec.demodulate_spec(ACFG, x.to(cuda), max_frames=8)
    assert [f.launches - b for f, b in zip(ASK_KERNELS, before)] == [2, 1, 1, 1]
    res_p, ok_p = ask_spec.demodulate_spec(ACFG, x, max_frames=8)
    assert ok.cpu().tolist() == ok_p.tolist() == [True] * 3
    assert all(torch.equal(g.cpu(), w) for g, w in zip(res, res_p))
    assert res.count.tolist() == [6] * 3
    exact = ask.demodulate(ACFG, x[2].to(cuda), max_frames=8)
    assert all(torch.equal(g[2], e) for g, e in zip(res, exact))
    small, small_ok = ask_spec.demodulate_spec(ACFG, x.to(cuda), max_frames=8, n_cand=2)
    assert not bool(small_ok.any())


def _rows_of(corr: torch.Tensor, n_rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(corr, (0, n_rows * 128 - corr.shape[1]),
                                   value=-3.4e38).reshape(corr.shape[0], n_rows, 128)


def test_cpu_tensors_run_the_plain_normalized_correlation():
    """On CPU tensors both entry points of the normalized-correlation kernel
    return their plain versions' results and count no launch."""
    x = torch.from_numpy(_captures(b=2, n_frames=3))
    before = (normalized_xcorr_dense.launches, xcorr_rowstats.launches)
    chirp = chirp_np(440)
    assert torch.equal(normalized_xcorr_dense(x, chirp), normalized_xcorr_dense_plain(x, chirp))
    for pe in (pattern_norm(chirp), 2.0 * preamble_energy(chirp)):    # the norm argument
        got = normalized_xcorr_dense(x, chirp, pe)
        assert torch.equal(got, normalized_xcorr_dense_plain(x, chirp, pe))
    assert torch.equal(got, normalized_xcorr_dense_plain(
        x, chirp, 2.0 * preamble_energy(chirp)))
    half = normalized_xcorr_dense(x, chirp) / 2
    assert (got - half).abs().max().item() <= 1e-6
    got, want = xcorr_rowstats(x, PRE), xcorr_rowstats_plain(x, PRE)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (normalized_xcorr_dense.launches, xcorr_rowstats.launches) == before


@pytest.mark.gpu
def test_normalized_xcorr_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_captures()).to(cuda)
    x[1, -3000:] = 0.0
    for pattern in (chirp_np(440), rng.normal(0, 1, 129).astype(np.float32),
                    rng.normal(0, 1, 1024).astype(np.float32), np.ones(1, np.float32), PRE4):
        before = normalized_xcorr_dense.launches
        got = normalized_xcorr_dense(x, pattern)
        torch.cuda.synchronize()
        assert normalized_xcorr_dense.launches == before + 1
        want = normalized_xcorr_dense_plain(x, pattern)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-5, len(pattern)
    for pattern in (PRE, PRE4):       # at L <= 128 the hit kernel's corr, bit for bit
        corr, _ = xcorr_hits(x, pattern, THR, emit_corr=True)
        assert torch.equal(normalized_xcorr_dense(x, pattern), corr)
    chirp = chirp_np(440)
    for pe in (pattern_norm(chirp), 0.5 * preamble_energy(chirp)):     # the norm argument
        got = normalized_xcorr_dense(x, chirp, pe)
        want = normalized_xcorr_dense_plain(x, chirp, pe)
        assert (got - want).abs().max().item() <= 1e-5, pe
    assert (got - 2 * normalized_xcorr_dense(x, chirp)).abs().max().item() <= 2e-5


@pytest.mark.gpu
def test_rowstats_kernel_matches_plain_and_the_hit_kernel(cuda):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_captures()).to(cuda)
    x[1, -3000:] = 0.0
    for pattern in (PRE, PRE4, chirp_np(440)):
        rowmax, rowpos = xcorr_rowstats(x, pattern)
        torch.cuda.synchronize()
        rowmax_p, rowpos_p = xcorr_rowstats_plain(x, pattern)
        assert rowmax.shape == rowmax_p.shape and rowpos.dtype == torch.int32
        assert (rowmax - rowmax_p).abs().max().item() <= 1e-5
        top2 = _rows_of(normalized_xcorr_dense_plain(x, pattern), rowmax.shape[1]).topk(2, -1)
        clear = top2.values[..., 0] - top2.values[..., 1] > 1e-5
        assert torch.equal(rowpos[clear], rowpos_p[clear]) and bool(clear.any())
        if len(pattern) <= 128:       # exactly the hit kernel's corr reduced by row
            corr, _ = xcorr_hits(x, pattern, THR, emit_corr=True)
            mx, lane = _rows_of(corr, rowmax.shape[1]).max(-1)
            base = torch.arange(rowmax.shape[1], device=cuda) * 128
            assert torch.equal(rowmax, mx) and torch.equal(rowpos, (base + lane).int())
    # exact ties take the first lag; a capture shorter than one row
    t = np.zeros((2, 1024), np.float32)
    t[0, 100:108] = t[0, 110:118] = 1.0
    t[1, 607:615] = t[1, 600:608] = 1.0
    rowmax, rowpos = xcorr_rowstats(torch.from_numpy(t).to(cuda), np.ones(8, np.float32))
    assert rowpos[0, 0] == 100 and rowpos[1, 4] == 600
    short = torch.from_numpy(rng.normal(0, 1, (3, 150)).astype(np.float32)).to(cuda)
    got = xcorr_rowstats(short, PRE4)
    want = xcorr_rowstats_plain(short, PRE4)
    assert got[0].shape == (3, 1) and (got[0] - want[0]).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_equalized_decode_on_the_card_equals_the_cpu(cuda):
    """Echoed captures (taps 1 and 0.45 at delay 7) equalized and decoded on
    the card: one launch of each kernel on the path, the equalizer's
    decisions and the frames equal to the CPU's."""
    x = torch.from_numpy(_captures(b=3, n_frames=6))
    x = channel.multipath(x, (1.0, 0, 0, 0, 0, 0, 0, 0.45))
    kernels = (xcorr_rowstats, xcorr_hits, sd.attempt_manchester, sd.spec_walk)
    before = [f.launches for f in kernels]
    eq, info = equalizer.equalize_capture(CFG, x.to(cuda))
    res, ok = sd.decode_capture_spec(CFG, eq, 2, max_frames=10)
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 1, 1, 1]
    eq_p, info_p = equalizer.equalize_capture(CFG, x)
    assert torch.equal(info["anchor"].cpu(), info_p["anchor"])
    assert bool(info["applied"].all()) and bool(info_p["applied"].all())
    assert (eq.cpu() - eq_p).abs().max().item() <= 1e-4 * x.abs().max().item()
    res_p, ok_p = sd.decode_capture_spec(CFG, eq_p, 2, max_frames=10)
    assert bool(ok.all()) and bool(ok_p.all())
    for name, g, w in zip(res._fields, res, res_p):
        if name != "corr":
            assert torch.equal(g.cpu(), w), name
    assert res.count.tolist() == [6] * 3
    numpy_in = equalizer.decode_capture_eq(CFG, x.numpy(), 2, max_frames=10)
    assert numpy_in.valid.device.type == "cuda"
    assert numpy_in.count.tolist() == [6] * 3


# --- the clock-offset search, the timing gate, the decision-directed decode -----

LINE_KERNELS = (xcorr_hits, sd.attempt_manchester, sd.attempt_4b5b, sd.spec_walk,
                xcorr_rowstats)


def _launched(before: list[int]) -> dict[str, int]:
    return {f.__name__: f.launches - b for f, b in zip(LINE_KERNELS, before)}


def _same_frames(got, want) -> None:
    for name, g, w in zip(got._fields, got, want):
        if name != "corr":
            assert torch.equal(g.cpu(), w), name


@pytest.mark.gpu
def test_extract_candidates_on_the_card_equals_the_cpu(cuda):
    hits = torch.from_numpy(hit_vectors())
    for n_cand in (1, 16, 40, 200):
        got = sd.extract_candidates(hits.to(cuda), n_cand)
        want = sd.extract_candidates(hits, n_cand)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_clock_offset_on_the_card_equals_the_cpu_bit_for_bit(cuda):
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 433_464)).astype(np.float32))
    for ppm in (-400.0, 1000.0, 20_000.0):
        assert torch.equal(channel.clock_offset(x.to(cuda), ppm).cpu(),
                           channel.clock_offset(x, ppm))
    ppms = torch.tensor([[-2000.0], [500.0]])
    assert torch.equal(channel.clock_offset(x.to(cuda), ppms.to(cuda)).cpu(),
                       channel.clock_offset(x, ppms))


@pytest.mark.gpu
@pytest.mark.parametrize("ppm,n_frames,seed", [(1000.0, 8, 0), (0.0, 4, 2)])
def test_clock_search_on_the_card_equals_the_cpu(cuda, ppm, n_frames, seed):
    """The resampled batch decodes through #1, #3 and #4 on the card, and
    the chosen ppm and every frame equal the CPU's."""
    _, x = skewed_capture(ppm, n_frames=n_frames, seed=seed)
    before = [f.launches for f in LINE_KERNELS]
    got, got_ppm = timing.decode_with_clock_search(CFG, torch.from_numpy(x).to(cuda), 2,
                                                   max_frames=12)
    launched = _launched(before)
    want, want_ppm = timing.decode_with_clock_search(CFG, torch.from_numpy(x), 2, max_frames=12)
    assert got.valid.device.type == "cuda" and got_ppm == want_ppm
    _same_frames(got, want)
    assert int(got.count) == n_frames
    assert launched["xcorr_hits"] == launched["attempt_manchester"] == launched["spec_walk"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", GATE_CORPORA)
def test_timing_gate_on_the_card_equals_the_cpu(cuda, name):
    cfg, x, _, _ = gate_corpus(name)
    attempt = sd.attempt_manchester if cfg.line_coding == "manchester" else sd.attempt_4b5b
    before = [f.launches for f in LINE_KERNELS]
    exact, rec = timing.decode_with_timing_gate(cfg, torch.from_numpy(x).to(cuda), 2)
    launched = _launched(before)
    want_exact, want_rec = timing.decode_with_timing_gate(cfg, torch.from_numpy(x), 2)
    _same_frames(exact, want_exact)
    _same_frames(rec, want_rec)
    # the exact decode and the retry batch each launch #1, the attempt and #4
    assert launched["xcorr_hits"] == 3     # and auto_xcorr's dense corr
    assert launched[attempt.__name__] == launched["spec_walk"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DD_CORPORA))
def test_decode_capture_dd_on_the_card_equals_the_cpu(cuda, name):
    x, want = DD_CORPORA[name]()
    mf = len(want) + 4
    before = [f.launches for f in LINE_KERNELS]
    got = equalizer.decode_capture_dd(CFG, torch.from_numpy(x).to(cuda), 2, max_frames=mf)
    launched = _launched(before)
    cpu = equalizer.decode_capture_dd(CFG, torch.from_numpy(x), 2, max_frames=mf)
    assert got.valid.device.type == "cuda"
    _same_frames(got, cpu)
    assert launched["xcorr_rowstats"] == 1 and launched["attempt_manchester"] >= 1
    assert launched["xcorr_hits"] >= 2 and launched["spec_walk"] >= 1
    numpy_in = equalizer.decode_capture_dd(CFG, x, 2, max_frames=mf)
    assert numpy_in.valid.device.type == "cuda"
    _same_frames(numpy_in, cpu)


# --- the sync-refine fold and the batch-folded hit rows ----------------------

FOLD_CODES = [(CFG, PRE, SYNC), (CFG4, PRE4, SYNC4)]
FOLD_IDS = ["manchester", "4b5b"]


def _refine_kw(cfg) -> dict:
    return dict(sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
                n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)


def _attempts(cfg):
    if cfg.line_coding == "manchester":
        return sd.attempt_manchester, sd.attempt_manchester_fold, sd.attempt_manchester_fold_plain
    return sd.attempt_4b5b, sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain


def test_cpu_tensors_run_the_plain_fold_kernels():
    """On CPU tensors the refine and batch-folded entries of the hit kernel
    and the fold attempts return their plain versions' results and count no
    launch."""
    for cfg, pre, sync in FOLD_CODES:
        x = torch.from_numpy(_captures(b=2, n_frames=3, cfg=cfg))
        vlen = torch.tensor([x.shape[1], x.shape[1] - 700], dtype=torch.int32)
        attempt, attempt_fold, attempt_fold_plain = _attempts(cfg)
        kernels = (xcorr_hits_refine, xcorr_hits_batched, attempt_fold)
        before = [k.launches for k in kernels]
        rows = xcorr_hits_refine(x, vlen, pre, sync, THR, **_refine_kw(cfg))
        assert torch.equal(rows, xcorr_hits_refine_plain(x, vlen, pre, sync, THR,
                                                         **_refine_kw(cfg)))
        assert torch.equal(xcorr_hits_batched(x, pre, THR, bc=2),
                           xcorr_hits_batched_plain(x, pre, THR, bc=2))
        cand, _, n_valid, _, fs = sd.compact_hit_rows(rows, 128, with_fs=True)
        args = (x, cand, n_valid, vlen, sync, preamble_energy(sync))
        got = attempt_fold(x, fs, n_valid)
        assert all(torch.equal(p, q) for p, q in zip(got, attempt_fold_plain(x, fs, n_valid)))
        assert all(torch.equal(p, q) for p, q in zip(got, attempt(*args)))
        assert [k.launches for k in kernels] == before
        assert n_valid.tolist() == [3, 3]


def _edge_captures(cfg, pre, cuda):
    """Captures with the same bare preamble planted at lag 8192 + 7*128 + 100,
    in the last row of a block of eight, so that its refine reads past the
    block's correlation halo; valid lengths that leave all of its refine
    positions (row 0), none (row 1) and the first four (row 2)."""
    x = torch.from_numpy(_captures(cfg=cfg))
    lag = 8 * 1024 + 7 * 128 + 100
    x[:3, lag - 300:lag + 500] = 0.01 * x[:3, lag - 300:lag + 500]
    x[:3, lag:lag + len(pre)] += torch.from_numpy(pre)
    kw = _refine_kw(cfg)
    first = lag + kw["sync_off"] + kw["sync_len"]
    vlen = torch.tensor([x.shape[1], first - 1, first + 3, x.shape[1] - 3000],
                        dtype=torch.int32)
    return x.to(cuda), vlen.to(cuda), lag


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,pre,sync", FOLD_CODES, ids=FOLD_IDS)
def test_xcorr_hits_refine_kernel_matches_plain(cuda, cfg, pre, sync):
    x, vlen, lag = _edge_captures(cfg, pre, cuda)
    kw = _refine_kw(cfg)
    before = xcorr_hits_refine.launches
    rows = xcorr_hits_refine(x, vlen, pre, sync, THR, **kw)
    torch.cuda.synchronize()
    assert xcorr_hits_refine.launches == before + 1
    rows_p = xcorr_hits_refine_plain(x, vlen, pre, sync, THR, **kw)
    corr_p = normalized_xcorr_dense_plain(x, pre)
    near = torch.nn.functional.pad((corr_p - THR).abs() < 1e-5,
                                   (0, rows.shape[1] * 128 - corr_p.shape[1]))
    near = near.reshape(rows.shape[0], rows.shape[1], 128).any(-1)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1)
    assert bool((same | near).all())
    assert torch.equal(rows[..., 9:][same], rows_p[..., 9:][same])
    vals = rows[..., 5:9].contiguous().view(torch.float32)
    vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    assert (vals - vals_p)[same].abs().max().item() <= 1e-5
    _, rows_1 = xcorr_hits(x, pre, THR)
    assert torch.equal(rows[..., :9], rows_1[..., :9])
    # the planted hit: refined in full, not at all (the fallback) and in part
    r = lag // 128
    assert r % 8 == 7 and bool((rows[:3, r, 0] == lag).all())
    deltas = rows[:3, r, 9].tolist()
    assert deltas[1] == kw["fall_off"]
    assert kw["sync_off"] + kw["sync_len"] <= deltas[2] <= kw["sync_off"] + 3 + kw["sync_len"]
    assert deltas[0] == kw["fall_off"]     # a clean preamble refines to its expected start
    live = rows[..., :4] < BIGI
    assert bool((rows[..., 9:13][~live] == kw["fall_off"]).all())
    assert bool((rows[..., 13:] == 0).all()) and int(live.sum()) >= 40


@pytest.mark.gpu
@pytest.mark.parametrize("bc", [1, 3, 8])
def test_xcorr_hits_batched_kernel_matches_the_hit_kernel(cuda, bc):
    x = torch.from_numpy(_captures(b=5)).to(cuda)
    before = xcorr_hits_batched.launches
    rows = xcorr_hits_batched(x, PRE, THR, bc=bc)
    torch.cuda.synchronize()
    assert xcorr_hits_batched.launches == before + 1
    assert torch.equal(rows, xcorr_hits(x, PRE, THR)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,pre,sync", FOLD_CODES, ids=FOLD_IDS)
def test_fold_attempt_kernels_match_plain_and_legacy(cuda, cfg, pre, sync):
    x, vlen, _ = _edge_captures(cfg, pre, cuda)
    rows = xcorr_hits_refine(x, vlen, pre, sync, THR, **_refine_kw(cfg))
    cand, _, n_valid, _, fs = sd.compact_hit_rows(rows, 128, with_fs=True)
    attempt, attempt_fold, attempt_fold_plain = _attempts(cfg)
    legacy = attempt(x, cand, n_valid, vlen, sync, preamble_energy(sync))
    assert torch.equal(fs, legacy[1])
    before = attempt_fold.launches
    fold = attempt_fold(x, fs, n_valid)
    torch.cuda.synchronize()
    assert attempt_fold.launches == before + 1
    for g, p, w in zip(fold, attempt_fold_plain(x, fs, n_valid), legacy):
        assert torch.equal(g, p) and torch.equal(g, w)
    assert int(n_valid.min()) >= 12


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,pre,sync", FOLD_CODES, ids=FOLD_IDS)
def test_fold_decode_on_the_card_equals_legacy(cuda, monkeypatch, cfg, pre, sync):
    x, vlen, _ = _edge_captures(cfg, pre, cuda)
    legacy = sd.decode_capture_spec(cfg, x, 2, max_frames=16, valid_len=vlen, with_cursor=True)
    monkeypatch.setattr(sd, "SYNC_FOLD", True)
    kernels = (xcorr_hits_refine, xcorr_hits, _attempts(cfg)[1], sd.spec_walk)
    before = [k.launches for k in kernels]
    fold = sd.decode_capture_spec(cfg, x, 2, max_frames=16, valid_len=vlen, with_cursor=True)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 1, 1]
    for g, w in zip([*fold[0], *fold[1:]], [*legacy[0], *legacy[1:]]):
        assert torch.equal(g, w)
    assert int(fold[0].count.sum()) >= 30


SHARED_FORMS = {
    "manchester": (CFG, PRE, SYNC, False, sd.attempt_manchester, sd.attempt_manchester_plain),
    "manchester-fold": (CFG, PRE, SYNC, True, sd.attempt_manchester_fold,
                        sd.attempt_manchester_fold_plain),
    "4b5b": (CFG4, PRE4, SYNC4, False, sd.attempt_4b5b, sd.attempt_4b5b_plain),
    "4b5b-fold": (CFG4, PRE4, SYNC4, True, sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain),
}


def _flat_capture(cfg, pre, sync, fold: bool, device, n_blocks: int = 8):
    """One noisy capture of 12 frames zero-padded to `n_blocks` blocks of
    whole hit rows, most frames across a block's end, and the shared
    attempt's arguments after x as the flat blocked decode makes them:
    (x f32[n_blocks, T], the capture expanded to every block with a row
    stride of 0, arguments, block)."""
    wave = _captures(b=1, cfg=cfg)[0]
    block = spec_block(len(wave), n_blocks)
    x = torch.zeros((1, n_blocks * block))
    x[0, :len(wave)] = torch.from_numpy(wave)
    x = x.to(device)
    vlens = torch.full((n_blocks,), len(wave), dtype=torch.int32, device=device)
    if fold:
        rows = xcorr_hits_refine(x, vlens[:1], pre, sync, THR, **_refine_kw(cfg))
    else:
        rows = xcorr_hits(x, pre, THR)[1]
    rows = rows[0].reshape(n_blocks, block // 128, -1)
    if fold:
        _, _, n_valid, _, fs = sd.compact_hit_rows(rows, 32, with_fs=True)
        return x.expand(n_blocks, -1), (fs, n_valid), block
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, 32)
    return x.expand(n_blocks, -1), (cand, n_valid, vlens, sync, preamble_energy(sync)), block


def test_cpu_tensors_run_the_plain_shared_attempts():
    """On CPU tensors the shared-capture attempts return their plain
    versions' results and count no launch."""
    for cfg, pre, sync, fold, attempt, plain in SHARED_FORMS.values():
        x, args, _ = _flat_capture(cfg, pre, sync, fold, "cpu", n_blocks=4)
        before = (attempt.launches, attempt.shared_launches)
        got = attempt(x, *args)
        assert all(torch.equal(p, q) for p, q in zip(got, plain(x, *args)))
        assert (attempt.launches, attempt.shared_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(SHARED_FORMS))
def test_shared_attempt_kernels_match_plain(cuda, form):
    cfg, pre, sync, fold, attempt, plain = SHARED_FORMS[form]
    x, args, block = _flat_capture(cfg, pre, sync, fold, cuda)
    n_blocks = x.shape[0]
    before = (attempt.launches, attempt.shared_launches)
    got = attempt(x, *args)
    torch.cuda.synchronize()
    assert (attempt.launches, attempt.shared_launches) == (before[0], before[1] + 1)
    want = plain(x, *args)
    per_row = attempt(x.contiguous(), *args)
    for g, w, r in zip(got, want, per_row):
        assert torch.equal(g, w) and torch.equal(g, r)
    fs, live = got[1], sd._live(got[1], args[1])
    body = (sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES if cfg.line_coding == "manchester"
            else sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES)
    block_end = (torch.arange(n_blocks, device=cuda)[:, None] + 1) * block
    assert int((live & (fs + body > block_end)).sum()) >= 4


# --- the tools' kernels: the window probe and the two-stream correlation -------


def _near_rows(corr_p, thr, n_rows):
    """bool[B, n_rows]: rows holding a lag within 1e-5 of thr."""
    near = torch.nn.functional.pad((corr_p - thr).abs() < 1e-5, (0, n_rows * 128 - corr_p.shape[1]))
    return near.reshape(corr_p.shape[0], n_rows, 128).any(-1)


def test_cpu_tensors_run_the_plain_tool_kernels():
    x = torch.from_numpy(_captures(b=2, n_frames=3))
    xk = torch.ones((8, 128))
    before = (health.seq_probe.launches, ex.xcorr_hits_2s.launches)
    assert torch.equal(health.seq_probe(xk), health.seq_probe_plain(xk))
    for epilogue in (True, False):
        assert torch.equal(ex.xcorr_hits_2s(x, PRE, THR, epilogue),
                           ex.xcorr_hits_2s_plain(x, PRE, THR, epilogue))
    assert (health.seq_probe.launches, ex.xcorr_hits_2s.launches) == before


@pytest.mark.gpu
def test_seq_probe_kernel_matches_plain(cuda):
    x = torch.from_numpy(np.random.default_rng(8).normal(0, 100, (8, 128)).astype(np.float32))
    x = x.to(cuda)
    before = health.seq_probe.launches
    got = health.seq_probe(x)
    torch.cuda.synchronize()
    assert health.seq_probe.launches == before + 1
    assert torch.equal(got, health.seq_probe_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("corpus", ["flagship", "tool"])
def test_xcorr_hits_2s_kernel_equals_the_hit_kernel(cuda, corpus):
    """At the flagship shape (32 x 433,464): the two-stream rows equal
    kernel #1's bit for bit, and its plain version's away from the
    threshold."""
    if corpus == "flagship":
        x = prof_fused.build_corpus(CFG, cuda)[1]
        pattern, thr = PRE, THR
    else:
        x, pattern = ex.tool_input(cuda)
        thr = ex.THR
    before = ex.xcorr_hits_2s.launches
    rows = ex.xcorr_hits_2s(x, pattern, thr)
    torch.cuda.synchronize()
    assert ex.xcorr_hits_2s.launches == before + 1
    assert torch.equal(rows, xcorr_hits(x, pattern, thr)[1])
    rows_p = ex.xcorr_hits_2s_plain(x, pattern, thr)
    corr_p = normalized_xcorr_dense_plain(x, pattern)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1)
    assert bool((same | _near_rows(corr_p, thr, rows.shape[1])).all())
    assert torch.equal(ex.xcorr_hits_2s(x, pattern, thr, streams=ex.two_streams(x)), rows)


@pytest.mark.gpu
def test_xcorr_hits_2s_kernel_at_129_taps_matches_plain(cuda):
    """L = 129, past kernel #1's 128 taps: the rows against the plain
    version's (positions and counts equal away from the threshold, corr at
    the hits within 1e-5), the noep form equal away from |corr| = 1."""
    rng = np.random.default_rng(12)
    pattern = np.sign(rng.normal(size=129)).astype(np.float32)
    x = rng.normal(0, 0.3, (4, 30_011)).astype(np.float32)
    for r in range(4):
        for s in (200 + 97 * r, 9_000, 30_011 - 129):
            x[r, s:s + 129] += pattern
    x = torch.from_numpy(x).to(cuda)
    rows = ex.xcorr_hits_2s(x, pattern, THR)
    torch.cuda.synchronize()
    rows_p = ex.xcorr_hits_2s_plain(x, pattern, THR)
    corr_p = normalized_xcorr_dense_plain(x, pattern)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1) & (rows[..., 9:] == rows_p[..., 9:]).all(-1)
    assert bool((same | _near_rows(corr_p, THR, rows.shape[1])).all())
    vals = rows[..., 5:9].contiguous().view(torch.float32)
    vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    assert (vals - vals_p)[same].abs().max().item() <= 1e-5
    assert int(rows[..., 4].sum()) >= 12
    noep = ex.xcorr_hits_2s(x, pattern, THR, epilogue=False)
    noep_p = ex.xcorr_hits_2s_plain(x, pattern, THR, epilogue=False)
    edge = ex.noep_plain(((corr_p.abs() - 1.0).abs() < 1e-5).float(), rows.shape[1]) > 0
    assert bool(((noep == noep_p) | edge).all())


@pytest.mark.gpu
@pytest.mark.parametrize("l", STREAM_LS)
def test_xcorr_hits_2s_kernel_on_the_edges(cuda, l):
    """At every T of the design tests' edges (1,024 lags a block, the
    second stream's 128 and the 8 zero-filled past them), a hit at the
    last lag: the rows and the noep form equal kernel #1's bit for bit (L
    <= 128) and the plain version's away from the threshold and from
    |corr| = 1."""
    for t in STREAM_TS:
        x, pattern = stream_edge_input(l, t, cuda)
        before = ex.xcorr_hits_2s.launches
        rows = ex.xcorr_hits_2s(x, pattern, STREAM_THR)
        noep = ex.xcorr_hits_2s(x, pattern, STREAM_THR, epilogue=False)
        torch.cuda.synchronize()
        assert ex.xcorr_hits_2s.launches == before + 2
        if l <= 128:
            corr, rows_1 = xcorr_hits(x, pattern, STREAM_THR, emit_corr=True)
            assert torch.equal(rows, rows_1), (l, t)
            assert torch.equal(noep, ex.noep_plain(corr, noep.shape[1])), (l, t)
        corr_p = normalized_xcorr_dense_plain(x, pattern)
        assert_rows_agree(rows.cpu(), ex.xcorr_hits_2s_plain(x, pattern, STREAM_THR).cpu(),
                          corr_p.cpu(), STREAM_THR)
        edge = ex.noep_plain(((corr_p.abs() - 1.0).abs() < 1e-5).float(), noep.shape[1]) > 0
        assert bool(((noep == ex.xcorr_hits_2s_plain(x, pattern, STREAM_THR, False)) | edge).all())
        assert int(rows[0, (t - l) // 128, 4]) >= 1, (l, t)


@pytest.mark.gpu
def test_noep_kernel_truncates_the_hit_kernel_s_corr(cuda):
    """The noep form equals the truncation of kernel #1's dense corr bit
    for bit (the same sums), exact +-1 copies of a 64-sample pattern in
    silence giving +-1 in lanes 0..15 of their rows (sqrt(64) is exact in
    f32, so the division gives exactly +-1; at 96 samples it gives
    0.99999994)."""
    pattern = PRE[:64]
    x = torch.from_numpy(_captures(b=3)).to(cuda)
    x[2] = 0.0
    p = torch.from_numpy(pattern).to(cuda)
    for lag, sign in ((128 * 5 + 3, 1.0), (128 * 20 + 15, -1.0), (128 * 33, 1.0)):
        x[2, lag:lag + len(pattern)] = sign * p
    noep = ex.xcorr_hits_2s(x, pattern, THR, epilogue=False)
    torch.cuda.synchronize()
    corr, _ = xcorr_hits(x, pattern, THR, emit_corr=True)
    assert torch.equal(noep, ex.noep_plain(corr, noep.shape[1]))
    assert noep[2, 5, 3] == 1 and noep[2, 20, 15] == -1 and noep[2, 33, 0] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("fold", [False, True])
def test_attempt_sum_launches_one_correlation_and_one_attempt(cuda, fold):
    x = torch.from_numpy(_captures()).to(cuda)
    vlens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=cuda)
    kernels = (xcorr_hits, xcorr_hits_refine, sd.attempt_manchester, sd.attempt_manchester_fold,
               sd.spec_walk)
    before = [k.launches for k in kernels]
    got = prof_fused.attempt_sum(CFG, x, vlens, fold)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == (
        [0, 1, 0, 1, 0] if fold else [1, 0, 1, 0, 0])
    want = prof_fused.attempt_sum(CFG, x.cpu(), vlens.cpu(), fold)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_tools_run_on_the_card(cuda):
    before = health.seq_probe.launches
    got = health.health(cuda)
    assert health.seq_probe.launches - before == 1 + health.LAUNCHES * health.REPEATS
    for key in ("rtt_ms", "noop_kernel_us", "stream_gbps"):
        assert np.isfinite(got[key]) and got[key] > 0, key
    x = torch.from_numpy(_captures()).to(cuda)
    vlens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=cuda)
    for name, fn in prof_fused.stages(CFG, x, vlens).items():
        mn, med = prof_fused.time_stage(fn, x, iters=2, repeats=2)
        assert 0 < mn <= med, name


# --- the experiments: attempt tiles (#13) and offset add (#14) ---------------

TILE_VARIANTS = ("noop", "base", "n128", "sync1", "both", "bf16b", "base_nodma", "base_nostore",
                 "base_u5", "both_nodma_nostore_u2")


@pytest.mark.gpu
@pytest.mark.parametrize("corpus", ["normal", "integer"])
def test_attempt_tiles_kernel_matches_plain(cuda, corpus):
    """Every variant, and rings of 1 to 4 stages, equal the plain version
    bit for bit: both sum in k order, and the tool's tables make every
    product exact."""
    inputs = et.tool_input(cuda, b=4, integer=corpus == "integer")
    for variant in TILE_VARIANTS:
        before = et.attempt_tiles.launches
        got = et.attempt_tiles(variant, *inputs)
        torch.cuda.synchronize()
        assert et.attempt_tiles.launches == before + 1
        assert torch.equal(got, et.attempt_tiles_plain(variant, *inputs)), variant
    want = et.attempt_tiles_plain("base", *inputs)
    for pipe in (1, 2, 3):
        assert torch.equal(et.attempt_tiles("base", *inputs, pipe=pipe), want), pipe


@pytest.mark.gpu
def test_attempt_tiles_refuses_a_ring_that_does_not_fit(cuda):
    inputs = et.tool_input(cuda, b=1)
    before = et.attempt_tiles.launches
    with pytest.raises(ValueError):
        et.attempt_tiles("base", *inputs, pipe=5)
    assert et.attempt_tiles.launches == before
    got = et.attempt_tiles("base_nodma", *inputs, pipe=5)    # no ring: any depth
    assert torch.equal(got, et.attempt_tiles_plain("base", *inputs))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", TILE_EDGE_VARIANTS)
def test_attempt_tiles_kernel_on_the_edges(cuda, variant):
    """On the design tests' edge input (two captures of the normal corpus),
    at every ring: the kernel equals the plain version bit for bit, one
    launch a call, and the arrival counters are left zero."""
    inputs = tile_edge_input(cuda)
    want = et.attempt_tiles_plain(variant, *inputs)
    for pipe in TILE_RINGS:
        before = et.attempt_tiles.launches
        got = et.attempt_tiles(variant, *inputs, pipe=pipe)
        torch.cuda.synchronize()
        assert et.attempt_tiles.launches == before + 1
        assert torch.equal(got, want), (variant, pipe)
        assert not et._arrival_counts(cuda, 2).any()


@pytest.mark.gpu
@pytest.mark.parametrize("head", [None, [20, 20, 20, 10, 0, 0, 0, 0],
                                  [-20, -20, -20, -10, 0, 0, 0, 0],
                                  [2.5, -2.5, 1.5, -1.5, 0.5, -0.5, 30.5, 33.5]])
def test_offset_add_kernel_matches_plain_and_oracles(cuda, head):
    x, t = eo.tool_input(cuda)
    if head is not None:
        x[0, :8] = torch.tensor(head, dtype=torch.float32, device=cuda)
    for form in eo.FORMS:
        before = eo.offset_add.launches
        got = eo.offset_add(form, x, t)
        torch.cuda.synchronize()
        assert eo.offset_add.launches == before + 1
        assert torch.equal(got, eo.offset_add_plain(form, x, t)), form
        assert eo.errors(form, got, x, t) == (0.0, 0.0), form


@pytest.mark.gpu
@pytest.mark.parametrize("kind", PROBE_EDGES)
def test_seq_probe_kernel_on_the_edges(cuda, kind):
    """Where x + c rounds (near 2^24, ties at 3 * 2^23, inf, NaN, -0.0):
    bit for bit as the plain version, NaN as NaN; one launch a call."""
    x = probe_edge_input(kind, cuda)
    before = health.seq_probe.launches
    got = health.seq_probe(x)
    torch.cuda.synchronize()
    assert health.seq_probe.launches == before + 1
    assert_probe_equal(got.cpu().numpy(), health.seq_probe_plain(x).cpu().numpy())


@pytest.mark.gpu
def test_seq_probe_refuses_a_misaligned_x(cuda):
    x = torch.zeros(1025, device=cuda)[1:].view(8, 128)
    before = health.seq_probe.launches
    with pytest.raises(ValueError):
        health.seq_probe(x)
    assert health.seq_probe.launches == before


OFFSET_RANDOM_CASES = [(form, None) for form in eo.FORMS] + [("C", h) for h in SHIFT_HEADS]


@pytest.mark.gpu
@pytest.mark.parametrize("form, head", OFFSET_RANDOM_CASES,
                         ids=[f"{f}-{h}" for f, h in OFFSET_RANDOM_CASES])
def test_offset_add_kernel_on_random_input(cuda, form, head):
    """N(0, 1) f32 inputs: within 2 * 768 * 2^-24 * sum |x_j t_jk| of a
    float64 product and epilogue (the kernel sums its slices, then the
    slices, in f32); C also at the lane shifts 0, 63 and 59."""
    x, t = offset_random_input(7, None if head is None else SHIFT_HEADS[head][0], cuda)
    before = eo.offset_add.launches
    got = eo.offset_add(form, x, t)
    torch.cuda.synchronize()
    assert eo.offset_add.launches == before + 1
    err = np.abs(got.cpu().numpy().astype(np.float64) - reference64(form, x, t))
    assert np.all(err <= error_bound(form, x, t)), (form, head, float(err.max()))


@pytest.mark.gpu
def test_offset_add_refuses_a_misaligned_x(cuda):
    x, t = eo.tool_input(cuda)
    x = torch.zeros(x.numel() + 1, device=cuda)[1:].view(eo.X_SHAPE)
    before = eo.offset_add.launches
    with pytest.raises(ValueError):
        eo.offset_add("A", x, t)
    assert eo.offset_add.launches == before


# --- the register-tiled hit kernel (lags that share samples) -------------------
# Its dense corr equals tm_normalized_xcorr's (xcorr_norm.cu) bit for bit at
# every pattern length: the same fused multiply-add chains in tap order and
# the same division.  Its rows equal the plain hit rows of that corr, and its
# refine deltas the plain refine's, exactly.

RAGGED_T = 9 * 1024 + 333       # not a multiple of a block's 1,024 lags


def _ragged(b: int = 3, cfg=CFG) -> np.ndarray:
    return np.ascontiguousarray(_captures(b=b, cfg=cfg)[:, :RAGGED_T])


@pytest.mark.gpu
@pytest.mark.parametrize("l", range(1, 129))
def test_xcorr_hits_corr_equals_normalized_xcorr_at_every_length(cuda, l):
    x = torch.from_numpy(_ragged()).to(cuda)
    pattern = np.tile(PRE, 2)[:l]
    corr, rows = xcorr_hits(x, pattern, THR, emit_corr=True)
    dense = normalized_xcorr_dense(x, pattern)
    torch.cuda.synchronize()
    assert torch.equal(corr, dense)
    assert torch.equal(rows, hit_rows_plain(corr, rows.shape[1], THR))
    assert torch.equal(xcorr_hits(x, pattern, THR)[1], rows)


DENSE_THR = {"manchester": 0.3, "4b5b": 0.4}   # rows of 0 to 5 and more hits


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,pre,sync", FOLD_CODES, ids=FOLD_IDS)
@pytest.mark.parametrize("dense", ["mixed", "every lag"])
def test_xcorr_hits_refine_on_dense_hits_matches_plain(cuda, cfg, pre, sync, dense):
    x = torch.from_numpy(_captures(b=3, cfg=cfg)).to(cuda)
    vlen = torch.tensor([x.shape[1], x.shape[1] - 500, x.shape[1] - 5000], dtype=torch.int32,
                        device=cuda)
    thr = DENSE_THR[cfg.line_coding] if dense == "mixed" else -2.0
    kw = _refine_kw(cfg)
    rows = xcorr_hits_refine(x, vlen, pre, sync, thr, **kw)
    torch.cuda.synchronize()
    rows_p = xcorr_hits_refine_plain(x, vlen, pre, sync, thr, **kw)
    corr_p = normalized_xcorr_dense_plain(x, pre)
    near = torch.nn.functional.pad((corr_p - thr).abs() < 1e-5,
                                   (0, rows.shape[1] * 128 - corr_p.shape[1]))
    near = near.reshape(rows.shape[0], rows.shape[1], 128).any(-1)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1)
    assert bool((same | near).all())
    assert torch.equal(rows[..., 9:][same], rows_p[..., 9:][same])
    assert torch.equal(rows[..., :9], xcorr_hits(x, pre, thr)[1][..., :9])
    counts = rows[..., 4].clamp(max=4)
    assert all(bool((counts == n).any()) for n in ([1, 2, 3, 4] if dense == "mixed" else [4]))
    live = rows[..., :4] < BIGI
    assert bool((rows[..., 10:13][live[..., 1:]] != kw["fall_off"]).any())
    cand, _, n_valid, _, fs = sd.compact_hit_rows(rows, 128, with_fs=True)
    attempt = _attempts(cfg)[0]
    assert torch.equal(fs, attempt(x, cand, n_valid, vlen, sync, preamble_energy(sync))[1])


@pytest.mark.gpu
@pytest.mark.parametrize("bc", [1, 3, 8])
def test_xcorr_hits_batched_on_ragged_captures(cuda, bc):
    x = torch.from_numpy(_ragged(b=7)).to(cuda)
    rows = xcorr_hits_batched(x, PRE, THR, bc=bc)
    torch.cuda.synchronize()
    corr, rows_1 = xcorr_hits(x, PRE, THR, emit_corr=True)
    assert torch.equal(rows, rows_1)
    assert torch.equal(rows, hit_rows_plain(corr, rows.shape[1], THR))
    # against the plain version: the plain corr and the kernel's fused chain
    # may round a lag within 1e-5 of the threshold to either side of it
    rows_p = xcorr_hits_batched_plain(x, PRE, THR, bc=bc)
    corr_p = normalized_xcorr_dense_plain(x, PRE)
    near = torch.nn.functional.pad((corr_p - THR).abs() < 1e-5,
                                   (0, rows.shape[1] * 128 - corr_p.shape[1]))
    near = near.reshape(rows.shape[0], rows.shape[1], 128).any(-1)
    same = (rows[..., :5] == rows_p[..., :5]).all(-1)
    assert bool((same | near).all())
    vals = rows[..., 5:9].contiguous().view(torch.float32)
    vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    assert (vals - vals_p)[same].abs().max().item() <= 1e-5
    assert torch.equal(rows[..., 9:], rows_p[..., 9:])


@pytest.mark.gpu
def test_card_work_sees_copies_and_work(cuda):
    """The counter the copy tests below rely on: a copy to the card is a
    copy to the card, an op on it and the copy back are work there, an
    allocation and a view are neither."""
    with CardWork() as card:
        x = torch.ones(3).to(cuda)
        y = torch.empty(4, device=cuda)[1:]
        x.add_(1)
        x.cpu()
    torch.cuda.synchronize()
    assert card.h2d == ["aten._to_copy"], card.h2d
    assert card.work == ["aten.add_", "aten._to_copy"], card.work
    assert y.shape == (3,)


@pytest.mark.gpu
def test_hit_kernel_entries_copy_nothing_to_the_card(cuda):
    """The pattern and the sync word go to the kernel by value: a call on
    captures already on the card makes no host-to-device copy."""
    x = torch.from_numpy(_ragged()).to(cuda)
    vlen = torch.full((3,), RAGGED_T, dtype=torch.int32, device=cuda)
    calls = (lambda: xcorr_hits(x, PRE, THR, emit_corr=True),
             lambda: xcorr_hits_batched(x, PRE, THR, bc=2),
             lambda: xcorr_hits_refine(x, vlen, PRE, SYNC, THR, **_refine_kw(CFG)))
    for call in calls:
        call()
    torch.cuda.synchronize()
    wrappers = (xcorr_hits, xcorr_hits_batched, xcorr_hits_refine)
    before = launches_of(*wrappers)
    with CardWork() as card:
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert launches_of(*wrappers) == [n + 1 for n in before]
    assert not card.h2d, card.h2d
    assert not csrc_copies("xcorr_hits")


# The raw sliding dot and the normalized correlation's row stats on the
# register tile (csrc/xcorr_tile.cuh): the raw form equals its plain version
# exactly at every remainder of an 8-tap step and at every edge of a block
# of 1,024 lags; the row stats equal the row reduction of the dense
# kernel's own corr exactly, planted ties included; neither wrapper copies
# its pattern to the card.

RAW_LS = [1, 2, 7, 8, 9, 15, 16, 17, 30, 127, 128, 129, 440, 511, 512]
TILE = 1024                     # lags a block of either kernel covers


@pytest.mark.gpu
@pytest.mark.parametrize("l", RAW_LS)
def test_sliding_dot_kernel_equals_plain_at_every_edge(cuda, l):
    rng = np.random.default_rng(l)
    pattern = np.tile(ask._chirp_np(ACFG), 2)[:l]
    for t in sorted({1, l - 1, l, TILE - 1, TILE, TILE + 1, 5001} - {0}):
        x = torch.from_numpy(rng.normal(0, 1, (3, t)).astype(np.float32)).to(cuda)
        got = sliding_dot_scaled(x, pattern, 1 / 200)
        torch.cuda.synchronize()
        assert torch.equal(got, sliding_dot_scaled_plain(x, pattern, 1 / 200)), (l, t)


def _quarter_pattern(rng, l: int) -> np.ndarray:
    """A pattern of multiples of 1/4 (not all zero), whose norm is the same
    summed in f32 or in f64: the dense kernel and the row stats divide by
    the same ||p||."""
    p = (rng.integers(-4, 5, l) / 4).astype(np.float32)
    p[0] = 1.0
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("l", [60, 96, 129, 440, 1024])
def test_rowstats_equal_the_row_reduction_of_the_dense_kernel(cuda, l):
    from trackmaker_tpu_torch.sync.correlate import pattern_norm

    rng = np.random.default_rng(l)
    pattern = _quarter_pattern(rng, l)
    assert pattern_norm(pattern) == float(np.float32(preamble_energy(pattern)))
    x = rng.normal(0, 1, (3, RAGGED_T)).astype(np.float32)
    for b, at in ((0, 0), (0, 5000), (1, RAGGED_T - l), (2, 127 * 8)):
        x[b, at:at + l] += 3 * pattern      # peaks at the edges and inside
    x[2, -3000:] = 0.0                       # rows of zero energy: all ties at 0
    x = torch.from_numpy(x).to(cuda)
    rowmax, rowpos = xcorr_rowstats(x, pattern)
    corr = normalized_xcorr_dense(x, pattern)
    torch.cuda.synchronize()
    mx, lane = _rows_of(corr, rowmax.shape[1]).max(-1)
    base = torch.arange(rowmax.shape[1], device=cuda) * 128
    assert torch.equal(rowmax, mx) and torch.equal(rowpos, (base + lane).int())
    assert rowpos[0, 0] == 0 and rowpos[1, -1] == RAGGED_T - l


def test_tie_captures_plant_what_they_say():
    x, want = _tie_captures()
    corr = normalized_xcorr_dense_plain(torch.from_numpy(x), np.ones(8, np.float32))
    for (b, row), lag in want.items():
        r = corr[b, row * 128:(row + 1) * 128]
        assert int(r.argmax()) + row * 128 == lag
        # a tie, not a clear winner, but where the tie straddles two rows
        assert int((r == r.max()).sum()) >= 2 or lag in (511, 512)


def _tie_captures():
    """Capture 0: runs of ones that make exact ties (pattern ones(8)) at a
    thread's lags 7 / 8 (159, 160), at the row's two halves (319, 320), at
    the last lag of a row and the first of the next (511, 512; each row its
    own), between a row's first and last lags (640, 767) and between its
    first and last threads (899, 1016); capture 1: zeros, every lag 0."""
    t = 2 * 1024 + 70                # 16 rows and a partial 17th
    x = np.zeros((2, t), np.float32)
    for start, n in ((159, 9), (319, 9), (511, 9), (640, 8), (767, 8), (899, 8), (1016, 8)):
        x[0, start:start + n] = 1.0
    want = {(0, 1): 159, (0, 2): 319, (0, 3): 511, (0, 4): 512, (0, 5): 640, (0, 7): 899}
    want.update({(1, r): 128 * r for r in range(-(-(t - 7) // 128))})
    return x, want


@pytest.mark.gpu
def test_rowstats_break_planted_ties_to_the_first_lag(cuda):
    x, want = _tie_captures()
    ones = np.ones(8, np.float32)
    xc = torch.from_numpy(x).to(cuda)
    rowmax, rowpos = xcorr_rowstats(xc, ones)
    torch.cuda.synchronize()
    for (b, row), lag in want.items():
        assert int(rowpos[b, row]) == lag, (b, row)
    assert bool((rowmax[1] == 0).all())
    rowmax_p, rowpos_p = xcorr_rowstats_plain(torch.from_numpy(x), ones)
    assert torch.equal(rowmax.cpu(), rowmax_p) and torch.equal(rowpos.cpu(), rowpos_p)


@pytest.mark.gpu
def test_sliding_dot_and_normalized_kernels_copy_nothing_to_the_card(cuda):
    """The pattern goes to each kernel by value: a call on captures already
    on the card makes no host-to-device copy."""
    x = torch.from_numpy(_ragged()).to(cuda)
    chirp = chirp_np(440)
    calls = (lambda: sliding_dot_scaled(x, chirp, 1 / 200),
             lambda: normalized_xcorr_dense(x, chirp),
             lambda: xcorr_rowstats(x, PRE))
    for call in calls:
        call()
    torch.cuda.synchronize()
    wrappers = (sliding_dot_scaled, normalized_xcorr_dense, xcorr_rowstats)
    before = launches_of(*wrappers)
    with CardWork() as card:
        for _ in range(3):
            for call in calls:
                call()
    torch.cuda.synchronize()
    assert launches_of(*wrappers) == [n + 3 for n in before]
    assert not card.h2d, card.h2d
    assert not csrc_copies("sliding_dot", "xcorr_norm")


def _ofdm_capture() -> np.ndarray:
    rng = np.random.default_rng(8)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
              for i in range(3)]
    wave = ofdm_v2.OfdmModemV2(device="cpu").encode_frames(frames, gap_samples=300)
    x = np.concatenate([np.zeros(500, np.float32), wave, np.zeros(3000, np.float32)])
    return (x + rng.normal(0, 0.01, len(x))).astype(np.float32)


@pytest.mark.gpu
def test_ofdm_path_copies_nothing_to_the_card(cuda):
    """The OFDM sync's call of the normalized correlation, with the chirp's
    f32 norm, copies nothing to the card; nor do find_preambles and the v2
    demodulation of captures on the card (their tables copied once a
    process, at the first call); a stream PHY call copies its bucket once."""
    x = torch.from_numpy(_ofdm_capture()).to(cuda)
    chirp = chirp_np(440)
    cfg = ofdm_v2.OfdmV2Config()
    calls = (lambda: normalized_xcorr_dense(x[None], chirp, pattern_norm(chirp)),
             lambda: ofdm_v2.demodulate_at_v2(cfg, x, 8 * 47, ofdm.find_preambles(cfg, x, 4),
                                              3))
    for call in calls:
        call()
    torch.cuda.synchronize()
    before = normalized_xcorr_dense.launches
    with CardWork() as card:
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert normalized_xcorr_dense.launches == before + 2
    assert not card.h2d, card.h2d
    phy = ofdm_v2.OfdmStreamPhyV2(local_addr=2, device=cuda)
    with CardWork() as card:
        frames = phy.process_samples(x.cpu().numpy())
    assert len(frames) == 3 and phy.decode_calls == 1
    assert card.h2d == ["aten._to_copy"], card.h2d


# The walk as a successor-table chase by pointer doubling and the Manchester
# attempt staged by the copy engine (csrc/spec_walk.cu,
# csrc/attempt_manchester.cu): each equals its plain version on the edge
# inputs of tests/test_torch_walk_attempt_design.py, the walk at every table
# size it takes, and neither wrapper copies anything to the card.


@pytest.mark.gpu
@pytest.mark.parametrize("c", WALK_CS)
def test_walk_kernel_matches_plain_on_edge_tables(cuda, c):
    for fields, cur0, limit, mf in walk_edge_tables(c):
        args = (fields.to(cuda), cur0.to(cuda), limit.to(cuda), mf)
        before = sd.spec_walk.launches
        got = sd.spec_walk(*args)
        torch.cuda.synchronize()
        assert sd.spec_walk.launches == before + 1
        want = sd.spec_walk_plain(*args)
        for name, g, w in zip(got._fields, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (c, mf, name)


@pytest.mark.gpu
def test_walk_kernel_takes_the_table_sizes_it_took(cuda):
    """Tables of 1..2,730 candidates (their fields once fit 48 KB of shared
    memory); 2,731 is refused."""
    rng = np.random.default_rng(9)
    for c, mf in ((2730, 72), (2730, 2731), (1025, 300), (2049, 5)):
        fields, cur0, limit, _ = _tables(rng, b=3, c=c)
        args = (fields.to(cuda), cur0.to(cuda), limit.to(cuda), mf)
        got = sd.spec_walk(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, got, sd.spec_walk_plain(*args)):
            assert torch.equal(g, w), (c, mf, name)
    fields, cur0, limit, _ = _tables(rng, b=2, c=2731)
    with pytest.raises(RuntimeError):
        sd.spec_walk(fields.to(cuda), cur0.to(cuda), limit.to(cuda), 72)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ATTEMPT_FORMS)
def test_attempt_kernels_match_plain_at_the_edges(cuda, form):
    x, args = attempt_edge_inputs(cuda)[form]
    wrapper, plain = attempt_call(form)
    shared = x.stride(0) == 0
    before = (wrapper.launches, wrapper.shared_launches)
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.shared_launches) == (before[0] + (not shared),
                                                           before[1] + shared)
    for name, g, w in zip(("bytes", "fs"), got, plain(x, *args)):
        assert torch.equal(g, w), (form, name)


@pytest.mark.gpu
def test_walk_and_attempt_kernels_copy_nothing_to_the_card(cuda):
    """The sync word goes to the attempt kernel by value, and the walk
    writes every field it returns in its one launch: no call copies host to
    device, and a walk call launches one kernel and nothing else."""
    inputs = attempt_edge_inputs(cuda)
    table = [t.to(cuda) for t in _tables(np.random.default_rng(4))[:3]]
    calls = [lambda form=form: attempt_call(form)[0](inputs[form][0], *inputs[form][1])
             for form in ATTEMPT_FORMS] + [lambda: sd.spec_walk(*table, 72)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    wrappers = (sd.attempt_manchester, sd.attempt_manchester_fold, sd.spec_walk)
    before = launches_of(*wrappers)
    with CardWork() as card:
        for _ in range(3):
            for call in calls:
                call()
    torch.cuda.synchronize()
    # each round: two forms of each attempt (a capture a row, one shared), one walk
    assert launches_of(*wrappers) == [before[0] + 6, before[1] + 6, before[2] + 3]
    assert not card.h2d, card.h2d
    assert not csrc_copies("attempt_manchester", "spec_walk")

    before = sd.spec_walk.launches
    with CardWork() as card:
        for _ in range(3):
            calls[-1]()
    torch.cuda.synchronize()
    assert sd.spec_walk.launches == before + 3
    assert not card.h2d and not card.work, (card.h2d, card.work)
    assert (CSRC / "spec_walk.cu").read_text().count("<<<") == 1    # one launch a call


# The 4B5B attempt staged by the copy engine and the ASK walk by binary
# lifting (csrc/attempt_4b5b.cu, csrc/ask_walk.cu): each equals its plain
# version on the edge inputs of tests/test_torch_ask_walk_4b5b_design.py,
# the walk also the statement-for-statement loop, at every slot count and
# table size it takes, and neither wrapper copies anything to the card.


@pytest.mark.gpu
@pytest.mark.parametrize("form", FOURB_FORMS)
def test_attempt_4b5b_kernels_match_plain_at_the_edges(cuda, form):
    x, args = fourb5b_edge_inputs(cuda)[form]
    wrapper, plain = attempt_4b5b_call(form)
    shared = x.stride(0) == 0
    before = (wrapper.launches, wrapper.shared_launches)
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.shared_launches) == (before[0] + (not shared),
                                                           before[1] + shared)
    for name, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, plain(x, *args)):
        assert g.dtype == w.dtype and torch.equal(g, w), (form, name)


@pytest.mark.gpu
@pytest.mark.parametrize("c1", ASK_C1S)
def test_ask_walk_kernel_matches_plain_on_edge_tables(cuda, c1):
    fields = ask_edge_tables(c1)
    on_card = fields.to(cuda)
    for mf in ASK_MFS:
        before = ask_spec.ask_walk.launches
        got = ask_spec.ask_walk(on_card, mf)
        torch.cuda.synchronize()
        assert ask_spec.ask_walk.launches == before + 1
        for name, g, w, o in zip(("peaks", "fire_ok", "bad"), got,
                                 ask_spec.ask_walk_plain(on_card, mf), ask_walk_serial(fields, mf)):
            assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g.cpu(), o), (mf, name)


@pytest.mark.gpu
def test_ask_walk_kernel_takes_every_slot_count_and_table_size(cuda):
    """Slot counts past the kernel's chunk of 1,024 and tables of C+1 up to
    2,048 (their six rows once filled 48 KB of shared memory); 2,049 and
    a count of 0 are refused."""
    for c1, mf in ((2048, 3000), (97, 1024), (97, 1025), (1, 5000), (33, 2049)):
        fields = ask_edge_tables(c1)
        got = ask_spec.ask_walk(fields.to(cuda), mf)
        torch.cuda.synchronize()
        for name, g, o in zip(("peaks", "fire_ok", "bad"), got, ask_walk_serial(fields, mf)):
            assert torch.equal(g.cpu(), o), (c1, mf, name)
    with pytest.raises(RuntimeError):
        ask_spec.ask_walk(ask_edge_tables(2049).to(cuda), 72)
    with pytest.raises(RuntimeError):
        ask_spec.ask_walk(ask_edge_tables(97).to(cuda), 0)


@pytest.mark.gpu
def test_4b5b_attempt_and_ask_walk_copy_nothing_to_the_card(cuda):
    """The sync word goes to the 4B5B attempt kernel by value and the walk
    reads only its table: no call copies host to device, and each call
    launches its one kernel and nothing else."""
    inputs = fourb5b_edge_inputs(cuda)
    table = ask_edge_tables(97).to(cuda)
    calls = {form: (lambda form=form: attempt_4b5b_call(form)[0](inputs[form][0],
                                                                  *inputs[form][1]),
                    attempt_4b5b_call(form)[0], "attempt_4b5b") for form in FOURB_FORMS}
    calls["ask_walk"] = (lambda: ask_spec.ask_walk(table, 72), ask_spec.ask_walk, "ask_walk")
    for call, _, _ in calls.values():
        call()
    torch.cuda.synchronize()
    for what, (call, wrapper, source) in calls.items():
        before = launches_of(wrapper)[0]
        with CardWork() as card:
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        assert launches_of(wrapper)[0] == before + 3, what
        assert not card.h2d and not card.work, (what, card.h2d, card.work)
        assert not csrc_copies(source), what
        assert (CSRC / f"{source}.cu").read_text().count("<<<") == 1, what   # one launch a call


# The record chain as warp scans over a tile already loaded and the fire
# rule's window maxima from block prefix and suffix maxima
# (csrc/ask_chain.cu, csrc/ask_fire.cu): each equals its plain version bit
# for bit on the edge inputs of tests/test_torch_ask_fire_chain_design.py,
# takes every row width and window the first designs took, and copies
# nothing to the card.


@pytest.mark.gpu
@pytest.mark.parametrize("win", CHAIN_WS)
def test_ask_chain_kernel_matches_plain_on_edge_rows(cuda, win):
    for guard in CHAIN_GUARDS:
        vals, base = chain_edge_rows(win, guard)
        before = ask.ask_chain.launches
        got = ask.ask_chain(vals.to(cuda), base.to(cuda), guard)
        torch.cuda.synchronize()
        assert ask.ask_chain.launches == before + 1
        for name, g, w in zip(("fired", "peak"), got, ask.ask_chain_plain(vals, base, guard)):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (win, guard, name)


@pytest.mark.gpu
@pytest.mark.parametrize("w", FIRE_WS)
def test_ask_fire_kernel_matches_plain_on_edge_inputs(cuda, w):
    """Every T of FIRE_TS, with the arrays aligned (the kernel's float4 and
    word path) and one element into their buffers (its scalar path)."""
    cfg = fire_cfg(w)
    for t in FIRE_TS:
        for offset in (0, 1):
            sync, upd = fire_edge_inputs(w, t, offset, cuda)
            assert (sync.data_ptr() % 16 == 0) == (offset == 0)
            before = ask_spec.dense_fire_candidates.launches
            got = ask_spec.dense_fire_candidates(cfg, sync, upd)
            torch.cuda.synchronize()
            assert ask_spec.dense_fire_candidates.launches == before + 1
            want = ask_spec.dense_fire_candidates_plain(cfg, sync, upd)
            assert got.dtype == want.dtype and torch.equal(got, want), (w, t, offset)


@pytest.mark.gpu
def test_ask_fire_and_chain_take_every_window_and_width(cuda):
    """The fire rule takes w from 1 to FIRE_MAX_W (the first design took
    up to 11,264) and refuses 0 and FIRE_MAX_W + 1; the chain takes any
    width from 1 and refuses 0."""
    for w in (11_264, FIRE_MAX_W):
        sync, upd = fire_edge_inputs(w, 50_001, device=cuda)
        got = ask_spec.dense_fire_candidates(fire_cfg(w), sync, upd)
        torch.cuda.synchronize()
        assert torch.equal(got, ask_spec.dense_fire_candidates_plain(fire_cfg(w), sync, upd)), w
    sync, upd = fire_edge_inputs(201, 4097, device=cuda)
    for w in (0, FIRE_MAX_W + 1):
        with pytest.raises(RuntimeError):
            ask_spec.dense_fire_candidates(fire_cfg(w), sync, upd)
    for win in (1, 2, 5000, 9000):
        vals, base = chain_edge_rows(win, 200)
        got = ask.ask_chain(vals.to(cuda), base.to(cuda), 200)
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, ask.ask_chain_plain(vals, base, 200)))
    with pytest.raises(RuntimeError):
        ask.ask_chain(torch.zeros((3, 0), device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda),
                      200)


@pytest.mark.gpu
def test_ask_fire_and_chain_copy_nothing_to_the_card(cuda):
    """Each call launches its one kernel and nothing else, and copies
    nothing host to device."""
    sync, upd = fire_edge_inputs(201, 339_453, device=cuda)
    vals, base = (a.to(cuda) for a in chain_edge_rows(1024, 200))
    calls = {"ask_fire": (lambda: ask_spec.dense_fire_candidates(ACFG, sync, upd),
                          ask_spec.dense_fire_candidates),
             "ask_chain": (lambda: ask.ask_chain(vals, base, 200), ask.ask_chain)}
    for call, _ in calls.values():
        call()
    torch.cuda.synchronize()
    for what, (call, wrapper) in calls.items():
        before = wrapper.launches
        with CardWork() as card:
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 3, what
        assert not card.h2d and not card.work, (what, card.h2d, card.work)
        assert not csrc_copies(what), what
        assert (CSRC / f"{what}.cu").read_text().count("<<<") == 1, what   # one launch a call


@pytest.mark.gpu
def test_xcorr_hits_2s_copies_nothing_to_the_card(cuda):
    """The pattern goes by value: a call on streams already on the card
    makes no host-to-device copy."""
    x, pattern = stream_edge_input(129, 50_001, cuda)
    streams = ex.two_streams(x)
    calls = (lambda: ex.xcorr_hits_2s(x, pattern, STREAM_THR, streams=streams),
             lambda: ex.xcorr_hits_2s(x, pattern, STREAM_THR, False, streams))
    for call in calls:
        call()
    torch.cuda.synchronize()
    before = ex.xcorr_hits_2s.launches
    with CardWork() as card:
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert ex.xcorr_hits_2s.launches == before + len(calls)
    assert not card.h2d, card.h2d
    assert not csrc_copies("xcorr_streams")


# The Viterbi decoder (csrc/viterbi.cu): one block of 64 threads a row at
# radix 4, a thread a state, the received values staged and the choices
# kept in shared memory; its decisions equal to the plain version's bit for
# bit on the corpora of tests/test_torch_convcode.py (every tail, hard and
# soft, ties on a 1/8 grid and between the first maximum's tree halves,
# depunctured rate-3/4 blocks, one row and 256 rows, and the long rows: one
# row of 62 and of 2,054 steps, two rows through the staging ring, one at
# the shared memory's edge and two whose choices exceed it) and on the
# coded PHYs' own header and payload blocks; one launch a call, nothing
# copied to the card, no allocation but the output where the choices fit;
# the coded decodes on the card equal the CPU's.

VITERBI_CORPORA = viterbi_corpora(big=256, long=True)
_VITERBI_PLAIN: dict[int, torch.Tensor] = {}


def viterbi_plain(idx: int, cuda) -> torch.Tensor:
    """The plain decode of VITERBI_CORPORA[idx] on the card, once."""
    if idx not in _VITERBI_PLAIN:
        _, received, n_bits, soft = VITERBI_CORPORA[idx]
        _VITERBI_PLAIN[idx] = convcode.viterbi_decode_plain(
            torch.from_numpy(received).to(cuda), n_bits, soft)
    return _VITERBI_PLAIN[idx]


@pytest.mark.gpu
@pytest.mark.parametrize("idx", range(len(VITERBI_CORPORA)),
                         ids=[c[0] for c in VITERBI_CORPORA])
def test_viterbi_kernel_matches_plain(cuda, idx):
    name, received, n_bits, soft = VITERBI_CORPORA[idx]
    x = torch.from_numpy(received).to(cuda)
    before = convcode.viterbi_decode.launches
    got = convcode.viterbi_decode(x, n_bits, soft)
    torch.cuda.synchronize()
    assert convcode.viterbi_decode.launches == before + 1
    want = viterbi_plain(idx, cuda)
    assert got.dtype == want.dtype == torch.uint8 and torch.equal(got, want), name
    assert torch.equal(got.cpu(), convcode.viterbi_decode_plain(torch.from_numpy(received),
                                                                n_bits, soft)), name


class _Allocations(TorchDispatchMode):
    """The tensors allocated on the card, by shape."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func.overloadpacket) in CardWork.ALLOC and out.device.type == "cuda":
            self.shapes.append(tuple(out.shape))
        return out


@pytest.mark.gpu
def test_viterbi_allocates_no_choices_where_they_fit(cuda):
    """A call allocates its output alone at every length whose choices fit
    in shared memory (a 263-byte frame's 2,054 steps and the edge's 12,448
    among them), and the choices scratch besides only past that (16,006
    steps)."""
    for idx, (name, received, n_bits, soft) in enumerate(VITERBI_CORPORA):
        x = torch.from_numpy(received).to(cuda)
        rows = x.reshape(-1, x.shape[-1]).shape[0]
        with _Allocations() as seen:
            convcode.viterbi_decode(x, n_bits, soft)
        torch.cuda.synchronize()
        n_steps = n_bits + 6
        want = [(rows, n_bits)]
        if not convcode.choices_fit(n_steps):
            want.append((rows, n_steps // 4 + n_steps % 4, 64))
        assert seen.shapes == want, (name, seen.shapes)
    assert convcode.choices_fit(12448) and not convcode.choices_fit(16006)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rate34", CODED_KINDS)
def test_viterbi_kernel_matches_plain_on_coded_blocks(cuda, kind, rate34):
    """The deinterleaved [depunctured] header and payload blocks a batched
    decode hands the decoder."""
    phy = port_phy(kind, rate34, device=cuda)
    _, batch = batch_corpus(kind, rate34, 0.6)
    x = torch.from_numpy(batch).to(cuda)
    starts = find_pattern_starts(x, phy.pre, phy.cfg.correlation_threshold, 6,
                                 min_sep=phy.frame_samples(40))
    for block, n_bits in zip(phy.soft_blocks(x, starts, 40), (phy.HDR_BITS, 320)):
        got = convcode.viterbi_decode(block, n_bits, soft=True)
        torch.cuda.synchronize()
        assert torch.equal(got, convcode.viterbi_decode_plain(block, n_bits, soft=True))


@pytest.mark.gpu
def test_viterbi_and_coded_decode_copy_nothing_to_the_card(cuda):
    """A Viterbi call launches its one kernel and copies nothing to the
    card; a batched coded decode of captures on the card launches the
    correlation kernel once and the Viterbi kernel twice (headers, then
    payloads) and copies nothing to the card (its tables copied once a
    process, at the first call)."""
    _, received, n_bits, soft = VITERBI_CORPORA[-1]
    r = torch.from_numpy(received).to(cuda)
    phy = port_phy("4b5b", True, device=cuda)
    _, batch = batch_corpus("4b5b", True, 0.3)
    x = torch.from_numpy(batch).to(cuda)
    calls = (lambda: convcode.viterbi_decode(r, n_bits, soft),
             lambda: phy.decode_equal_frames(x, 6, 40))
    for call in calls:
        call()
    torch.cuda.synchronize()
    for call, n_viterbi, n_hits in ((calls[0], 1, 0), (calls[1], 2, 1)):
        before = launches_of(convcode.viterbi_decode, xcorr_hits)
        with CardWork() as card:
            call()
        torch.cuda.synchronize()
        assert launches_of(convcode.viterbi_decode, xcorr_hits) == [before[0] + n_viterbi,
                                                                   before[1] + n_hits]
        assert not card.h2d, card.h2d
    with CardWork() as card:
        calls[0]()
    assert not card.work, card.work
    assert not csrc_copies("viterbi")
    assert (CSRC / "viterbi.cu").read_text().count("<<<") == 1    # one launch a call


@pytest.mark.gpu
@pytest.mark.parametrize("loaded", [False, True])
def test_adaptive_batch_decode_launches_and_copies_nothing_to_the_card(cuda, loaded):
    """A batched adaptive OFDM decode of captures on the card launches the
    normalized correlation kernel once and the Viterbi kernel twice
    (headers, then payloads), copies nothing to the card (its tables copied
    once a process, at the first call), and equals the CPU's decode."""
    loading = tuple(int(v) for v in np.random.default_rng(3).choice(
        [1, 2, 4, 6], size=74, p=[0.2, 0.4, 0.3, 0.1])) if loaded else None
    frames, batch = adaptive_corpus()
    if loaded:
        phy = ofdm_adaptive.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device="cpu")
        wave = phy.encode_frames(frames, gap_samples=333)
        z = np.zeros(150, np.float32)
        batch = np.stack([np.concatenate([wave, z]), np.concatenate([z, wave])])
        batch += np.random.default_rng(5).normal(0, 0.002, batch.shape).astype(np.float32)
    phy = ofdm_adaptive.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device=cuda)
    x = torch.from_numpy(batch.astype(np.float32)).to(cuda)
    first = phy.decode_equal_frames(x, 4, 48)
    torch.cuda.synchronize()
    before = launches_of(convcode.viterbi_decode, normalized_xcorr_dense)
    with CardWork() as card:
        got = phy.decode_equal_frames(x, 4, 48)
    torch.cuda.synchronize()
    assert launches_of(convcode.viterbi_decode, normalized_xcorr_dense) == [before[0] + 2,
                                                                            before[1] + 1]
    assert not card.h2d, card.h2d
    assert got == first == [frames, frames]
    cpu = ofdm_adaptive.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device="cpu")
    want = cpu.batched_decode_fn(4, 48)(torch.from_numpy(batch.astype(np.float32)))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(phy.batched_decode_fn(4, 48)(x), want))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rate34", CODED_KINDS)
def test_coded_phys_on_the_card_equal_the_cpu(cuda, kind, rate34):
    """The batched decode (starts and bits) and the streaming receiver
    (frames call for call, the buffer kept) on the card equal the CPU's."""
    _, batch = batch_corpus(kind, rate34, 0.6)
    on_card, on_cpu = port_phy(kind, rate34, device=cuda), port_phy(kind, rate34)
    got = on_card.batched_decode_fn(6, 40)(torch.from_numpy(batch).to(cuda))
    want = on_cpu.batched_decode_fn(6, 40)(torch.from_numpy(batch))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    for i in range(0, batch.shape[1], 2100):
        chunk = batch[0, i:i + 2100]
        assert on_card.process_samples(chunk) == on_cpu.process_samples(chunk), i
        assert len(on_card._buf) == len(on_cpu._buf)


@pytest.mark.gpu
def test_ofdm_conv_modem_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(12)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
              for i in range(4)]
    wave = ofdm.OfdmModem(fec="conv", device="cpu").encode_frames(frames, 300)
    x = np.concatenate([np.zeros(600, np.float32), wave, np.zeros(2000, np.float32)])
    x = (x + rng.normal(0, 0.05, len(x))).astype(np.float32)
    before = convcode.viterbi_decode.launches
    got = ofdm.OfdmModem(fec="conv", device=cuda).decode(x, 47, 8)
    assert convcode.viterbi_decode.launches == before + 1
    assert got == ofdm.OfdmModem(fec="conv", device="cpu").decode(x, 47, 8) == frames


# --- the multi-device decode (parallel/) on meshes of the card repeated ---------


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.SHARDED_EXPECT))
@pytest.mark.parametrize("use_spec", [True, False])
def test_sharded_decode_on_the_card_equals_the_cpu(cuda, name, use_spec):
    """decode_blocked_sharded over 8 shards of the card equals the same
    mesh of the CPU in every field; the speculative route launches #1 and
    the attempt once for the 8 shards and the walk once a fixpoint turn."""
    from trackmaker_tpu_torch.parallel import mesh, stream

    coding, wave, (dp, sp) = chip_smoke.sharded_inputs()[name]
    cfg = PhyConfig(line_coding=coding)
    attempt = sd.attempt_manchester if coding == "manchester" else sd.attempt_4b5b
    before = (xcorr_hits.launches, attempt.launches, sd.spec_walk.launches)
    got = stream.decode_blocked_sharded(cfg, torch.from_numpy(wave).to(cuda), 2, mesh.make_mesh(
        dp=dp, sp=sp, devices=[cuda] * 8), 8, use_spec=use_spec)
    after = (xcorr_hits.launches, attempt.launches, sd.spec_walk.launches)
    want = stream.decode_blocked_sharded(cfg, wave, 2, mesh.make_mesh(
        dp=dp, sp=sp, devices=["cpu"] * 8), 8, use_spec=use_spec)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w) if g.dtype != torch.float32 else torch.allclose(
            g.cpu(), w, rtol=0, atol=1e-5)
    if use_spec:
        _, ok, turns = stream.sharded_spec_run(cfg, wave, 2, mesh.make_mesh(
            dp=dp, sp=sp, devices=["cpu"] * 8), 8)
        assert bool(ok.all())
        assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 1, turns)


@pytest.mark.gpu
def test_batch_sharded_decode_on_the_card_equals_the_cpu(cuda):
    from trackmaker_tpu_torch.parallel import mesh

    x = _captures()
    got = mesh.batch_sharded_decode(CFG, torch.from_numpy(x).to(cuda), 2,
                                    mesh.make_mesh(dp=4, devices=[cuda] * 4), 16)
    want = mesh.batch_sharded_decode(CFG, x, 2, mesh.make_mesh(dp=4, devices=["cpu"] * 4), 16)
    for g, w in zip(got, want):
        assert torch.allclose(g.cpu().double(), w.double(), rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("adaptive", [False, True])
def test_sharded_ofdm_on_the_card_equals_the_cpu(cuda, adaptive):
    from trackmaker_tpu_torch.parallel import mesh
    from trackmaker_tpu_torch.parallel.ofdm_stream import decode_ofdm_blocked_sharded

    modem, frames, _, wave = chip_smoke.ofdm_shard_input(adaptive)
    n = len(frames[0].to_bytes())
    before = normalized_xcorr_dense.launches
    got = decode_ofdm_blocked_sharded(modem.cfg, torch.from_numpy(wave).to(cuda), n,
                                      mesh.make_mesh(sp=4, devices=[cuda] * 4))
    assert normalized_xcorr_dense.launches == before + 1
    want = decode_ofdm_blocked_sharded(modem.cfg, wave, n, mesh.make_mesh(sp=4,
                                                                          devices=["cpu"] * 4))
    assert got == want and [f.data for f in got] == [f.data for f in frames]


@pytest.mark.gpu
def test_optimistic_decode_on_the_card_equals_the_cpu(cuda):
    frames, x, vlens = chip_smoke.optimistic_input()
    cfg = PhyConfig(line_coding="4b5b", samples_per_level=chip_smoke.OPT_SPL)
    mf = chip_smoke.OPT_MAX_FRAMES
    for r in range(x.shape[0]):
        got, ok = decode_capture(cfg, torch.from_numpy(x[r]).to(cuda), 2, mf,
                                 valid_len=int(vlens[r]), optimistic=True)
        want, ok_cpu = decode_capture(cfg, torch.from_numpy(x[r]), 2, mf,
                                      valid_len=int(vlens[r]), optimistic=True)
        assert ok == ok_cpu == (r not in chip_smoke.OPT_BROKEN_ROWS)
        for g, w in zip(got, want):
            assert torch.allclose(g.cpu().double(), w.double(), rtol=0, atol=1e-5)
