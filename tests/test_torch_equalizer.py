"""The port's preamble-trained MMSE equalizer (trackmaker_tpu_torch.dsp.equalizer)
and echo channel (dsp.channel.multipath) against the JAX package's, on the
CPU.  The JAX side runs as its own suite runs it here: its anchor search
takes the CPU branch of ``auto_xcorr_row_stats``.  The JAX references run
once per module (a fixture).

The corpora are those of ``tests/test_equalizer.py`` for the
preamble-trained equalizer: a 0.5 echo at 7 samples for both line codes,
an acausal echo, a clean channel, noise only, the channel-estimate
channel, an attenuated first frame (multi-anchor), and a preamble at
sample 0.

Tolerances, each with its reason:
* LS matrices: bit for bit (the same host float64 code);
* multipath: atol 1e-6 (a causal convolution against XLA's);
* row maxima and anchor qualities: atol 1e-5 (the correlation adds its
  taps in another order than XLA's convolution);
* h: atol 1e-4·max|h| (LS products summed in another order); lam: rtol 1e-4;
* the FIR taps: atol 1e-5 (torch's and JAX's FFTs round differently);
* the equalized capture: atol 1e-4·max|rx| (a 385-tap FIR summed in
  another order);
* anchors, the gate and every decoded field but the correlation: exactly
  equal.
Each corpus first asserts that it keeps away from the decision edges those
exact checks hang on (``_check_margins``): the peel's set of rows holds in
any order of maxima within 1e-5, an anchor row's two largest lags differ
by more than 1e-5, every anchor's quality lies more than 1e-3 from
min_quality, the winning fit ratio beats every other by a relative 1e-3 (or
both sit on the 1e-4 floor and the winner comes first in the peel by more
than 1e-5), and no lag of the equalized capture's correlation lies within
1e-4 of the decoder's 0.9 threshold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.core.framing import Frame as JaxFrame
from trackmaker_tpu.dsp import channel as jchannel
from trackmaker_tpu.dsp import equalizer as jeq
from trackmaker_tpu.oracle.phy import OracleEncoder
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync import auto_xcorr_row_stats as jax_row_stats
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.dsp import channel, equalizer
from trackmaker_tpu_torch.phy.decoder import decode_capture_fast
from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
from trackmaker_tpu_torch.sync import auto_xcorr_row_stats
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain

JCFGS = {lc: JaxPhyConfig(line_coding=lc) for lc in (MANCHESTER, FOUR_B_FIVE_B)}
CFGS = {lc: convert.phy_config_from_fields(dataclasses.asdict(c)) for lc, c in JCFGS.items()}
MF = 12              # decode slots: the corpora hold at most 8 frames
MIN_Q = 0.5
ROW_MARGIN = 1e-5
DECISION_MARGIN = 1e-3
CORR_MARGIN = 1e-4
LAM_FLOOR = 1e-4
CHANEST_TAPS = {0: 1.0, 4: -0.4, 9: 0.3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _taps(spec: dict[int, float]) -> np.ndarray:
    taps = np.zeros(max(spec) + 1, np.float32)
    for d, a in spec.items():
        taps[d] = a
    return taps


def _echo(wave: np.ndarray, taps: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    ech = np.asarray(jchannel.multipath(jnp.asarray(wave), jnp.asarray(taps)))
    rng = np.random.default_rng(seed)
    return (ech + rng.normal(0, sigma, len(ech))).astype(np.float32)


def _frames(n: int) -> list:
    return [JaxFrame.new_data(i, 1, 2, bytes([i + 1]) * 40) for i in range(n)]


def _gapped(lc, spec, sigma, n=8, seed=0):
    enc = OracleEncoder(JCFGS[lc])
    parts = []
    for f in _frames(n):
        parts += [enc.encode_frame(f), np.zeros(400, np.float32)]
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    return _echo(wave, _taps(spec), sigma, seed)


def _attenuated():
    enc = OracleEncoder(JCFGS[MANCHESTER])
    frames = _frames(8)
    wave = np.concatenate([np.zeros(500, np.float32), enc.encode_frame(frames[0]) * 0.4]
                          + [enc.encode_frame(f) for f in frames[1:]]
                          + [np.zeros(600, np.float32)])
    return _echo(wave, _taps({0: 1.0, 9: 0.6}), 0.02, 3)


CORPORA = {
    "echo": (MANCHESTER, lambda: _gapped(MANCHESTER, {0: 1.0, 7: 0.5}, 0.01)),
    "echo_4b5b": (FOUR_B_FIVE_B, lambda: _gapped(FOUR_B_FIVE_B, {0: 1.0, 7: 0.5}, 0.01)),
    "acausal": (MANCHESTER, lambda: _gapped(MANCHESTER, {0: 0.6, 11: 1.0}, 0.005)),
    "clean": (MANCHESTER, lambda: _gapped(MANCHESTER, {0: 1.0}, 0.02, seed=3)),
    "noise": (MANCHESTER,
              lambda: np.random.default_rng(7).normal(0, 0.1, 40_000).astype(np.float32)),
    "chanest": (MANCHESTER, lambda: _gapped(MANCHESTER, CHANEST_TAPS, 0.005)),
    "attenuated": (MANCHESTER, _attenuated),
    "anchor0": (MANCHESTER, lambda: _gapped(MANCHESTER, {0: 1.0, 7: 0.5}, 0.01, n=4, seed=1)),
}
EQ_CASES = [(name, 4) for name in CORPORA] + [("attenuated", 1), ("echo", 1)]
DECODED = [name for name in CORPORA if name != "noise"]


@pytest.fixture(scope="module")
def ref():
    """Each corpus and the JAX package's results on it."""
    out = {}
    for name, (lc, make) in CORPORA.items():
        jcfg = JCFGS[lc]
        x = make()
        xj = jnp.asarray(x)
        rowmax, rowpos = jax_row_stats(xj, jax_preamble(jcfg))
        r = dict(lc=lc, x=x, rowmax=np.asarray(rowmax), rowpos=np.asarray(rowpos), eq={})
        for case, na in EQ_CASES:
            if case == name:
                y, info = jeq.equalize_capture(jcfg, xj, n_anchors=na)
                r["eq"][na] = (np.asarray(y), {k: np.asarray(v) for k, v in info.items()})
        if name in DECODED:
            r["dec"] = jeq.decode_capture_eq(jcfg, x, 2, max_frames=MF)
        out[name] = r
    return out


def _decoded(res) -> list[tuple]:
    """The valid slots of a decode, in slot order, as comparable tuples."""
    valid = np.asarray(res.valid)
    cols = [np.asarray(getattr(res, f)) for f in
            ("length", "frame_type", "sequence", "src", "dst", "start")]
    fb = np.asarray(res.frame_bytes)
    return [(fb[k, :7 + int(cols[0][k])].tobytes(), *(int(c[k]) for c in cols))
            for k in np.nonzero(valid)[0]]


def _top_two(v: np.ndarray) -> tuple[float, float]:
    s = np.sort(v)[::-1]
    return float(s[0]), float(s[1]) if len(s) > 1 else -np.inf


# --- LS matrices and the echo channel ----------------------------------------------


@pytest.mark.parametrize("lc,rows", [(MANCHESTER, 97), (FOUR_B_FIVE_B, 61)])
def test_ls_solver_matches_jax_bit_for_bit(lc, rows):
    got = equalizer._ls_solver_np(CFGS[lc])
    want = jeq._ls_solver_np(JCFGS[lc])
    assert got[2:] == want[2:] and got[3] == rows
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec", [{0: 1.0, 7: 0.5}, {0: 0.6, 11: 1.0}, CHANEST_TAPS, {0: 1.0},
                                  {0: 1.0, 7: 0.45}])
def test_multipath_matches_jax(spec):
    x = np.random.default_rng(5).normal(0, 1, (2, 3000)).astype(np.float32)
    taps = _taps(spec)
    got = channel.multipath(torch.from_numpy(x), taps)
    want = np.asarray(jchannel.multipath(jnp.asarray(x), jnp.asarray(taps)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = channel.multipath(torch.from_numpy(x[0]), tuple(taps.tolist()))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=0, atol=1e-6)


# --- the equalizer ----------------------------------------------------------------


def _window_ratio(cfg, x: np.ndarray, anchor: int) -> float:
    """The unclipped fit ratio res/sig at `anchor`, in float64."""
    m, a, i0, rows = equalizer._ls_solver_np(cfg)
    idx = anchor + i0 + np.arange(rows)
    b = np.where((idx >= 0) & (idx < len(x)), x[np.clip(idx, 0, len(x) - 1)], 0.0)
    fit = a.astype(np.float64) @ (m.astype(np.float64) @ b)
    return float(np.mean((fit - b) ** 2) / max(np.mean(b ** 2), 1e-12))


def _check_margins(cfg, x: np.ndarray, n_anchors: int) -> None:
    """The corpus keeps away from each decision edge of equalize_capture,
    so that sums taken in another order (within ROW_MARGIN on a
    correlation) cannot change a decision:
    * picks within ROW_MARGIN of each other lie more than a preamble and a
      row apart (neither suppresses the other, in whichever order they come);
    * each picked row's two largest lags differ by more than ROW_MARGIN;
    * every pick's quality lies more than 1e-3 from min_quality, and every
      gated fit ratio more than a relative 1e-3 from the [1e-4, 1] clip;
    * the winning lam beats every other gated one by a relative 1e-3, or
      both sit on the 1e-4 floor and the winner's quality beats the
      other's by more than ROW_MARGIN (it comes first in the peel);
    * where rows left after the peel come within ROW_MARGIN of its last
      pick (either could be the last candidate), the winner is not that
      pick, and it beats those rows as it beats the picks."""
    pat = preamble_waveform(cfg)
    corr = normalized_xcorr_dense_plain(torch.from_numpy(x[None]), pat)[0].numpy()
    rowmax, rowpos = (v.numpy() for v in auto_xcorr_row_stats(torch.from_numpy(x), pat))
    rm = rowmax.astype(np.float64)
    anchors, quals = [], []
    for _ in range(n_anchors):
        j = int(np.argmax(rm))
        if rm[j] > -np.inf:
            a, b = _top_two(corr[128 * j: 128 * (j + 1)])
            assert a - b > ROW_MARGIN, "an anchor row's two largest lags tie"
        anchors.append(int(rowpos[j]))
        quals.append(float(rm[j]))
        rm = np.where(np.abs(rowpos - rowpos[j]) < len(pat), -np.inf, rm)
    near = [int(j) for j in np.flatnonzero(rm > quals[-1] - ROW_MARGIN)]
    others = anchors + [int(rowpos[j]) for j in near]
    oquals = quals + [float(rm[j]) for j in near]
    for i in range(len(others)):
        for k in range(i):
            if abs(oquals[i] - oquals[k]) <= ROW_MARGIN and oquals[i] > -np.inf:
                assert abs(others[i] - others[k]) >= len(pat) + 128
    assert all(abs(q - MIN_Q) > DECISION_MARGIN for q in oquals)
    ratios = [_window_ratio(cfg, x, a) for a in others]
    gated = [k for k, q in enumerate(oquals) if q >= MIN_Q]
    for r in (ratios[k] for k in gated):
        assert abs(r / LAM_FLOOR - 1) > DECISION_MARGIN and abs(r - 1) > DECISION_MARGIN
    lam = np.clip(ratios, LAM_FLOOR, 1.0)
    picked = [k for k in gated if k < n_anchors]
    if picked:
        w = min(picked, key=lambda k: lam[k])
        assert not near or w < n_anchors - 1
        for k in gated:
            assert (k == w or lam[k] > lam[w] * (1 + DECISION_MARGIN)
                    or (lam[k] == lam[w] == LAM_FLOOR and oquals[w] - oquals[k] > ROW_MARGIN))


@pytest.mark.parametrize("name,n_anchors", EQ_CASES)
def test_equalize_capture_matches_jax(ref, name, n_anchors):
    r = ref[name]
    cfg, x = CFGS[r["lc"]], r["x"]
    _check_margins(cfg, x, n_anchors)
    want, want_info = r["eq"][n_anchors]
    got, info = equalizer.equalize_capture(cfg, torch.from_numpy(x), n_anchors=n_anchors)
    info = {k: v.numpy() for k, v in info.items()}
    assert set(info) == set(want_info)
    assert info["anchor"].dtype == np.int32
    assert info["anchor"] == want_info["anchor"] and info["applied"] == want_info["applied"]
    np.testing.assert_allclose(info["quality"], want_info["quality"], rtol=0, atol=ROW_MARGIN)
    np.testing.assert_allclose(info["lam"], want_info["lam"], rtol=1e-4)
    np.testing.assert_allclose(info["h"], want_info["h"], rtol=0,
                               atol=1e-4 * np.abs(want_info["h"]).max())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(x).max())
    if not info["applied"]:
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("name", ["echo", "echo_4b5b", "acausal", "chanest", "attenuated"])
def test_channel_taps_and_fir_match_jax(ref, name):
    """estimate_channel at JAX's peel anchors, then _mmse_taps and
    _apply_fir each fed JAX's own inputs."""
    r = ref[name]
    cfg, jcfg, x = CFGS[r["lc"]], JCFGS[r["lc"]], r["x"]
    rm, rp = r["rowmax"].copy(), r["rowpos"]
    anchors = []
    for _ in range(4):
        a = int(rp[int(np.argmax(rm))])
        anchors.append(a)
        rm[np.abs(rp - a) < len(jax_preamble(jcfg))] = -np.inf
    hj, lamj = jax.vmap(lambda a: jeq.estimate_channel(jcfg, jnp.asarray(x), a))(
        jnp.asarray(anchors, jnp.int32))
    hj, lamj = np.array(hj), np.array(lamj)
    h, lam = equalizer.estimate_channel(cfg, torch.from_numpy(x[None]),
                                        torch.tensor([anchors], dtype=torch.int32))
    np.testing.assert_allclose(h[0].numpy(), hj, rtol=0, atol=1e-4 * np.abs(hj).max())
    np.testing.assert_allclose(lam[0].numpy(), lamj, rtol=1e-4)
    gj = np.array(jax.vmap(jeq._mmse_taps)(jnp.asarray(hj), jnp.asarray(lamj)))
    g = equalizer._mmse_taps(torch.from_numpy(hj), torch.from_numpy(lamj))
    assert g.shape == gj.shape == (4, 2 * equalizer.L_HALF + 1)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-5)
    eqj = np.asarray(jeq._apply_fir(jnp.asarray(x), jnp.asarray(gj[0])))
    eq = equalizer._apply_fir(torch.from_numpy(x[None]), torch.from_numpy(gj[:1]))
    np.testing.assert_allclose(eq[0].numpy(), eqj, rtol=0, atol=1e-4 * np.abs(x).max())


def test_channel_estimate_matches_truth(ref):
    """At the strongest anchor the LS taps recover the simulated impulse
    response within the noise, and the fit ratio is small."""
    x = ref["chanest"]["x"]
    cfg = CFGS[MANCHESTER]
    _, info = equalizer.equalize_capture(cfg, torch.from_numpy(x), n_anchors=1)
    h, lam = equalizer.estimate_channel(cfg, torch.from_numpy(x[None]), info["anchor"][None, None])
    est = h[0, 0, equalizer.K0:equalizer.K0 + 10].numpy()
    assert np.max(np.abs(est - _taps(CHANEST_TAPS))) < 0.06
    assert float(lam[0, 0]) < 0.05


def test_anchor_near_the_start_reads_the_silence_before_it():
    """An anchor within K0+1 samples of the capture's start reads zeros
    before sample 0 and past the end, as the JAX package's padded window
    does."""
    cfg, jcfg = CFGS[MANCHESTER], JCFGS[MANCHESTER]
    x = np.random.default_rng(9).normal(0, 1, 700).astype(np.float32)
    for a in (0, 5, 17, 300, 650, 699):
        hj, lamj = jeq.estimate_channel(jcfg, jnp.asarray(x), jnp.int32(a))
        h, lam = equalizer.estimate_channel(cfg, torch.from_numpy(x[None]),
                                            torch.tensor([[a]], dtype=torch.int32))
        np.testing.assert_allclose(h[0, 0].numpy(), np.asarray(hj), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(hj)).max())
        np.testing.assert_allclose(float(lam[0, 0]), float(lamj), rtol=1e-4)


def test_equalize_batch_rows_match_single_calls(ref):
    """Manchester corpora zero-padded to one length: each row of the batched
    call equals the single-capture call on that row."""
    names = ["echo", "noise", "attenuated", "anchor0", "clean"]
    t = max(len(ref[n]["x"]) for n in names)
    x = np.zeros((len(names), t), np.float32)
    for r, n in enumerate(names):
        x[r, :len(ref[n]["x"])] = ref[n]["x"]
    cfg = CFGS[MANCHESTER]
    out, info = equalizer.equalize_capture(cfg, torch.from_numpy(x))
    assert out.shape == x.shape and info["h"].shape == (len(names), equalizer.N_CH)
    for r in range(len(names)):
        one, one_info = equalizer.equalize_capture(cfg, torch.from_numpy(x[r]))
        assert one_info["anchor"] == info["anchor"][r], names[r]
        assert one_info["applied"] == info["applied"][r], names[r]
        for k in ("quality", "lam", "h"):
            np.testing.assert_allclose(one_info[k].numpy(), info[k][r].numpy(), rtol=1e-4,
                                       atol=ROW_MARGIN, err_msg=f"{names[r]} {k}")
        np.testing.assert_allclose(out[r].numpy(), one.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(x[r]).max())
    assert info["applied"].tolist() == [True, False, True, True, True]


def test_noise_only_passes_through_bit_for_bit(ref):
    x = ref["noise"]["x"]
    got, info = equalizer.equalize_capture(CFGS[MANCHESTER], torch.from_numpy(x))
    assert not bool(info["applied"]) and float(info["quality"]) < MIN_Q
    np.testing.assert_array_equal(got.numpy(), x)


# --- the equalized decode -----------------------------------------------------------


@pytest.mark.parametrize("name", DECODED)
def test_decode_capture_eq_matches_jax(ref, name):
    """The frames decoded from the port's equalized capture equal JAX's, on
    corpora whose equalized correlation keeps away from the threshold."""
    r = ref[name]
    cfg = CFGS[r["lc"]]
    pat = preamble_waveform(cfg)
    eq_j = r["eq"][4][0].copy()
    eq_t, _ = equalizer.equalize_capture(cfg, torch.from_numpy(r["x"]))
    corr_j = normalized_xcorr_dense_plain(torch.from_numpy(eq_j[None]), pat)[0].numpy()
    corr_t = normalized_xcorr_dense_plain(eq_t[None], pat)[0].numpy()
    thr = cfg.correlation_threshold
    assert not np.any(np.abs(corr_j - thr) < CORR_MARGIN)
    np.testing.assert_array_equal(corr_t >= thr, corr_j >= thr)
    got = equalizer.decode_capture_eq(cfg, r["x"], 2, max_frames=MF, device="cpu")
    assert got.valid.device.type == "cpu"
    assert _decoded(got) == _decoded(r["dec"])
    assert len(_decoded(got)) == (4 if name == "anchor0" else 8)


def test_equalizer_recovers_what_stock_loses(ref):
    """The corpora's point, on the port: the stock decode loses frames of
    the echo captures and the equalized decode gets all of them back."""
    for name in ("echo", "echo_4b5b", "attenuated"):
        r = ref[name]
        cfg = CFGS[r["lc"]]
        x = torch.from_numpy(r["x"])
        stock = int(decode_capture_fast(cfg, x, 2, max_frames=MF).count)
        eq = int(equalizer.decode_capture_eq(cfg, x, 2, max_frames=MF).count)
        assert stock < eq == 8, name


def test_numpy_input_goes_to_the_card():
    """A NumPy capture goes to the card by default, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x = np.zeros(5000, np.float32)
    with pytest.raises((AssertionError, RuntimeError)):
        equalizer.decode_capture_eq(CFGS[MANCHESTER], x, 2)
