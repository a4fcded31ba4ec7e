"""The port's MAC/PHY parameter sweep and dashboards
(``trackmaker_tpu_torch.bench.sweep``, ``.viz``, ``.viz_html``) against the
JAX package's, on the CPU.

The contended transfers draw their noise and backoff from seeds and count
every deadline in samples, so the stats dicts must be equal (all but the
sweep's ``wall_s``).  The correlation-debug traces sum floats: within 1e-5
of JAX's.  The dashboard's payload is NumPy on both sides and must be equal
but for those traces.  Captures are made from seeds with numpy and the
port's encoders on the CPU; the JAX package is imported only inside the
tests.
"""

import base64
import json
import pathlib

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch.bench import sweep, viz, viz_html


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def line_capture(seed: int = 0) -> np.ndarray:
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 30, dtype=np.uint8).tobytes())
              for i in range(2)]
    wave = PhyEncoder(PhyConfig(), device="cpu").encode_frames(frames, gap_samples=500).numpy()
    x = np.concatenate([np.zeros(700, np.float32), wave, np.zeros(300, np.float32)])
    return (x + rng.normal(0, 0.05, len(x))).astype(np.float32)


def ask_capture() -> np.ndarray:
    from trackmaker_tpu_torch.phy import ask

    frames = ask.build_frames(b"the quick brown fox", num_frames=3)
    return ask.build_track(ask.AskConfig(), frames, seed=3)


# --- the sweep ---------------------------------------------------------------------


def test_contended_transfer_equals_jax():
    from trackmaker_tpu.bench import sweep as jsweep
    from trackmaker_tpu.core.config import MacConfig as JMac
    from trackmaker_tpu.core.config import PhyConfig as JPhy
    from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig

    ab, cd = bytes(range(40)), bytes(range(100, 130))
    got = sweep.contended_transfer(ab, cd, PhyConfig(line_coding="4b5b"), MacConfig(cw_max=50),
                                   noise_std=0.02, seed=3, device="cpu")
    want = jsweep.contended_transfer(ab, cd, JPhy(line_coding="4b5b"), JMac(cw_max=50),
                                     noise_std=0.02, seed=3)
    assert got == want and got["exact"]


def test_contended_window_transfer_equals_jax():
    from trackmaker_tpu.bench import sweep as jsweep

    ab, cd = bytes(range(40)), bytes(range(200, 220))
    got = sweep.contended_window_transfer(ab, cd, arq="sr", window=4, seed=1, device="cpu")
    want = jsweep.contended_window_transfer(ab, cd, arq="sr", window=4, seed=1)
    assert got == want and got["exact"]


def test_mac_parameter_sweep_equals_jax(tmp_path):
    from trackmaker_tpu.bench import mac_parameter_sweep as jax_sweep
    from trackmaker_tpu_torch.bench import mac_parameter_sweep

    data = bytes(range(64))
    kw = {"line_codings": ("manchester",), "noise_stds": (0.01,), "repeats": 1}
    got = mac_parameter_sweep(data, out_json=tmp_path / "port.json", device="cpu", **kw)
    want = jax_sweep(data, out_json=tmp_path / "jax.json", **kw)
    written = [json.loads((tmp_path / f"{who}.json").read_text()) for who in ("port", "jax")]
    for rows in (got, want, *written):
        assert len(rows) == 1 and rows[0].pop("wall_s") >= 0
    assert got == want == written[0] == written[1] and got[0]["exact"]


# --- the dashboards ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["line", "ask"])
def test_correlation_debug_equals_jax(mode):
    from trackmaker_tpu.bench import viz_html as jviz_html

    x = line_capture() if mode == "line" else ask_capture()
    got = viz_html.correlation_debug(x, 48_000, mode=mode, device="cpu")
    want = jviz_html.correlation_debug(x, 48_000, mode=mode)
    assert list(got) == list(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].dtype == np.float32 and got[name].shape == w.shape, name
        assert np.abs(got[name] - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), name


def payload(path: pathlib.Path) -> dict:
    doc = path.read_text()
    start = doc.index("const D = ") + len("const D = ")
    return json.loads(doc[start:doc.index(";\n", start)])


def test_render_dashboard_embeds_jax_payload(tmp_path):
    from trackmaker_tpu.bench import viz_html as jviz_html

    x = line_capture(1)
    viz_html.render_dashboard((x, 48_000), tmp_path / "port.html", title="cap")
    jviz_html.render_dashboard((x, 48_000), tmp_path / "jax.html", title="cap")
    assert (tmp_path / "port.html").read_text() == (tmp_path / "jax.html").read_text()
    viz_html.render_dashboard((x, 48_000), tmp_path / "port_dbg.html",
                              debug=viz_html.correlation_debug(x, 48_000, device="cpu"))
    jviz_html.render_dashboard((x, 48_000), tmp_path / "jax_dbg.html",
                               debug=jviz_html.correlation_debug(x, 48_000))
    got, want = payload(tmp_path / "port_dbg.html"), payload(tmp_path / "jax_dbg.html")
    gd, wd = got.pop("debug"), want.pop("debug")
    assert got == want
    assert [(d["name"], d["stride"], d["n"]) for d in gd] == [
        (d["name"], d["stride"], d["n"]) for d in wd]
    for g, w in zip(gd, wd):
        gv = np.frombuffer(base64.b64decode(g["b64"]), np.float32)
        wv = np.frombuffer(base64.b64decode(w["b64"]), np.float32)
        assert np.abs(gv - wv).max() <= 1e-5


def test_load_and_spectrogram_equal_jax(tmp_path):
    from trackmaker_tpu.bench import viz as jviz
    from trackmaker_tpu_torch import io as tio

    x = line_capture(2)
    tio.dump_to_json(tmp_path / "c.json", tio.AudioData(48_000, x))
    tio.write_wav(tmp_path / "c.wav", x)
    for source in (tmp_path / "c.json", tmp_path / "c.wav", (x, 48_000)):
        (g, gsr), (w, wsr) = viz._load(source), jviz._load(source)
        assert gsr == wsr and np.array_equal(g, w)
    for got, want in zip(viz.spectrogram(x, 48_000), jviz.spectrogram(x, 48_000)):
        np.testing.assert_array_equal(got, want)


def test_plot_dashboard_and_ber_curves(tmp_path):
    pytest.importorskip("matplotlib")
    out = viz.plot_dashboard((line_capture(3), 48_000), tmp_path / "d" / "dash.png")
    assert out.stat().st_size > 0
    rows = [{"snr_db": s, "frame_loss_pct": v} for s, v in ((0, 50.0), (5, 10.0), (10, 0.0))]
    assert viz.plot_ber_curves(rows, tmp_path / "ber.png").stat().st_size > 0
