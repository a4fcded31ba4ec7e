"""The port's command line (``trackmaker_tpu_torch.cli``) against the JAX
package's (``trackmaker_tpu.cli``), on the CPU.

Each comparison runs both ``main(argv)`` in process under
``pytest.raises(SystemExit)``, the port's with ``--cpu``, on the same files
in ``tmp_path``, and compares the exit codes, the lines that list frames
(``seq= src= dst= len=``) or state the outcome, and the payload files; the
lines that report wall time are left out.  Captures are made from seeds with
numpy and the port's encoder on the CPU, written as 16-bit WAV at a gain of
0.5 (and as FLAC by ``chip_smoke.flac_encode``).  The subcommands that the
JAX package runs slowly on the CPU (ping, tx, sweep, router, viz, ber) run
on the port alone, each checked by its exit code and outcome line.  The JAX
package is imported only inside the tests.
"""

import argparse
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (module level: stdlib and NumPy only)
from trackmaker_tpu_torch import io as tio  # noqa: E402
from trackmaker_tpu_torch.cli import main as tcli  # noqa: E402

TEXT = REPO / "assets" / "think-different.txt"
GAIN = np.float32(0.5)
TIMING = re.compile(r"realtime|wall")   # the lines that report wall time


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run(main, argv, capsys) -> tuple[int, list[str]]:
    """(exit code, the output lines without the timing ones) of main(argv)."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    code = e.value.code
    lines = [ln for ln in capsys.readouterr().out.splitlines() if not TIMING.search(ln)]
    return (0 if code is None else code), lines


def both(argv, capsys, out=None) -> tuple[int, list[str]]:
    """Run the JAX CLI on argv and the port's on --cpu argv; assert equal
    exit codes and output lines, and where `out` (a path in argv) is given,
    equal files written there; return the port's code and lines."""
    from trackmaker_tpu.cli.main import main as jmain

    want = run(jmain, list(argv), capsys)
    want_bytes = out.read_bytes() if out else None
    if out:
        out.unlink()
    got = run(tcli.main, ["--cpu", *argv], capsys)
    assert got == want
    if out:
        assert out.read_bytes() == want_bytes
    return got


def capture(coding: str, payloads: list[bytes], seed: int, taps=(1.0,), noise: float = 0.05):
    """A noisy capture of data frames (src 1, dst 2) of `payloads` through
    the FIR `taps`, at GAIN, from the port's encoder on the CPU."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    frames = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    wave = PhyEncoder(PhyConfig(line_coding=coding), device="cpu").encode_frames(
        frames, gap_samples=300).numpy()
    wave = np.convolve(np.concatenate([np.zeros(400, np.float32), wave,
                                       np.zeros(600, np.float32)]), taps)[:len(wave) + 1000]
    rng = np.random.default_rng(seed)
    return ((wave + rng.normal(0, noise, len(wave))) * GAIN).astype(np.float32)


def payloads(rng, sizes) -> list[bytes]:
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


# --- compared with the JAX CLI ----------------------------------------------------------


@pytest.mark.parametrize("coding", ["manchester", "4b5b"])
def test_decode_many_captures_in_two_buckets_equals_jax(tmp_path, capsys, coding):
    rng = np.random.default_rng(26)
    sets = [payloads(rng, s) for s in ((40,), (60, 70), (20,))]
    paths, want = [], b""
    for i, p in enumerate(sets):
        x = capture(coding, p, seed=i)
        paths.append(str(tmp_path / f"c{i}.wav"))
        tio.write_wav(paths[-1], x)
        want += b"".join(p)
    lengths = [tio.read_wav(p)[0].shape[1] for p in paths]
    assert len(set(tcli.bucket_rows(lengths))) == 2, lengths
    argv = ["decode", *paths, "--encoding", coding]
    code, lines = both([*argv, "--output", str(tmp_path / "out.bin")], capsys,
                       tmp_path / "out.bin")
    assert code == 0 and (tmp_path / "out.bin").read_bytes() == want
    assert sum("seq=" in ln for ln in lines) == 4
    listed = chip_smoke.listed_frames("\n".join(lines))
    assert [len(listed[p]) for p in paths] == [1, 2, 1]


def test_decode_many_refuses_per_capture_modes_as_jax(tmp_path, capsys):
    x = capture("manchester", [b"abc"], seed=3)
    paths = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    for p in paths:
        tio.write_wav(p, x)
    code, lines = both(["decode", *paths, "--equalize"], capsys)
    assert code == 2 and "per-capture modes" in lines[0]


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_encode_then_decode_equals_jax(tmp_path, capsys, fmt):
    from trackmaker_tpu.cli.main import main as jmain

    data = bytes(range(256)) + b"acoustic payload " * 5
    (tmp_path / "in.bin").write_bytes(data)
    argv = ["encode", "--input", str(tmp_path / "in.bin"), "--src", "3", "--dst", "2"]
    assert run(tcli.main, ["--cpu", *argv, "--wav", str(tmp_path / "port.wav")], capsys)[0] == 0
    assert run(jmain, [*argv, "--wav", str(tmp_path / "jax.wav")], capsys)[0] == 0
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    path = tmp_path / "port.wav"
    if fmt == "flac":
        pcm = (tio.read_wav(path)[0][0] * 32768.0).astype(np.int16)
        path = tmp_path / "port.flac"
        path.write_bytes(chip_smoke.flac_encode(pcm)[0])
    code, lines = both(["decode", str(path), "--output", str(tmp_path / "out.bin")], capsys,
                       tmp_path / "out.bin")
    assert code == 0 and sum("seq=" in ln and "src=3" in ln for ln in lines) == 3
    assert (tmp_path / "out.bin").read_bytes() == data


@pytest.mark.parametrize("coding", ["manchester", "4b5b"])
def test_loopback_test_equals_jax(capsys, coding):
    code, lines = both(["test", "--encoding", coding], capsys)
    assert code == 0 and lines[-1].endswith("exact: True")


def test_decode_equalize_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(27)
    p = payloads(rng, (48, 48, 48))
    tio.write_wav(tmp_path / "echo.wav",
                  capture("manchester", p, seed=5, taps=(1.0,) + (0.0,) * 6 + (0.45,), noise=0.02))
    code, lines = both(["decode", str(tmp_path / "echo.wav"), "--equalize",
                        "--output", str(tmp_path / "out.bin")], capsys, tmp_path / "out.bin")
    assert code == 0 and lines[0].startswith("equalizer: trained at sample")
    assert (tmp_path / "out.bin").read_bytes() == b"".join(p)


def test_ask_test_equals_jax(capsys):
    code, lines = both(["ask-test", "--frames", "8", "--input", str(TEXT)], capsys)
    assert code == 0 and lines == ["ASK loopback: 8/8 frames, prefix exact: True"]


def test_ofdm_test_conv_equals_jax(tmp_path, capsys):
    (tmp_path / "short.txt").write_bytes(TEXT.read_bytes()[:200])
    code, lines = both(["ofdm-test", "--fec", "conv", "--input", str(tmp_path / "short.txt")],
                       capsys)
    assert code == 0 and lines == ["OFDM loopback: 3/3 frames, exact: True, 0.48s airtime"]


def test_ofdm_adapt_equals_jax(capsys):
    code, lines = both(["ofdm-adapt"], capsys)
    assert code == 0 and "loaded round-trip over the shaped channel: 4/4 frames, exact: True" in lines
    assert len(lines) == 6 and "bits/sym" in lines[1]


# --- the port alone ---------------------------------------------------------------------


def port(argv, capsys) -> tuple[int, str]:
    with pytest.raises(SystemExit) as e:
        tcli.main(["--cpu", *argv])
    return e.value.code, capsys.readouterr().out


def test_ping_runs_on_the_port(capsys):
    code, out = port(["ping", "--count", "1"], capsys)
    assert code == 0 and "1 transmitted, 1 received, 0% loss" in out


def test_tx_selective_repeat_runs_on_the_port(tmp_path, capsys):
    data = bytes(np.random.default_rng(28).integers(0, 256, 200, dtype=np.uint8))
    (tmp_path / "in.bin").write_bytes(data)
    code, out = port(["tx", "--input", str(tmp_path / "in.bin"), "--output",
                      str(tmp_path / "out.bin"), "--arq", "sr", "--window", "4"], capsys)
    assert code == 0 and '"exact": true' in out
    assert (tmp_path / "out.bin").read_bytes() == data


def test_sweep_runs_on_the_port(tmp_path, capsys):
    (tmp_path / "in.bin").write_bytes(bytes(range(64)))
    code, out = port(["sweep", "--input", str(tmp_path / "in.bin"), "--out",
                      str(tmp_path / "sweep.json")], capsys)
    assert code == 0
    assert [ln.split(":")[0].split() for ln in out.splitlines()] == [
        ["manchester", "spl=3", "noise=0.0"], ["4b5b", "spl=3", "noise=0.0"]]
    assert all(ln.endswith("exact=True") for ln in out.splitlines())
    assert (tmp_path / "sweep.json").exists()


def test_router_runs_on_the_port(capsys):
    code, out = port(["router"], capsys)
    assert code == 0 and out.strip() == "router demo: acoustic -> router -> wifi host -> back: OK"


def test_viz_html_runs_on_the_port(tmp_path, capsys):
    tio.write_wav(tmp_path / "c.wav", capture("manchester", [b"viz"], seed=6))
    code, out = port(["viz", str(tmp_path / "c.wav"), "--html", str(tmp_path / "d.html"),
                      "--corr", "line"], capsys)
    assert code == 0 and out.strip() == f"wrote {tmp_path / 'd.html'}"
    assert "preamble corr" in (tmp_path / "d.html").read_text()


def test_ber_runs_on_the_port(capsys):
    code, out = port(["ber", "--frames", "2"], capsys)
    lines = out.splitlines()
    assert code == 0 and len(lines) == 16
    assert lines[-1].startswith("clock    5000 ppm: loss")
    assert lines[7].startswith("SNR   15.0 dB: loss   0.0%")


def test_tun_bridges_a_ping_without_a_tun_device(monkeypatch, capsys):
    """`tun` with ``TunPort`` replaced by one end of a loopback pair (no TUN
    device is opened): an echo request from the kernel's side crosses the
    acoustic link to the echo host, its reply comes back to the kernel's
    side, and Ctrl-C (a KeyboardInterrupt from the bus) ends the command
    with its counts line, the port closed and exit code 0."""
    from trackmaker_tpu_torch.link.bus import SimulatedBus
    from trackmaker_tpu_torch.net import ports
    from trackmaker_tpu_torch.net.icmp import IcmpPacket
    from trackmaker_tpu_torch.net.ip import Ipv4Header, build_ipv4_packet

    kernel = {}
    r, w = os.pipe()

    class LoopbackTun(ports.LoopbackPort):
        def __init__(self, name, ip=None, netmask_bits=24, mtu=None):
            super().__init__()
            side = ports.LoopbackPort()
            self.peer, side.peer = side, self
            self.fd = r
            kernel.update(side=side, args=(name, ip, netmask_bits, mtu))
            echo = IcmpPacket.echo_request(7, 1, b"over tun")
            side.send(build_ipv4_packet(1, bytes([10, 78, 0, 1]), bytes([10, 78, 0, 2]),
                                        echo.to_bytes()))

        def close(self):
            kernel["closed"] = True

    real_step = SimulatedBus.step

    def step(bus):
        real_step(bus)
        if kernel["side"]._rx or bus.now > 5 * bus.sample_rate:
            raise KeyboardInterrupt

    monkeypatch.setattr(ports, "TunPort", LoopbackTun)
    monkeypatch.setattr(SimulatedBus, "step", step)
    try:
        code, out = port(["tun"], capsys)
    finally:
        os.close(r)
        os.close(w)
    assert code == 0 and kernel["closed"]
    assert kernel["args"] == ("tm0", "10.78.0.1", 24, 200)
    assert out.splitlines()[-1] == "bridged 1 out / 1 in packets; host answered 1 pings"
    reply = kernel["side"].recv()
    hdr = Ipv4Header.from_bytes(reply)
    icmp = IcmpPacket.from_bytes(reply[hdr.ihl_bytes:])
    assert (bytes(hdr.source_ip), icmp.icmp_type, icmp.payload) == (
        bytes([10, 78, 0, 2]), 0, b"over tun")


def test_no_card_without_cpu_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("TM_CPU", None)
    out = subprocess.run([sys.executable, "-m", "trackmaker_tpu_torch.cli", "test"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device found" in out.stderr and out.stdout == ""


# --- the parser -------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The top-level parser that main builds, taken at its parse_args call,
    before any subcommand runs."""
    seen = []

    def stop(self, *args, **kw):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(["test"])
    monkeypatch.undo()
    return seen[0]


def options(parser) -> dict:
    """Each option of a parser by its flags (or dest): default, choices,
    nargs, required, type; and each subcommand's options under its name."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out["<subcommands>"] = {name: options(p) for name, p in a.choices.items()}
            continue
        key = tuple(a.option_strings) or a.dest
        out[key] = (a.dest, a.default, a.choices, a.nargs, a.required,
                    getattr(a.type, "__name__", a.type), type(a).__name__)
    return out


def test_parser_has_every_jax_subcommand_and_flag(monkeypatch):
    from trackmaker_tpu.cli.main import main as jmain

    want = options(parser_of(jmain, monkeypatch))
    got = options(parser_of(tcli.main, monkeypatch))
    assert set(want["<subcommands>"]) == set(got["<subcommands>"])
    assert len(got["<subcommands>"]) == 13
    for name, opts in want["<subcommands>"].items():
        assert got["<subcommands>"][name] == opts, name
    assert {k: v for k, v in got.items() if k != "<subcommands>"} == {
        k: v for k, v in want.items() if k != "<subcommands>"}


def test_importing_every_module_builds_nothing():
    """Importing each module of the port (the CLI's ``__main__`` among them)
    builds no library, loads none, initializes no device and imports no
    matplotlib."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import trackmaker_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from trackmaker_tpu_torch import _build, runtime\n"
        "assert 'trackmaker_tpu_torch.cli.__main__' in names, names\n"
        "assert 'trackmaker_tpu_torch.bench.viz_html' in names, names\n"
        "assert runtime._lib is None and not _build._loaded\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, stdin=subprocess.DEVNULL,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_interactive_menu_runs_the_chosen_subcommand(monkeypatch, capsys):
    """With no arguments, main() asks for a mode (an invalid answer asks
    again) and runs it; TM_CPU=1 puts it on the CPU."""
    answers = iter(["9", "x", "2"])
    monkeypatch.setattr(sys, "argv", ["trackmaker-tpu-torch"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    monkeypatch.setenv("TM_CPU", "1")
    with pytest.raises(SystemExit) as e:
        tcli.main()
    out = capsys.readouterr().out.splitlines()
    assert e.value.code == 0
    assert out[1:3] == ["  1. Loopback PHY test (Manchester)", "  2. Loopback PHY test (4B5B)"]
    assert out.count("invalid choice") == 2
    assert "encoding: 4b5b, frames: 6, samples: 23460 (0.49s airtime)" in out
