"""The command's exits: no result without a card, none with JAX loaded,
none where the program is missing."""

import json
import shutil
import subprocess
import sys

import run


def command(args, cwd, env_extra=None):
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


ARGS = ["--workload", "manchester.corpus", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    out = command(ARGS, run.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone: the
    run, past its look for a card, fails on the missing program."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, 'benchmark'); import run; "
            f"r = run.run(run.parse({ARGS!r}), device=torch.device('cpu')); print(r)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "trackmaker_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
    assert command(ARGS, tmp_path).returncode != 0


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "run", lambda args: {"correct": True})
    monkeypatch.setitem(sys.modules, "jax", sys)     # a stand-in module under the name
    assert run.main(ARGS) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.main(ARGS) == 0
    assert json.loads(capsys.readouterr().out) == {"correct": True}
