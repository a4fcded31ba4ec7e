"""No run loads JAX, Flax or the JAX package: the check compares whole
top-level names, and the harness with the port's entry points loads none."""

import subprocess
import sys

import pytest

import run


@pytest.mark.parametrize("name,bad", [
    ("trackmaker_tpu_torch", []), ("trackmaker_tpu_torch.phy.decoder", []),
    ("trackmaker_tpu", ["trackmaker_tpu"]), ("trackmaker_tpu.phy", ["trackmaker_tpu"]),
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("jaxtyping", []), ("flaxen", []), ("numpy", []),
])
def test_whole_top_level_names(name, bad):
    assert run.forbidden_modules([name]) == bad


def test_harness_and_entries_load_no_jax():
    code = (
        "import sys; sys.path[:0] = ['benchmark', '.']\n"
        "import run, control\n"
        "from harness import check, manifest, phy, roofline, stats, trace, traffic\n"
        "man = manifest.load()\n"
        "for w in man['workloads']:\n"
        "    mix = manifest.traffic(w['traffic'])\n"
        "    cfg = manifest.config(man, w['config'])\n"
        "    e = manifest.module('entries', mix['entry']).Entry(cfg, phy.Phy(cfg), mix, 1000)\n"
        "    manifest.module('references', cfg['reference'])\n"
        "for m in man['per_layer']:\n"
        "    manifest.module('metrics', m['name'])\n"
        "import trackmaker_tpu_torch.phy.decoder, trackmaker_tpu_torch.parallel.stream\n"
        "import trackmaker_tpu_torch.phy.spec_decode, trackmaker_tpu_torch.tools.health\n"
        "print(run.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
