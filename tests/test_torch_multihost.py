"""The port's multi-process decode: two processes of
``python -m trackmaker_tpu_torch.tools.multihost_dryrun`` over gloo on the
CPU (4 CPU shards each), as tests/test_multihost.py runs the JAX dry run.
Each process's frames (start, sequence, payload) equal the JAX package's
exact scan of the same captures, rebuilt here by the tool's own function.
Both processes are killed if either runs past its time limit."""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy.decoder import decode_capture as jax_decode_capture
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.tools import multihost_dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dp_decode():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trackmaker_tpu_torch.tools.multihost_dryrun",
         f"127.0.0.1:{port}", "2", str(pid), "--cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the dry run did not end within {TIMEOUT_S} s")
    enc = PhyEncoder(PhyConfig(), device="cpu")
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} rc {p.returncode}\n{err[-2000:]}"
        got = json.loads(out.strip().splitlines()[-1])
        assert got["pid"] == pid and got["ok"] and got["devices"] == ["cpu"] * 4
        want_payloads, caps = multihost_dryrun.small_captures(enc, pid)
        for r, row in enumerate(got["frames"]):
            res = jax_decode_capture(JaxPhyConfig(), jnp.asarray(caps[r]), 2, max_frames=4)
            valid = np.asarray(res.valid)
            fb, ln = np.asarray(res.frame_bytes), np.asarray(res.length)
            want = [[int(np.asarray(res.start)[k]), int(np.asarray(res.sequence)[k]),
                     fb[k, 7:7 + ln[k]].tobytes().hex()] for k in np.nonzero(valid)[0]]
            assert row == want, (pid, r)
            assert [bytes.fromhex(h) for _, _, h in row] == want_payloads[r]


def test_mismatched_shapes_raise():
    """A process whose captures differ in shape from the others' raises in
    every process (the shape check before the decode)."""
    script = (
        "import sys, torch\n"
        "from trackmaker_tpu_torch.core.config import PhyConfig\n"
        "from trackmaker_tpu_torch.parallel import multihost\n"
        "pid = int(sys.argv[2])\n"
        "multihost.init_distributed(sys.argv[1], 2, pid)\n"
        "x = torch.zeros((2 + pid, 1000))\n"
        "try:\n"
        "    multihost.decode_captures_multihost(PhyConfig(), x, 2, devices=['cpu'])\n"
        "except ValueError as exc:\n"
        "    print('raised', exc)\n"
        "multihost.finalize_distributed()\n")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", script, f"127.0.0.1:{port}", str(pid)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the shape check did not end within {TIMEOUT_S} s")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "raised the processes' captures differ in shape" in out, out + err[-2000:]
    assert torch.distributed.is_available()
