"""Multi-host data-parallel training: a real 2-process jax.distributed
cluster on CPU (2 virtual devices per process -> 4 global devices).

Validates the multi-process story end to end through the actual CLI: cluster
formation (``--multihost``), per-host dataset sharding, global-batch
assembly (``put_global_batch``), replicated-state training steps with
XLA-inserted gradient psum across processes, and process-0-only checkpoint
writes. The reference has no multi-host at all (SURVEY.md §2: single host
``MirroredStrategy``); this extends it.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tiny_melspec_ds(tmp_path_factory):
    from audiosourcesep_tpu.data import save_tf_records

    root = tmp_path_factory.mktemp("mh_ds")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("test", 4)):
        d = root / split
        d.mkdir()
        arrays = [rng.uniform(-100, 20, size=(16, 8)).astype(np.float32)
                  for _ in range(n)]
        save_tf_records(arrays, str(d / "piano.tfrecord"))
    return str(root)


def test_two_process_training(tiny_melspec_ds, tmp_path):
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp_path / f"proc{pid}")
        outs.append(out)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "train_ncsn.py"),
             "--dataset", tiny_melspec_ds, "--output", out,
             "--n_filters", "2", "--num_classes", "2", "--n_epochs", "2",
             "--batch_size", "4", "--T", "1", "--version", "v1",
             "--multihost", "--coordinator_address", f"localhost:{port}",
             "--num_processes", "2", "--process_id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, env=env))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-3000:]}"

    def epoch_lines(out_dir):
        with open(os.path.join(out_dir, "out.log")) as f:
            return [l.strip() for l in f if l.startswith("Epoch ")]

    # train_ncsn validates every 10 epochs (reference cadence,
    # /root/reference/train_ncsn.py:130) plus the final epoch — a 2-epoch
    # run therefore logs exactly ONE epoch line (epoch 2)
    lines0, lines1 = epoch_lines(outs[0]), epoch_lines(outs[1])
    assert len(lines0) == 1 and lines0 == lines1, (lines0, lines1)
    # losses must be real numbers (the psum'd global loss, not nan)
    assert "nan" not in lines0[0].lower()

    # only process 0 writes checkpoints
    assert os.path.exists(os.path.join(outs[0], "ckpts", "checkpoint.json"))
    assert not os.path.exists(os.path.join(outs[1], "ckpts",
                                           "checkpoint.json"))

    # the init banner prints before stdout redirects to out.log, so it is
    # in the captured subprocess stdout
    assert "process 0 of 2, 4 global devices" in logs[0]
    assert "process 1 of 2, 4 global devices" in logs[1]
