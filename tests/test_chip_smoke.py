"""chip_smoke.py's phases at a tiny size on the CPU.

The script itself refuses to run without a GPU; these tests rehearse each
phase (the same functions ``main()`` runs on the card) at tiny widths, so a
wrong path, flag or check shows here before it costs card time.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ONE_DEVICE = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cs.Runner(str(tmp_path_factory.mktemp("smoke")), env=ONE_DEVICE)


@pytest.fixture(scope="module")
def data(run):
    # through the child mechanism main() uses
    return run.child("synthesise", work=run.work,
                     sizes=dataclasses.asdict(cs.TINY))


@pytest.fixture(scope="module")
def ckpts(run, data):
    datasets = cs.phase_featurise(run, data["stems"], cs.TINY.overlap)
    return cs.phase_train(run, datasets, cs.TINY)


@pytest.fixture(scope="module")
def seps(run, data, ckpts):
    return cs.phase_separate(run, ckpts, data["song"], cs.TINY)


def test_synthesise(data):
    from audiosourcesep_tpu.data import read_wav
    for name in ("mix", "piano", "violin"):
        audio, sr = read_wav(os.path.join(data["song"], f"{name}.wav"))
        assert sr == 16000 and len(audio) == int(16000 * cs.TINY.seconds)
    for inst in cs.SOURCES:
        assert os.path.exists(os.path.join(data["stems"], inst,
                                           f"{inst}.wav"))


def test_featurise_and_train(ckpts):
    for inst in cs.SOURCES:
        got = ckpts[inst]
        assert np.isfinite(got["train_loss"]) and got["save_s"] >= 0
        assert os.path.exists(os.path.join(got["path"], "ckpts",
                                           "checkpoint.json"))


def test_separate(seps):
    for dtype in ("f32", "bf16"):
        res = cs.load_results(seps[dtype], cs.TINY.n_mixed)
        assert res["x1"].shape == (cs.TINY.n_mixed, 96, 64)


def test_invert_and_score(run, seps):
    got = cs.phase_invert(run, seps["f32"], cs.TINY)
    assert len(got["sdr"]) == 2 and all(np.isfinite(got["sdr"]))


def test_numerics():
    got = cs.phase_numerics(dataclasses.asdict(cs.TINY))
    assert got["tf32"]["rel_l2"] <= cs.TOL_TF32
    assert got["bf16"]["rel_l2"] <= cs.TOL_BF16


def test_flow_prior():
    got = cs.phase_flow(dataclasses.asdict(cs.TINY))
    assert np.isfinite(got["loss"]) and got["score_rel_l2"] <= \
        cs.TOL_FLOW_SCORE
    assert set(got["memory"]) == {str(cs.TINY.glow_chunk), "None"}


def test_failed_check_raises():
    with pytest.raises(AssertionError, match="bad thing"):
        cs.check(False, "bad thing")


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_main_refuses_cpu():
    r = _run_script(cs.__file__, os.path.dirname(cs.__file__))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def test_main_fails_without_the_repo(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    r = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_numerics_full_width(gpu):
    got = cs.phase_numerics(dataclasses.asdict(cs.FULL))
    assert json.dumps(got)
