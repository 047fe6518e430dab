"""Utility tests: hyperparameter techniques, summaries, profiling,
parallel helpers."""

import io
import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiosourcesep_tpu.parallel import (make_mesh_for_batch,
                                         pad_to_multiple)
from audiosourcesep_tpu.utils import (PhaseTimer, max_pairwise_distance,
                                      print_summary, technique1_sigma1,
                                      technique2_gamma, technique4_epsilon,
                                      total_trainable_variables, trace)


class TestHparams:
    def test_max_pairwise_distance_matches_bruteforce(self):
        rng = np.random.RandomState(0)
        X = rng.randn(50, 7).astype(np.float32)
        got = max_pairwise_distance(X, block=16)
        best = max(np.linalg.norm(a - b)
                   for i, a in enumerate(X) for b in X[i + 1:])
        np.testing.assert_allclose(got, best, rtol=1e-4)

    def test_technique1_rescales(self):
        # two points at the scale extremes -> distance = sqrt(D) after
        # rescale to [0, 1]
        X = np.stack([np.full((4, 4), -100.0), np.full((4, 4), 20.0)])
        s1 = technique1_sigma1(X, minval=-100.0, maxval=20.0)
        np.testing.assert_allclose(s1, 4.0, rtol=1e-5)

    def test_technique2_root_properties(self):
        # gamma solves Phi(sqrt(2D)(g-1)+3g) - Phi(sqrt(2D)(g-1)-3g) = 0.5
        from scipy import stats
        D = 96 * 64
        gamma, n = technique2_gamma(D, 55.0, 0.01, verbose=False)
        assert 0.5 < gamma < 1.0
        val = (stats.norm.cdf(np.sqrt(2 * D) * (gamma - 1) + 3 * gamma)
               - stats.norm.cdf(np.sqrt(2 * D) * (gamma - 1) - 3 * gamma))
        np.testing.assert_allclose(val, 0.5, atol=1e-6)
        assert n > 0

    def test_technique4_epsilon_positive(self):
        gamma, _ = technique2_gamma(96 * 64, 55.0, 0.01, verbose=False)
        eps = technique4_epsilon(5.0, 0.01, gamma, verbose=False)
        assert eps > 0


class TestSummary:
    def test_counts(self):
        params = {"a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros(5)}}
        assert total_trainable_variables(params) == 17
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_summary(params)
        assert "17" in buf.getvalue()


class TestProfiling:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        assert set(t.totals) == {"a", "b"}
        assert "a:" in t.summary()

    def test_trace_noop(self):
        with trace(None):
            x = jnp.ones(3) + 1
        assert float(x[0]) == 2.0

    def test_steady_state_harness(self):
        from audiosourcesep_tpu.utils.profiling import steady_state
        calls = []

        def run(v):
            calls.append(v)
            return v * 2

        first, best, out = steady_state(run, 21, reps=3)
        assert calls == [21] * 4          # 1 first call + 3 reps
        assert out == 42
        assert first >= 0 and best >= 0


class TestParallelHelpers:
    def test_pad_to_multiple(self):
        assert pad_to_multiple(30, 8) == 32
        assert pad_to_multiple(32, 8) == 32
        assert pad_to_multiple(1, 8) == 8

    def test_mesh_for_batch_divisor(self):
        mesh = make_mesh_for_batch(6)  # 8 devices, 6 % 8 != 0 -> 6 devices
        assert mesh is not None
        assert mesh.devices.size in (2, 3, 6)
        assert 6 % mesh.devices.size == 0

    def test_mesh_for_batch_prime(self):
        assert make_mesh_for_batch(7) is None or \
            7 % make_mesh_for_batch(7).devices.size == 0

    def test_mesh_for_batch_one(self):
        assert make_mesh_for_batch(1) is None


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".yml"))


class TestFlatConfig:
    @pytest.mark.parametrize("name", CONFIGS)
    def test_matches_yaml_safe_load(self, name):
        yaml = pytest.importorskip("yaml")
        from audiosourcesep_tpu.training import read_flat_config
        path = os.path.join(REPO, "configs", name)
        with open(path) as f:
            expected = yaml.safe_load(f)
        got = read_flat_config(path)
        assert got == expected
        assert {k: type(v) for k, v in got.items()} == \
            {k: type(v) for k, v in expected.items()}

    def test_rejects_nested_config(self, tmp_path):
        from audiosourcesep_tpu.training import read_flat_config
        cfg = tmp_path / "nested.yml"
        cfg.write_text("model:\n  n_filters: 4\n")
        with pytest.raises(ValueError, match="flat"):
            read_flat_config(str(cfg))


def _cache_dir_seen(cwd, **env_extra):
    """jax's compilation cache dir after importing the package in a fresh
    interpreter started in ``cwd``."""
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    if "JAX_COMPILATION_CACHE_DIR" not in env_extra:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", "import audiosourcesep_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


class TestCompilationCache:
    def test_env_dir_is_used_and_not_overridden(self, tmp_path):
        want = str(tmp_path / "cache_from_env")
        assert _cache_dir_seen(str(tmp_path),
                               JAX_COMPILATION_CACHE_DIR=want) == want

    def test_falls_back_to_fixed_dir_in_checkout(self, tmp_path):
        want = os.path.join(REPO, ".jax_cache")
        assert _cache_dir_seen(str(tmp_path)) == want
        assert _cache_dir_seen(REPO) == want


class TestMultihostArgs:
    def test_coordinator_arguments_are_required(self):
        from audiosourcesep_tpu.parallel import init_distributed
        with pytest.raises(ValueError, match="coordinator_address"):
            init_distributed(None, None, None)
        with pytest.raises(ValueError, match="process_id"):
            init_distributed("localhost:1234", 2, None)


class TestCliHelpers:
    def test_config_override_keeps_run_flags(self, tmp_path):
        import argparse
        from audiosourcesep_tpu.cli import apply_config_override
        cfg = tmp_path / "c.yml"
        cfg.write_text("n_filters: 99\nbatch_size: 7\nscale: 'dB'\n")
        args = argparse.Namespace(config=str(cfg), dataset="mydata",
                                  output="out", debug=True, restore=None,
                                  n_filters=1, batch_size=1)
        new = apply_config_override(args)
        assert new.n_filters == 99 and new.batch_size == 7
        assert new.dataset == "mydata" and new.output == "out"
        assert new.debug is True

    def test_config_none_passthrough(self):
        import argparse
        from audiosourcesep_tpu.cli import apply_config_override
        args = argparse.Namespace(config=None, x=1)
        assert apply_config_override(args) is args
