"""Smoke tests: the benchmark entrypoints stay runnable."""

import json
import sys

import numpy as np


class TestBenchSmoke:
    def test_bench_main_tiny(self, capsys, monkeypatch):
        sys.path.insert(0, ".")
        import bench
        monkeypatch.setattr(bench, "T", 1)
        monkeypatch.setattr(bench, "NUM_CLASSES", 2)
        monkeypatch.setattr(bench, "N_FILTERS", 4)
        monkeypatch.setattr(bench, "N_FRAMES", 2)
        bench.main()
        line = capsys.readouterr().out.strip().splitlines()[-1]
        out = json.loads(line)
        assert out["metric"] == "basis_separation_1min_mix_wallclock"
        assert out["value"] > 0 and out["vs_baseline"] > 0
        assert out["device"] == {"platform": "cpu", "kind": "cpu",
                                 "count": 8}

    def test_profile_v2_dispatch_tiny(self, capsys, monkeypatch):
        sys.path.insert(0, ".")
        from benchmarks import profile_v2_dispatch as pvd
        monkeypatch.setattr(pvd, "T", 1)
        monkeypatch.setattr(pvd, "NUM_CLASSES", 3)
        monkeypatch.setattr(pvd, "N_FILTERS", 4)
        monkeypatch.setattr(pvd, "N_FRAMES", 2)
        pvd.main()
        line = capsys.readouterr().out.strip().splitlines()[-1]
        out = json.loads(line)
        assert out["metric"] == "ncsnv2_L200_T8_anneal"
        assert out["per_level_s"] > 0 and out["fused_s"] > 0

    def test_quality_flowpp_digits_tiny(self, capsys, monkeypatch,
                                        tmp_path):
        sys.path.insert(0, ".")
        # tiny synthetic cache so the script runs without the digits cache
        rs = np.random.RandomState(0)
        path = str(tmp_path / "mnist.npz")
        np.savez(path,
                 x_train=rs.randint(0, 256, (32, 28, 28)).astype(np.uint8),
                 x_test=rs.randint(0, 256, (8, 28, 28)).astype(np.uint8))
        monkeypatch.setenv("ASR_MNIST_NPZ", path)
        from benchmarks import quality_flowpp_digits as qf
        monkeypatch.setattr(qf, "BATCH", 8)
        monkeypatch.setattr(qf, "N_COMPONENTS", 2)
        monkeypatch.setattr(qf, "N_BLOCKS_FLOW", 1)
        monkeypatch.setattr(qf, "N_BLOCKS_DEQUANT", 1)
        monkeypatch.setattr(qf, "FILTERS", 8)
        monkeypatch.setattr(qf, "EVAL_DRAWS", 1)
        qf.main(n_epochs=1)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        out = json.loads(line)
        assert out["metric"] == "flowpp_bits_dim_digits_cache"
        assert np.isfinite(out["value"])

    def test_probe_glow_sep_memory_tiny(self, capsys):
        sys.path.insert(0, ".")
        from benchmarks import probe_glow_sep_memory as pm
        pm.main(remat=False, chunk=2, tiny=True)
        out = capsys.readouterr().out
        assert "peak(args+temp)" in out

    def test_bench_image_basis_tiny(self):
        sys.path.insert(0, ".")
        from benchmarks import bench_image_basis as bib
        orig = bib.N_FILTERS, bib.NUM_CLASSES
        try:
            bib.N_FILTERS, bib.NUM_CLASSES = 4, 2
            first, best = bib.time_variant(2, 1, None)
            assert first > 0 and best > 0
        finally:
            bib.N_FILTERS, bib.NUM_CLASSES = orig

    def test_profile_conv_tiny(self, capsys):
        sys.path.insert(0, ".")
        from benchmarks import profile_conv as pc
        pc.main(classes=(("tiny", 2, 8, 8, 4, 8),), short=1, long=3)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["class"] == "tiny" and out["device"]["platform"] == "cpu"

    def test_graft_entry(self):
        sys.path.insert(0, ".")
        import __graft_entry__ as g
        import jax
        fn, args = g.entry()
        # trace-only check (full compile covered by the driver)
        jax.eval_shape(fn, *args)
