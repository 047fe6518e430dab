#!/usr/bin/env python
"""Drive the NCSN train -> separate -> invert path once on a GPU and check it.

Runs the repo's own CLIs at the widths of ``configs/melspec_ncsnv1.yml``
(192 filters, 96x64x1 patches, 10 noise levels, batch 32) with random
initial weights and seeded synthetic audio:

  0. device     nvidia-smi's name and power limit; JAX's platform, kind and
                device count. Anything but a GPU stops the run.
  1. synthesise seeded piano-like and violin-like stems and their mix.
  2. featurise  ``wav_to_spec.py --use_dB --tfrecords``, train and test.
  3. train      ``train_ncsn.py`` per instrument, a few steps with EMA.
  4. separate   ``run_basis_sep.py`` over a 30-frame mix with Griffin-Lim
                inversion, in f32 and in bf16.
  5. invert     ``melspec_inversion_basis.py --algorithm reuse_phase
                --wiener_filter``, then BSS-Eval of the separated wavs.
  6. numerics   the NCSNv1 forward at [30, 96, 64, 1] in f32 at default
                precision (TF32 on the card) and in bf16, each against f32
                under matmul precision "highest".
  7. flow prior the Glow prior at ``configs/melspec_glow.yml`` widths: one
                train step, one separation level with and without frame
                chunking (with their compiled memory analyses), and one
                score against ``jax.grad`` of ``log_prob`` at "highest".

``--four`` runs only what exists across cards, each compared with the same
seeds on one card: data-parallel ``train_ncsn.py`` (first-step loss), and
``run_basis_sep.py`` with the frame-sharded mesh and with
``--shard_sources`` on the 2x2 (source, data) mesh.

Process model: this process never imports JAX. Each phase that touches the
card runs in its own child, one at a time, because a JAX process reserves
most of a card's memory when it starts: the CLIs as subprocesses, the
in-process phases as ``chip_smoke.py --child NAME``. A failed phase ends the
run with a non-zero exit. Only when every phase passed is the last line of
stdout ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage (repo root, GPU machine): ``python chip_smoke.py [--four]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("piano", "violin")
SEED = 0
RAW_WINDOW, INVERTED_WINDOW = 32640, 32256   # samples per window at 16 kHz

# Tolerances, each relative L2 error ||y - ref|| / ||ref|| unless stated.
# TF32 keeps 10 mantissa bits (unit roundoff 2^-11 ~ 4.9e-4); a conv output
# sums ~1.7e3 products and the NCSN forward chains ~10 such conv stages, so
# rounding compounds to ~1e-2 at worst.
TOL_TF32 = 1e-2
# bf16 keeps 7 mantissa bits (unit roundoff 2^-8 ~ 3.9e-3) in the convs;
# norm statistics stay f32, so the same ~10-deep cascade lands near 3e-2.
TOL_BF16 = 3e-2
# The flow score is jax.grad through 3 x 40 Glow steps whose coupling nets
# run in TF32; the affine couplings start near identity, so the error grows
# far less than linearly in depth. 2e-2 bounds it.
TOL_FLOW_SCORE = 2e-2
# Chunked and whole-batch flow scores differ only in how XLA schedules the
# same per-frame math (frames are independent), so f32 reduction order and
# TF32 algorithm choice are all that separate them.
TOL_CHUNK = 1e-2
# Across card counts the four-card phase pins matmul precision to "highest"
# (plain f32), so only the order of f32 reductions differs: the gradient
# all-reduce in training, per-device batch sizes in the convs. 1e-3 is ten
# times what f32 reordering through 20 Langevin steps should show, and far
# below the O(1) error a wrong source or frame assignment gives.
TOL_LAYOUT = 1e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What every phase works on; ``FULL`` on the card, ``TINY`` in tests."""
    seconds: float        # audio length; >= (n_mixed + 2) windows of 2.04 s
    n_filters: int
    num_classes: int
    batch_size: int
    n_epochs: int
    overlap: float        # train-split window overlap: a few batches
    n_mixed: int          # frames separated (30 = the 1-minute mix)
    T: int                # Langevin steps per noise level
    glow_L: int
    glow_K: int
    glow_filters: int
    glow_batch: int
    glow_frames: int
    glow_chunk: int
    glow_ref_frames: int
    four_n_mixed: int     # divides by 4 and 2: no padded frames on a mesh


FULL = Sizes(seconds=68.0, n_filters=192, num_classes=10, batch_size=32,
             n_epochs=1, overlap=0.75, n_mixed=30, T=5, glow_L=3, glow_K=40,
             glow_filters=512, glow_batch=8, glow_frames=28, glow_chunk=8,
             glow_ref_frames=2, four_n_mixed=28)
TINY = Sizes(seconds=12.5, n_filters=4, num_classes=2, batch_size=4,
             n_epochs=1, overlap=0.0, n_mixed=2, T=2, glow_L=2, glow_K=1,
             glow_filters=4, glow_batch=2, glow_frames=4, glow_chunk=3,
             glow_ref_frames=2, four_n_mixed=4)


class Runner:
    """Runs the CLIs and child phases one process at a time in ``work``,
    echoing child phases' output and keeping every process's log."""

    def __init__(self, work: str, env: dict | None = None,
                 timeout: float = 1100.0):
        self.work = work
        self.env = dict(os.environ, **(env or {}))
        self.timeout = timeout
        self.n = 0
        os.makedirs(os.path.join(work, "logs"), exist_ok=True)

    def _run(self, cmd, name, env):
        self.n += 1
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=self.work, capture_output=True,
                              text=True, timeout=self.timeout,
                              env=dict(self.env, **(env or {})))
        seconds = time.time() - t0
        log = os.path.join(self.work, "logs", f"{self.n:02d}_{name}.log")
        with open(log, "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name} exited {proc.returncode} after {seconds:.1f} s\n"
                f"--- stdout (tail) ---\n{proc.stdout[-3000:]}\n"
                f"--- stderr (tail) ---\n{proc.stderr[-3000:]}")
        return proc.stdout, seconds

    def cli(self, script, *args, env=None):
        """Run ``script`` (repo root) with ``args``; ``(stdout, seconds)``."""
        name = os.path.splitext(script)[0]
        return self._run([sys.executable, os.path.join(REPO, script),
                          *map(str, args)], name, env)

    def child(self, phase, env=None, **kwargs):
        """Run one in-process phase in a child; returns its result dict."""
        out, _ = self._run([sys.executable, os.path.abspath(__file__),
                            "--child", phase, "--kwargs", json.dumps(kwargs)],
                           phase, env)
        lines = out.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        return json.loads(lines[-1])


def rel_l2(y, ref) -> float:
    import numpy as np
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / max(np.linalg.norm(ref), 1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def report(phase: str, **values) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


# ---------------------------------------------------------------------------
# in-process phases (run in a child on the card; called directly in tests)
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    """Phase 0: the card's name and power limit, and what JAX reports."""
    from audiosourcesep_tpu.utils.profiling import device_report, nvidia_smi
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    device = device_report()
    report("0 device", **device)
    return device


def phase_synthesise(work: str, sizes: dict) -> dict:
    """Phase 1: the song (mix + stems) and one training dir per stem."""
    from audiosourcesep_tpu.data import write_song
    sizes = Sizes(**sizes)
    song = write_song(os.path.join(work, "song"), sizes.seconds, seed=SEED)
    for inst in SOURCES:
        d = os.path.join(work, "stems", inst)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(song, f"{inst}.wav"), d)
    report("1 synthesise", seconds=sizes.seconds, sr=16000, song=song)
    return {"song": song, "stems": os.path.join(work, "stems")}


def phase_score(sep_wavs: list, truth_wavs: list, n_windows: int) -> dict:
    """Phase 5b: BSS-Eval of the inverted separation against the truth.

    Raw windows are 32640 samples, inverted ones hop*(frames-1) = 32256:
    each raw window is cut to the inverted length before scoring."""
    import numpy as np
    from audiosourcesep_tpu.data import read_wav
    from audiosourcesep_tpu.evaluation import bss_eval
    refs, ests = [], []
    for sep, truth in zip(sep_wavs, truth_wavs):
        raw, _ = read_wav(truth)
        est, _ = read_wav(sep)
        refs.append(np.concatenate(
            [raw[k * RAW_WINDOW:k * RAW_WINDOW + INVERTED_WINDOW]
             for k in range(n_windows)]))
        ests.append(est[:n_windows * INVERTED_WINDOW])
    sdr, _, sir, sar, _ = bss_eval(
        np.stack(refs)[:, :, None], np.stack(ests)[:, :, None],
        window=np.inf, hop=np.inf, compute_permutation=False)
    sdr = [float(np.nanmean(s)) for s in sdr]
    report("5 score", sdr_db=sdr, sir_db=[float(np.nanmean(s)) for s in sir],
           sar_db=[float(np.nanmean(s)) for s in sar])
    check(all(math.isfinite(s) for s in sdr), f"non-finite SDR {sdr}")
    return {"sdr": sdr}


def phase_numerics(sizes: dict) -> dict:
    """Phase 6: the NCSNv1 forward at full width three ways."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from audiosourcesep_tpu.models.ncsn import get_score_model, get_sigmas
    sizes = Sizes(**sizes)
    shape = (96, 64, 1)
    sigmas = get_sigmas(1.0, 0.01, sizes.num_classes, "logarithmic")
    k_p, k_x, k_l = jax.random.split(jax.random.PRNGKey(SEED), 3)
    f32 = get_score_model("v1", shape, sizes.n_filters, sizes.num_classes,
                          sigmas=sigmas)
    bf16 = get_score_model("v1", shape, sizes.n_filters, sizes.num_classes,
                           sigmas=sigmas, compute_dtype=jnp.bfloat16)
    params = f32.init_params(k_p)
    x = jax.random.uniform(k_x, (sizes.n_mixed, *shape))
    labels = jax.random.randint(k_l, (sizes.n_mixed,), 0, sizes.num_classes)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(f32.apply)(params, x, labels))
    out = {"tf32": (np.asarray(jax.jit(f32.apply)(params, x, labels)),
                    TOL_TF32),
           "bf16": (np.asarray(jax.jit(bf16.apply)(params, x, labels)),
                    TOL_BF16)}
    result = {}
    for name, (y, tol) in out.items():
        err = rel_l2(y, ref)
        max_abs = float(np.max(np.abs(y - ref)))
        report(f"6 numerics {name}", shape=list(y.shape), max_abs=max_abs,
               rel_l2=err, tol_rel_l2=tol)
        check(y.shape == ref.shape and np.isfinite(y).all(),
              f"{name}: bad output")
        check(err <= tol, f"{name}: rel_l2 {err} > {tol}")
        result[name] = {"max_abs": max_abs, "rel_l2": err}
    return result


def phase_flow(sizes: dict) -> dict:
    """Phase 7: the Glow prior at full width."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from audiosourcesep_tpu.models import build_glow
    from audiosourcesep_tpu.separation import (BasisConfig, glow_score_fn,
                                               make_level_program,
                                               stack_pytrees)
    from audiosourcesep_tpu.training import (init_train_state,
                                             make_flow_train_step,
                                             setup_optimizer)
    sizes = Sizes(**sizes)
    shape = (96, 64, 1)
    k_init, k_batch, k_step, k_x, k_mix, k_sep = jax.random.split(
        jax.random.PRNGKey(SEED), 6)
    batch = jax.random.uniform(k_batch, (sizes.glow_batch, *shape),
                               minval=-100.0, maxval=20.0)
    t0 = time.time()
    model, params = build_glow(
        k_init, batch, shape, L=sizes.glow_L, K=sizes.glow_K,
        n_filters=sizes.glow_filters, learntop=True, data_type="melspec",
        minval=-100.0, maxval=20.0)
    build_s = time.time() - t0
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(params))
    opt = setup_optimizer("adamax", 1e-3)
    step, _ = make_flow_train_step(model, opt)
    # the step donates its state: train a copy, keep ``params`` for below
    state = init_train_state(jax.tree_util.tree_map(jnp.copy, params), opt)
    t0 = time.time()
    state, loss = step(state, batch, k_step)
    loss = float(loss)
    report("7 flow train", params=n_params, batch=sizes.glow_batch,
           loss=loss, build_s=round(build_s, 3),
           step_s=round(time.time() - t0, 3))
    check(math.isfinite(loss), f"flow train loss {loss}")

    # One noise level x 2 Langevin steps over both sources, in data scale,
    # with the freshly initialised flow. Not the stepped one: adamax's first
    # step moves every weight by the full learning rate, zero-initialised
    # coupling outputs included, and the input gradient grows with depth
    # and width (14x after one step at K=40 and 64 filters); at 512 filters
    # the separation came out non-finite on the card.
    p = params
    stacked = stack_pytrees(stack_pytrees(p, p))     # [levels=1, K=2, ...]
    n = sizes.glow_frames
    mixed = jax.random.uniform(k_mix, (n, *shape), minval=-100.0,
                               maxval=20.0)
    x_init = jax.random.uniform(k_x, (2, n, *shape), minval=-100.0,
                                maxval=20.0)
    cfg = BasisConfig(T=2, delta=0.288, data_type="melspec", scale="dB",
                      collect_trajectory=False, score_clip=5.0)
    sigmas = jnp.asarray([1.2])
    outs, memory = {}, {}
    for chunk in (sizes.glow_chunk, None):
        run_level = make_level_program(
            glow_score_fn(model.log_prob, frame_chunk=chunk), sigmas, cfg, n)
        args = (stacked, x_init, mixed, jnp.asarray(0), k_sep)
        t0 = time.time()
        mem = run_level.lower(*args).compile().memory_analysis()
        compile_s = time.time() - t0
        gib = 2.0 ** 30
        memory[str(chunk)] = {
            "argument_gib": mem.argument_size_in_bytes / gib,
            "output_gib": mem.output_size_in_bytes / gib,
            "temp_gib": mem.temp_size_in_bytes / gib}
        t0 = time.time()
        out = np.asarray(run_level(stacked, jnp.copy(x_init), mixed,
                                   jnp.asarray(0), k_sep))
        report("7 flow separate", frame_chunk=chunk, frames=n,
               compile_s=round(compile_s, 3),
               run_s=round(time.time() - t0, 3), **memory[str(chunk)])
        check(np.isfinite(out).all(), f"chunk={chunk}: non-finite output")
        outs[chunk] = out
    err = rel_l2(outs[sizes.glow_chunk], outs[None])
    report("7 flow chunked vs whole", rel_l2=err, tol_rel_l2=TOL_CHUNK)
    check(err <= TOL_CHUNK, f"chunked vs whole: {err} > {TOL_CHUNK}")

    # one score against the plain reference: grad of log_prob at "highest"
    r = sizes.glow_ref_frames
    xs = x_init[:, :r]
    score = np.asarray(glow_score_fn(model.log_prob)(
        stacked, xs, jnp.zeros((r,), jnp.int32), 0))[0]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jax.grad(
            lambda v: jnp.sum(model.log_prob(p, v))))(xs[0]))
    err = rel_l2(score, ref)
    max_abs = float(np.max(np.abs(score - ref)))
    report("7 flow score vs reference", frames=r, max_abs=max_abs,
           rel_l2=err, tol_rel_l2=TOL_FLOW_SCORE)
    check(err <= TOL_FLOW_SCORE, f"flow score: {err} > {TOL_FLOW_SCORE}")
    return {"loss": loss, "memory": memory, "score_rel_l2": err}


CHILD_PHASES = {"device": phase_device, "synthesise": phase_synthesise,
                "score": phase_score, "numerics": phase_numerics,
                "flow": phase_flow}


# ---------------------------------------------------------------------------
# CLI phases (this process only starts them)
# ---------------------------------------------------------------------------

def ncsn_flags(sizes: Sizes):
    return ["--version", "v1", "--n_filters", sizes.n_filters,
            "--num_classes", sizes.num_classes, "--sigma1", 1.0,
            "--sigmaL", 0.01, "--progression", "logarithmic",
            "--height", 96, "--width", 64, "--scale", "dB"]


def phase_featurise(run: Runner, stems: str, overlap: float,
                    env=None) -> dict:
    """Phase 2: train and test splits, one dataset dir per instrument."""
    splits = {"train": ["--overlap", overlap] if overlap else [],
              "test": []}
    for split, extra in splits.items():
        out_dir = os.path.join(run.work, f"spec_{split}")
        _, secs = run.cli("wav_to_spec.py", stems, out_dir, "--use_dB",
                          "--tfrecords", *extra, env=env)
        report("2 featurise", split=split, seconds=round(secs, 3))
        for inst in SOURCES:
            dst = os.path.join(run.work, f"ds_{inst}", split)
            os.makedirs(dst, exist_ok=True)
            shutil.copy(os.path.join(out_dir, f"{inst}.tfrecord"), dst)
    return {inst: os.path.join(run.work, f"ds_{inst}") for inst in SOURCES}


def parse_training(stdout: str) -> dict:
    epoch = re.findall(r"Epoch \d+: Train Loss: (\S+) Val Loss: (\S+)",
                       stdout)
    saves = re.findall(r"Model Saved at \S+ in (\S+) s", stdout)
    peak = re.findall(r"peak_bytes_in_use: (\S+)", stdout)
    check(bool(epoch) and bool(saves) and bool(peak),
          "train_ncsn.py output lacks the loss, save or memory lines")
    return {"train_loss": float(epoch[0][0]), "val_loss": float(epoch[-1][1]),
            "save_s": float(saves[-1]), "peak_bytes_in_use": peak[-1]}


def phase_train(run: Runner, datasets: dict, sizes: Sizes, *extra,
                env=None, tag: str = "") -> dict:
    """Phase 3: one NCSNv1 prior per instrument through train_ncsn.py."""
    ckpts = {}
    for inst, ds in datasets.items():
        out = os.path.join(run.work, f"runs{tag}", inst)
        stdout, secs = run.cli(
            "train_ncsn.py", "--dataset", ds, "--output", out, "--debug",
            "--batch_size", sizes.batch_size, "--n_epochs", sizes.n_epochs,
            "--T", sizes.T, "--ema", "--seed", SEED, *ncsn_flags(sizes),
            *extra, env=env)
        got = parse_training(stdout)
        report(f"3 train {inst}{tag}", wall_s=round(secs, 3), **got)
        check(math.isfinite(got["train_loss"])
              and math.isfinite(got["val_loss"]), f"{inst}: bad loss {got}")
        check(os.path.exists(os.path.join(out, "ckpts", "checkpoint.json")),
              f"{inst}: no checkpoint")
        ckpts[inst] = dict(got, path=out)
    return ckpts


def load_results(sep_dir: str, n_mixed: int) -> dict:
    import numpy as np
    with np.load(os.path.join(sep_dir, "results.npz")) as r:
        res = {k: r[k] for k in r.files}
    for key in ("x1", "x2", "gt1", "gt2", "mixed", "stft_mixture"):
        check(key in res, f"results.npz lacks {key}")
    for key in ("x1", "x2", "gt1", "gt2", "mixed"):
        check(res[key].shape == (n_mixed, 96, 64),
              f"{key} shape {res[key].shape}")
        check(bool(np.isfinite(res[key]).all()), f"{key} not finite")
    check(res["stft_mixture"].dtype.kind == "c", "stft_mixture not complex")
    return res


def separate(run: Runner, restore: tuple, song: str, sizes: Sizes,
             n_mixed: int, out: str, *extra, env=None):
    stdout, secs = run.cli(
        "run_basis_sep.py", *restore, "--output", out, "--debug",
        "--dataset", "melspec", "--song_dir", song, "--model_type", "ncsn",
        "--n_mixed", n_mixed, "--T", sizes.T, "--ema", "--seed", SEED,
        *ncsn_flags(sizes), *extra, env=env)
    duration = re.findall(r"Duration: (\S+) seconds", stdout)
    return load_results(out, n_mixed), secs, float(duration[-1])


def phase_separate(run: Runner, ckpts: dict, song: str, sizes: Sizes,
                   env=None) -> dict:
    """Phase 4: BASIS separation of the mix, f32 and bf16, with inversion."""
    restore = tuple(ckpts[inst]["path"] for inst in SOURCES)
    dirs = {}
    for dtype in ("f32", "bf16"):
        out = os.path.join(run.work, f"sep_{dtype}")
        _, secs, duration = separate(run, restore, song, sizes,
                                     sizes.n_mixed, out, "--inverse",
                                     "--compute_dtype", dtype, env=env)
        for wav in ("sep1.wav", "sep2.wav", "ground_truth1.wav",
                    "ground_truth2.wav"):
            check(os.path.exists(os.path.join(out, wav)), f"no {wav}")
        report(f"4 separate {dtype}", frames=sizes.n_mixed,
               levels=sizes.num_classes, T=sizes.T, anneal_s=duration,
               wall_s=round(secs, 3))
        dirs[dtype] = out
    return dirs


def phase_invert(run: Runner, sep_dir: str, sizes: Sizes, env=None) -> dict:
    """Phase 5: phase-reuse + Wiener inversion, then BSS-Eval (a child)."""
    _, secs = run.cli("melspec_inversion_basis.py", sep_dir, "--debug",
                      "--algorithm", "reuse_phase", "--wiener_filter",
                      env=env)
    inv = os.path.join(sep_dir, "inverse_reuse_phase_frame_wiener_filter")
    report("5 invert", wall_s=round(secs, 3))
    return run.child(
        "score", env=env,
        sep_wavs=[os.path.join(inv, f"sep{i}.wav") for i in (1, 2)],
        truth_wavs=[os.path.join(sep_dir, f"ground_truth{i}.wav")
                    for i in (1, 2)],
        n_windows=sizes.n_mixed)


def device_env(platform: str, n: int) -> dict:
    """Environment that shows a child ``n`` devices of ``platform``."""
    if platform == "gpu":
        return {"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
    return {"XLA_FLAGS": f"--xla_force_host_platform_device_count={n}"}


def phase_four(run: Runner, song: str, stems: str, sizes: Sizes,
               platform: str) -> dict:
    """Data-parallel training and both multi-device separation layouts on
    four devices, each against one device with the same seeds."""
    one = dict(device_env(platform, 1), JAX_DEFAULT_MATMUL_PRECISION="highest")
    four = dict(device_env(platform, 4),
                JAX_DEFAULT_MATMUL_PRECISION="highest")
    # non-overlapping windows: the first epoch is exactly one batch, so its
    # train loss is the first step's; the data is featurised on the host
    datasets = phase_featurise(run, stems, 0.0, env={"JAX_PLATFORMS": "cpu"})
    piano = {"piano": datasets["piano"]}
    # no end-of-run Langevin sampling: it is not what is compared here
    ckpt4 = phase_train(run, piano, sizes, "--sample_every", 0, env=four,
                        tag="_4dev")
    ckpt1 = phase_train(run, piano, sizes, "--sample_every", 0, env=one,
                        tag="_1dev")
    loss4, loss1 = ckpt4["piano"]["train_loss"], ckpt1["piano"]["train_loss"]
    err = abs(loss4 - loss1) / max(abs(loss1), 1e-30)
    report("four train", loss_4dev=loss4, loss_1dev=loss1, rel=err,
           tol=TOL_LAYOUT)
    check(err <= TOL_LAYOUT, f"DP loss {loss4} vs {loss1}")

    restore = (ckpt1["piano"]["path"],) * 2
    n = sizes.four_n_mixed
    ref, _, _ = separate(run, restore, song, sizes, n,
                         os.path.join(run.work, "sep_1dev"),
                         "--compute_dtype", "f32", env=one)
    result = {"train_rel": err}
    for layout, extra in (("frames", ()), ("sources", ("--shard_sources",))):
        got, secs, duration = separate(
            run, restore, song, sizes, n,
            os.path.join(run.work, f"sep_4dev_{layout}"), "--compute_dtype",
            "f32", *extra, env=four)
        errs = [rel_l2(got[k], ref[k]) for k in ("x1", "x2")]
        report(f"four separate {layout}", frames=n, anneal_s=duration,
               rel_l2=errs, tol_rel_l2=TOL_LAYOUT)
        check(max(errs) <= TOL_LAYOUT, f"{layout}: {errs} > {TOL_LAYOUT}")
        result[layout] = errs
    return result


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device phases")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--kwargs", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(CHILD_PHASES[args.child](**json.loads(args.kwargs))))
        return 0

    n_dev = 4 if args.four else 1
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run = Runner(work, env=device_env("gpu", n_dev))
        device = run.child("device")
        if device["platform"] != "gpu" or device["count"] != n_dev:
            print(f"chip_smoke needs {n_dev} GPU(s); JAX found {device}",
                  file=sys.stderr)
            return 1
        sizes = dataclasses.asdict(FULL)
        data = run.child("synthesise", work=work, sizes=sizes)
        if args.four:
            phase_four(run, data["song"], data["stems"], FULL, "gpu")
        else:
            datasets = phase_featurise(run, data["stems"], FULL.overlap)
            ckpts = phase_train(run, datasets, FULL)
            seps = phase_separate(run, ckpts, data["song"], FULL)
            phase_invert(run, seps["f32"], FULL)
            run.child("numerics", sizes=sizes)
            run.child("flow", sizes=sizes)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
