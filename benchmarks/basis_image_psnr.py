#!/usr/bin/env python
"""BASIS image-mixture separation PSNR (thesis Table 3.2 analog).

Trains a prior on the image/toy dataset through the real CLIs, runs BASIS
on ``--n_mixed`` mixed pairs, and reports mean PSNR of the recovered
sources (best per-pair permutation), the metric of thesis Table 3.2
(MNIST: Glow prior 21.2 dB / NCSN prior 28.5 dB over 1000 pairs).

``--prior ncsn`` (default) trains an NCSNv1 score prior. ``--prior glow``
exercises the full flow-prior chain: base Glow -> noisy-Glow sigma-chained
fine-tuning (train_noisy_glow.py) -> Glow-prior BASIS (score =
grad log_prob through the flow, per-level param stacks). Glow separates in
DATA scale (its preprocessing bijector rescales internally, see
run_basis_sep.py), so the Langevin schedule is the scale-equivalent of the
reference's [0,1] one: sigmas and the noisy-training sigmas scale by the
256 data span, step_lr by its square (exact invariance of the BASIS
update; the reference glow branch never ran as written so it fixes no
convention). The affine (no-logit) image preprocessing is used: the logit
variant's domain (0,256) cannot absorb sigma-scale noise or an
unconstrained Langevin iterate.

With the offline digits stand-in cache (scripts/build_mnist_cache.py
--synthetic-digits) the number is NOT comparable to the MNIST baselines —
it evidences the pipeline; run against a real mnist.npz for parity.

Usage: python benchmarks/basis_image_psnr.py /path/workdir [--n_mixed 20]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


DEVICE = "cpu"


LOG_DIR = None   # set by main(); child stdout/stderr stream here


def run(script, *args, env_extra=None):
    env = dict(os.environ)
    if DEVICE == "cpu":
        # force, don't setdefault: an exported JAX_PLATFORMS would
        # otherwise send children to another platform
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)   # the real accelerator
    env.update(env_extra or {})
    # stream child output to a per-step log (these steps run for hours at
    # full scale; buffering in memory hides all progress)
    log_path = os.path.join(LOG_DIR or "/tmp",
                            os.path.basename(script) + ".log")
    with open(log_path, "a") as log:
        log.write(f"\n==== {script} {' '.join(args)}\n")
        log.flush()
        r = subprocess.run([sys.executable, os.path.join(REPO, script),
                            *args], cwd=REPO, env=env, stdout=log,
                           stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        with open(log_path) as log:
            sys.stderr.write(log.read()[-4000:] + "\n")
        raise SystemExit(f"{script} failed (full log: {log_path})")
    return r


def psnr_pairs(x1, x2, gt1, gt2, peak=255.0):
    """Mean PSNR over pairs, best per-pair source permutation."""
    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2,
                      axis=tuple(range(1, a.ndim)))
        return 10 * np.log10(peak ** 2 / np.maximum(mse, 1e-12))

    direct = (psnr(x1, gt1) + psnr(x2, gt2)) / 2
    swapped = (psnr(x1, gt2) + psnr(x2, gt1)) / 2
    return np.maximum(direct, swapped)


SPAN = 256.0   # image data span: sigmas scale by SPAN, step_lr by SPAN^2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--prior", choices=["ncsn", "glow"], default="ncsn")
    ap.add_argument("--n_mixed", type=int, default=20)
    ap.add_argument("--n_filters", type=int, default=64,
                    help="NCSN filters (--prior ncsn)")
    ap.add_argument("--n_epochs", type=int, default=60,
                    help="NCSN training epochs (--prior ncsn)")
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--glow_K", type=int, default=16)
    ap.add_argument("--glow_L", type=int, default=3)
    ap.add_argument("--glow_filters", type=int, default=256)
    ap.add_argument("--glow_epochs", type=int, default=120,
                    help="base Glow training epochs (--prior glow)")
    ap.add_argument("--glow_epochs_per_sigma", type=int, default=10,
                    help="noisy-Glow fine-tune epochs per noise level")
    ap.add_argument("--glow_batch", type=int, default=256,
                    help="Glow train batch; smaller -> more optimizer "
                         "steps per epoch on a small corpus (the sigma "
                         "chain needs thousands of steps per level to "
                         "recalibrate, see docs/DESIGN.md)")
    ap.add_argument("--device", choices=["cpu", "native"], default="cpu",
                    help="cpu: force JAX_PLATFORMS=cpu in the child CLIs; "
                         "native: let them use the real accelerator")
    args = ap.parse_args()
    global DEVICE
    DEVICE = args.device

    w = os.path.abspath(args.workdir)
    os.makedirs(w, exist_ok=True)
    global LOG_DIR
    LOG_DIR = w
    if args.prior == "glow":
        # adamax 1e-3 (reference default) explodes on the first step at
        # this scale (see quality_glow_mnist.sh); 1e-4 trains monotonically
        glow_hp = ["--L", str(args.glow_L), "--K", str(args.glow_K),
                   "--n_filters", str(args.glow_filters), "--learntop",
                   "--optimizer", "adamax", "--learning_rate", "0.0001",
                   "--batch_size", str(args.glow_batch)]
        sig = ["--sigma1", str(SPAN * 1.0), "--sigmaL", str(SPAN * 0.01),
               "--num_classes", "10", "--progression", "logarithmic"]
        base = os.path.join(w, "glow_image")
        if not os.path.exists(os.path.join(base, "ckpts",
                                           "checkpoint.json")):
            run("train_glow.py", "--dataset", "mnist", "--output", base,
                "--debug", "--n_epochs", str(args.glow_epochs), *glow_hp)
        prior = os.path.join(w, "noisy_glow_image")
        if not os.path.exists(os.path.join(
                prior, f"sigma_{round(SPAN * 0.01, 2)}", "ckpts",
                "checkpoint.json")):
            run("train_noisy_glow.py", base, "--dataset", "mnist",
                "--output", prior, "--debug", "--reinit_actnorm",
                "--n_epochs", str(args.glow_epochs_per_sigma),
                *glow_hp, *sig)
        sep = os.path.join(w, "basis_sep_glow")
        # --score_clip: bound scores at the ideal smoothed-score scale
        # (+-5/sigma). An under-fine-tuned sigma chain produces scores
        # orders of magnitude above it and NaNs the Langevin in the first
        # level (measured; see docs/DESIGN.md); for an adequately trained
        # chain the clip is inactive.
        run("run_basis_sep.py", prior, prior, "--output", sep, "--debug",
            "--dataset", "mnist", "--model_type", "glow",
            "--L", str(args.glow_L), "--K", str(args.glow_K),
            "--n_filters", str(args.glow_filters), "--learntop",
            "--T", str(args.T), "--step_lr", str(2e-5 * SPAN * SPAN),
            "--score_clip", "5.0",
            # full-batch VJP fits at 32x32 image scale (~3 GiB residuals);
            # the melspec-scale --score_chunk default would only serialise
            "--score_chunk", "0",
            "--n_mixed", str(args.n_mixed), *sig)
    else:
        prior = os.path.join(w, "ncsn_image")
        if not os.path.exists(os.path.join(prior, "ckpts",
                                           "checkpoint.json")):
            run("train_ncsn.py", "--dataset", "mnist", "--output", prior,
                "--debug", "--version", "v1", "--n_filters",
                str(args.n_filters), "--num_classes", "10",
                "--sigma1", "1.0", "--sigmaL", "0.01",
                "--progression", "logarithmic", "--n_epochs",
                str(args.n_epochs), "--batch_size", "64", "--T", "1",
                "--sample_every", "10000", "--ema")

        sep = os.path.join(w, "basis_sep")
        run("run_basis_sep.py", prior, prior, "--output", sep, "--debug",
            "--dataset", "mnist", "--model_type", "ncsn", "--version", "v1",
            "--n_filters", str(args.n_filters), "--num_classes", "10",
            "--sigma1", "1.0", "--sigmaL", "0.01",
            "--progression", "logarithmic", "--T", str(args.T),
            "--n_mixed", str(args.n_mixed), "--ema")

    res = np.load(os.path.join(sep, "results.npz"))
    x1, x2 = res["x1"], res["x2"]
    gt1 = np.round(np.clip(res["gt1"], 0, 255))
    gt2 = np.round(np.clip(res["gt2"], 0, 255))
    p = psnr_pairs(x1, x2, gt1, gt2)
    mix_psnr = psnr_pairs(res["mixed"], res["mixed"], gt1, gt2)

    cache = os.environ.get("ASR_MNIST_NPZ",
                           os.path.expanduser("~/.keras/datasets/mnist.npz"))
    prov = "unknown"
    try:
        with np.load(cache) as d:
            prov = str(d.get("provenance", "mnist-unverified"))
    except Exception:
        pass
    print(json.dumps({
        "metric": "basis_image_separation_psnr",
        "prior": args.prior,
        "value": round(float(np.mean(p)), 2),
        "unit": "dB",
        "n_pairs": int(len(p)),
        "mixture_psnr": round(float(np.mean(mix_psnr)), 2),
        "dataset_provenance": prov,
        "mnist_baselines_dB": {"glow": 21.2, "ncsn": 28.5},
    }))


if __name__ == "__main__":
    main()
