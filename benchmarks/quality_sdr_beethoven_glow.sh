#!/bin/bash
# Glow-prior quality loop on the reference's 1-minute Beethoven mix:
# per-instrument base Glow (melspec_glow.yml scale: L=3, K=40, 512
# filters, learntop, dB, no logit) -> noisy-Glow sigma-chained fine-tuning
# -> Glow-prior BASIS -> phase-reuse + Wiener inversion -> BSS-Eval SDR.
#
# Schedule convention (docs/DESIGN.md, benchmarks/basis_image_psnr.py):
# Glow priors separate in DATA scale (their SpecPreprocessing bijector
# rescales internally), so the reference's [0,1]-scale Langevin schedule
# (sigma in [0.01, 1], step_lr 2e-5) maps to the dB span 120 as
# sigma x 120 (-> [1.2, 120], also used for the noisy fine-tuning) and
# step_lr x 120^2 (-> 0.288) — an exact invariance of the BASIS update.
# The reference's own glow-melspec branch never ran as written
# (run_basis_sep.py:386-390 NameError), so this fixes no shipped
# convention.
#
# Data caveat: identical to quality_sdr_beethoven.sh — the priors train on
# the mix's own stems (first 48 s), the best achievable data scale here.
#
# Learning rate: adamax 1e-3 — the config default and the recipe that
# reached -43 bits/dim on this same 8x-overlap piano split in round 2
# (quality_glow_piano.sh). A 1e-4 attempt (round 4) never recovered from
# an epoch-126 loss jump (train stuck ~1.7e3 nats, val diverged to 1e24);
# the image-scale "1e-4 for stability" finding (quality_glow_mnist.sh)
# does NOT transfer to the dB melspec scale. --clipnorm 1000 guards the
# jump excursions themselves (generous: typical healthy grad norms here
# are O(1e2); the reference only snapshots on jumps, train_glow.py:127-140).
#
# Usage: bash benchmarks/quality_sdr_beethoven_glow.sh /path/workdir \
#            [base_epochs] [epochs_per_sigma]
set -e
cd "$(dirname "$0")/.."
R=${1:-/tmp/qg}
EPOCHS=${2:-600}
SIGMA_EPOCHS=${3:-20}
SONG=/root/reference/basis_sep_results/beethoven_sonata_1_sep_1min
GLOW_HP="--L 3 --K 40 --n_filters 512 --learntop --optimizer adamax
         --learning_rate 0.001 --clipnorm 1000 --batch_size 32 --scale dB"
SIG="--sigma1 120.0 --sigmaL 1.2 --num_classes 10 --progression logarithmic"

# ---- per-instrument datasets (same split recipe as the NCSN runners) ----
for inst in piano violin; do
    gt=gt1; [ "$inst" = violin ] && gt=gt2
    if [ ! -d "$R/${inst}_ds/train" ]; then
        mkdir -p $R/${inst}_train_src $R/${inst}_test_src
        INST=$inst GT=$gt python - "$SONG" "$R" <<'EOF'
import os, sys
from audiosourcesep_tpu.data import read_wav, write_wav
song, r = sys.argv[1], sys.argv[2]
inst, gt = os.environ["INST"], os.environ["GT"]
audio, sr = read_wav(f"{song}/{gt}.wav")
cut = int(48.0 * sr)
write_wav(f"{r}/{inst}_train_src/{inst}_train.wav", audio[:cut], sr)
write_wav(f"{r}/{inst}_test_src/{inst}_test.wav", audio[cut:], sr)
EOF
        python wav_to_spec.py $R/${inst}_train_src \
            $R/${inst}_ds/train --use_dB --tfrecords --overlap 0.875
        python wav_to_spec.py $R/${inst}_test_src \
            $R/${inst}_ds/test --use_dB --tfrecords
    fi

    # base Glow + noisy sigma chain
    if [ ! -f "$R/glow_$inst/ckpts/checkpoint.json" ]; then
        python train_glow.py --dataset $R/${inst}_ds \
            --output $R/glow_$inst --debug --n_epochs $EPOCHS $GLOW_HP
    fi
    if [ ! -f "$R/noisy_glow_$inst/sigma_1.2/ckpts/checkpoint.json" ]; then
        python train_noisy_glow.py $R/glow_$inst --dataset $R/${inst}_ds \
            --output $R/noisy_glow_$inst --debug --reinit_actnorm \
            --n_epochs $SIGMA_EPOCHS $GLOW_HP $SIG
    fi
done

# ---- separation (glow priors run in dB data scale) -----------------------
mkdir -p $R/song
cp $SONG/mix.wav $R/song/mix.wav
cp $SONG/gt1.wav $R/song/piano.wav
cp $SONG/gt2.wav $R/song/violin.wav

python run_basis_sep.py $R/noisy_glow_piano $R/noisy_glow_violin \
    --output $R/basis --debug --dataset melspec --song_dir $R/song \
    --model_type glow --scale dB --n_mixed 28 --T 100 \
    --step_lr 0.288 --score_clip 5.0 \
    $SIG --L 3 --K 40 --n_filters 512 --learntop

# ---- inversion + SDR (same protocol as quality_sdr_beethoven.sh) ---------
python melspec_inversion_basis.py $R/basis --debug \
    --algorithm reuse_phase --method frame --wiener_filter

R=$R python - <<'EOF'
import numpy as np, json, os
from audiosourcesep_tpu.evaluation import bss_eval
from audiosourcesep_tpu.data import read_wav
inv = os.environ["R"] + "/basis/inverse_reuse_phase_frame_wiener_filter"
est1, _ = read_wav(f"{inv}/sep1.wav"); est2, _ = read_wav(f"{inv}/sep2.wav")
gt1, _ = read_wav(f"{inv}/gt1.wav"); gt2, _ = read_wav(f"{inv}/gt2.wav")
n = min(map(len, (est1, est2, gt1, gt2)))
refs = np.stack([gt1[:n], gt2[:n]])[:, :, None]
ests = np.stack([est1[:n], est2[:n]])[:, :, None]
sdr, isr, sir, sar, _ = bss_eval(refs, ests, window=np.inf, hop=np.inf,
                                 compute_permutation=True)
print(json.dumps({
    "prior": "glow",
    "sdr": [round(float(np.nanmean(sdr[i])), 2) for i in range(2)],
    "sir": [round(float(np.nanmean(sir[i])), 2) for i in range(2)],
    "sar": [round(float(np.nanmean(sar[i])), 2) for i in range(2)]}))
EOF
