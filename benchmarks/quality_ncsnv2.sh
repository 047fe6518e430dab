#!/bin/bash
# NCSNv2 demo-scale end-to-end loop (round-3 VERDICT missing #4: v2 had
# never been trained/run beyond unit tests): hyperparameter techniques ->
# train v2 priors (melspec_ncsnv2.yml scale: 128 filters, 200 sigma-levels
# in [30, 0.01], T=8, lr 6e-5) -> Langevin sampling -> v2-prior BASIS
# separation (L=200 x T=8 = 3,200 score forwards — 20x the level count of
# the v1 headline run, the per-level-dispatch stress case) -> inversion ->
# BSS-Eval SDR. Reference: score_network_v2.py:202-377 +
# configs/melspec_ncsnv2.yml (the reference ships the config but commits
# no v2 training log either).
#
# Data caveat: same as quality_sdr_beethoven.sh — priors train on the
# mix's own stems (first 48 s), the best achievable data scale here.
#
# EMA note: the shipped config says ema False, but NCSNv2's own paper
# (techniques 1-5) prescribes EMA (technique 3); we train with --ema and
# serve the EMA weights, recording both as the v2 recipe.
#
# Usage: bash benchmarks/quality_ncsnv2.sh /path/workdir [n_epochs]
set -e
cd "$(dirname "$0")/.."
R=${1:-/tmp/qv2}
EPOCHS=${2:-2000}
SONG=/root/reference/basis_sep_results/beethoven_sonata_1_sep_1min
V2_HP="--version v2 --n_filters 128 --num_classes 200 --sigma1 30.0
       --sigmaL 0.01 --progression logarithmic"
V2_TRAIN="--batch_size 32 --learning_rate 0.00006 --optimizer adam"

# ---- per-instrument datasets (same split recipe as the v1 runners) ------
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
done

# ---- hyperparameter techniques (1, 2&4) on the piano corpus --------------
if [ ! -f "$R/piano_ds/max_norm.txt" ]; then
    JAX_PLATFORMS=cpu python technique1_ncsnv2.py $R/piano_ds
fi
cat $R/piano_ds/max_norm.txt
JAX_PLATFORMS=cpu python technique2and4_ncsnv2.py --D 96,64,1 --T 8 \
    --sigma1 30. --sigmaL 0.01 | tee $R/technique2and4.txt

# ---- v2 priors -----------------------------------------------------------
for inst in piano violin; do
    if [ ! -f "$R/ncsnv2_$inst/ckpts/checkpoint.json" ]; then
        python train_ncsn.py --dataset $R/${inst}_ds \
            --output $R/ncsnv2_$inst --debug --n_epochs $EPOCHS \
            --T 8 --sample_every 100000 --ema $V2_HP $V2_TRAIN
    fi
done

# ---- Langevin sampling with the v2 prior ---------------------------------
python ncsn_generate_samples.py $R/ncsnv2_piano --output $R/gen_v2 \
    --debug --dataset melspec --n_samples 16 --T 8 --ema $V2_HP

# ---- v2-prior BASIS separation (L=200, T=8) ------------------------------
mkdir -p $R/song
cp -n $SONG/mix.wav $R/song/mix.wav
cp -n $SONG/gt1.wav $R/song/piano.wav
cp -n $SONG/gt2.wav $R/song/violin.wav

python run_basis_sep.py $R/ncsnv2_piano $R/ncsnv2_violin \
    --output $R/basis --debug --dataset melspec --song_dir $R/song \
    --model_type ncsn --n_mixed 28 --T 8 --step_lr 0.000007 \
    --ema --compute_dtype bf16 $V2_HP
grep -E "Duration" $R/basis/out.log

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
    "prior": "ncsnv2",
    "sdr": [round(float(np.nanmean(sdr[i])), 2) for i in range(2)],
    "sir": [round(float(np.nanmean(sir[i])), 2) for i in range(2)],
    "sar": [round(float(np.nanmean(sar[i])), 2) for i in range(2)]}))
EOF
