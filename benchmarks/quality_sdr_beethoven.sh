#!/bin/bash
# Full quality loop on the reference's 1-minute Beethoven mix with
# config-scale NCSNv1 priors (192 filters, batch 32, 8x overlap-augmented
# training, EMA weights served): violin prior training, BASIS separation,
# phase-reuse + Wiener inversion, BSS-Eval SDR.
#
# Run benchmarks/quality_ncsn_piano.sh first (builds the piano prior and
# the train/test split machinery this mirrors for violin).
#
# Data caveat (recorded with the results): the only training audio in this
# environment is the mix's own ground-truth stems, so the priors see the
# first 48 s of the same performance they then separate — the reference
# instead trained on separate corpora (4,863 piano patches). SDR here
# measures the pipeline at the best achievable data scale, not blind
# generalisation.
#
# Usage: bash benchmarks/quality_sdr_beethoven.sh /path/workdir [n_epochs]
set -e
cd "$(dirname "$0")/.."
R=${1:-/tmp/qn}
EPOCHS=${2:-3000}
SONG=/root/reference/basis_sep_results/beethoven_sonata_1_sep_1min

# ---- violin prior (same recipe as the piano one) -------------------------
if [ ! -d "$R/ncsn_violin_192_32_dB/ckpts" ]; then
    mkdir -p $R/violin_train_src $R/violin_test_src
    python - "$SONG" "$R" <<'EOF'
import sys
from audiosourcesep_tpu.data import read_wav, write_wav
song, r = sys.argv[1], sys.argv[2]
audio, sr = read_wav(f"{song}/gt2.wav")
cut = int(48.0 * sr)
write_wav(f"{r}/violin_train_src/violin_train.wav", audio[:cut], sr)
write_wav(f"{r}/violin_test_src/violin_test.wav", audio[cut:], sr)
EOF
    python wav_to_spec.py $R/violin_train_src \
        $R/violin_ds/train --use_dB --tfrecords --overlap 0.875
    python wav_to_spec.py $R/violin_test_src \
        $R/violin_ds/test --use_dB --tfrecords
    python train_ncsn.py --dataset $R/violin_ds \
        --output $R/ncsn_violin_192_32_dB --debug --version v1 \
        --n_filters 192 --num_classes 10 --sigma1 1.0 --sigmaL 0.01 \
        --progression logarithmic --n_epochs $EPOCHS --batch_size 32 \
        --T 100 --sample_every 1000 --ema
fi

# ---- separation (EMA priors, bf16 fast path) -----------------------------
mkdir -p $R/song
cp $SONG/mix.wav $R/song/mix.wav
cp $SONG/gt1.wav $R/song/piano.wav
cp $SONG/gt2.wav $R/song/violin.wav

python run_basis_sep.py $R/ncsn_piano_192_32_dB $R/ncsn_violin_192_32_dB \
    --output $R/basis --debug --dataset melspec --song_dir $R/song \
    --model_type ncsn --version v1 --n_mixed 28 --T 100 --sigma1 1.0 \
    --sigmaL 0.01 --num_classes 10 --progression logarithmic \
    --n_filters 192 --ema --compute_dtype bf16

# ---- inversion + SDR -----------------------------------------------------
python melspec_inversion_basis.py $R/basis --debug \
    --algorithm reuse_phase --method frame --wiener_filter

R=$R python - <<'EOF'
import numpy as np, json, os
from audiosourcesep_tpu.evaluation import bss_eval, IBM
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
    "sdr": [round(float(np.nanmean(sdr[i])), 2) for i in range(2)],
    "sir": [round(float(np.nanmean(sir[i])), 2) for i in range(2)],
    "sar": [round(float(np.nanmean(sar[i])), 2) for i in range(2)]}))
EOF
