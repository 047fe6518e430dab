#!/bin/bash
# NCSN quality-parity run on the available piano data (VERDICT.md round-1
# item 3b): train NCSNv1 at config scale (melspec_ncsnv1.yml: 192 filters,
# batch 32, sigma in [0.01, 1], 10 levels) and record the val-loss
# trajectory against the reference's best val ~362 / Table 3.5's ~343
# (trained_ncsn/ncsn_piano_192_32_dB_custom_loop/out.log).
#
# Data reality: the only piano audio in this environment is the 60 s
# ground-truth stem of the reference's separation demo. The reference
# trained on 4,863 patches of full recordings; here the train split is the
# first 48 s (windows augmented 8x by overlap) and the val split the last
# ~12 s — so val numbers are data-limited, not architecture-limited.
#
# Usage: bash benchmarks/quality_ncsn_piano.sh /path/to/workdir [n_epochs]
set -e
cd "$(dirname "$0")/.."
R=${1:-/tmp/quality_ncsn}
EPOCHS=${2:-3000}
SONG=/root/reference/basis_sep_results/beethoven_sonata_1_sep_1min

mkdir -p $R/train_src $R/test_src
python - "$SONG" "$R" <<'EOF'
import sys
from audiosourcesep_tpu.data import read_wav, write_wav
song, r = sys.argv[1], sys.argv[2]
audio, sr = read_wav(f"{song}/gt1.wav")
cut = int(48.0 * sr)
write_wav(f"{r}/train_src/piano_train.wav", audio[:cut], sr)
write_wav(f"{r}/test_src/piano_test.wav", audio[cut:], sr)
print(f"split {len(audio)/sr:.1f}s piano at 48s (sr={sr})")
EOF

# 8x overlap augmentation on train only (test windows stay disjoint)
python wav_to_spec.py $R/train_src $R/ds/train --use_dB --tfrecords \
    --overlap 0.875
python wav_to_spec.py $R/test_src $R/ds/test --use_dB --tfrecords

python train_ncsn.py --dataset $R/ds --output $R/ncsn_piano_192_32_dB \
    --debug --version v1 --n_filters 192 --num_classes 10 \
    --sigma1 1.0 --sigmaL 0.01 --progression logarithmic \
    --n_epochs $EPOCHS --batch_size 32 --T 100 --sample_every 1000 --ema

grep "Epoch" $R/ncsn_piano_192_32_dB/out.log | tail -20
