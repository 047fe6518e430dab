#!/bin/bash
# Full product loop on the reference's real 1-minute Beethoven mix.
#
# Trains NCSNv1 priors (192 filters) for piano and violin from the mix's
# ground-truth stems, runs BASIS separation on the mix, inverts to audio,
# and scores SDR/SIR/SAR with the built-in BSS-Eval v4.
#
# Usage: bash benchmarks/end_to_end_beethoven.sh /path/to/workdir
set -e
cd "$(dirname "$0")/.."
R=${1:-/tmp/realrun}
SONG=/root/reference/basis_sep_results/beethoven_sonata_1_sep_1min
mkdir -p $R/song $R/piano_src $R/violin_src
cp $SONG/mix.wav $R/song/mix.wav
cp $SONG/gt1.wav $R/song/piano.wav && cp $SONG/gt1.wav $R/piano_src/piano.wav
cp $SONG/gt2.wav $R/song/violin.wav && cp $SONG/gt2.wav $R/violin_src/violin.wav

for src in piano violin; do
    python wav_to_spec.py $R/${src}_src $R/${src}_ds/train --use_dB --tfrecords
    cp -r $R/${src}_ds/train $R/${src}_ds/test
    python train_ncsn.py --dataset $R/${src}_ds --output $R/ncsn_${src} \
        --debug --version v1 --n_filters 192 --num_classes 10 \
        --sigma1 1.0 --sigmaL 0.01 --progression logarithmic \
        --n_epochs 300 --batch_size 8 --T 1
done

python run_basis_sep.py $R/ncsn_piano $R/ncsn_violin --output $R/basis \
    --debug --dataset melspec --song_dir $R/song --model_type ncsn \
    --version v1 --n_mixed 28 --T 100 --sigma1 1.0 --sigmaL 0.01 \
    --num_classes 10 --progression logarithmic --n_filters 192

python melspec_inversion_basis.py $R/basis --debug --algorithm reuse_phase \
    --method frame --wiener_filter

python - <<'EOF'
import numpy as np, json
from audiosourcesep_tpu.evaluation import bss_eval, IBM
from audiosourcesep_tpu.data import read_wav
import os
inv = os.environ.get("R", "/tmp/realrun") + \
    "/basis/inverse_reuse_phase_frame_wiener_filter"
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
