"""Audio op parity tests: STFT/mel vs independent references.

librosa is not installed in this image, so librosa-parity is checked against
a direct numpy re-statement of its documented conventions (reflect-pad
centred framing, periodic Hann, rfft, slaney mel); the tf.signal path is
checked against TensorFlow itself (installed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiosourcesep_tpu.ops import (db_limits_to_power, db_to_power,
                                    frame_signal, griffin_lim, hann_window,
                                    istft, linear_to_mel_weight_matrix,
                                    mel_filterbank, mel_to_audio,
                                    mel_to_stft, melspectrogram,
                                    melspectrogram_tf_signal,
                                    phase_reuse, power_to_db,
                                    single_channel_wiener_filter, stft)


def numpy_librosa_stft(x, n_fft, hop):
    """Independent restatement of librosa.stft defaults."""
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    xp = np.pad(x, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    out = np.empty((n_fft // 2 + 1, n_frames), np.complex128)
    for t in range(n_frames):
        seg = xp[t * hop: t * hop + n_fft] * w
        out[:, t] = np.fft.rfft(seg)
    return out


class TestSTFT:
    def test_matches_librosa_conventions(self):
        rng = np.random.RandomState(0)
        x = rng.randn(4096).astype(np.float32)
        ours = np.asarray(stft(jnp.asarray(x), n_fft=512, hop_length=128))
        ref = numpy_librosa_stft(x, 512, 128)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=2e-3)

    def test_batched(self):
        rng = np.random.RandomState(1)
        x = rng.randn(3, 2048).astype(np.float32)
        out = stft(jnp.asarray(x), n_fft=512, hop_length=128)
        assert out.shape == (3, 257, 17)
        single = stft(jnp.asarray(x[1]), n_fft=512, hop_length=128)
        np.testing.assert_allclose(np.asarray(out[1]), np.asarray(single),
                                   atol=1e-5)

    def test_istft_roundtrip(self):
        rng = np.random.RandomState(2)
        x = rng.randn(2, 4096).astype(np.float32)
        spec = stft(jnp.asarray(x), n_fft=512, hop_length=128)
        rec = istft(spec, n_fft=512, hop_length=128, length=4096)
        np.testing.assert_allclose(np.asarray(rec), x, atol=1e-3)

    def test_frame_signal(self):
        x = jnp.arange(10.0)
        f = frame_signal(x, 4, 2)
        assert f.shape == (4, 4)
        np.testing.assert_allclose(np.asarray(f[1]), [2, 3, 4, 5])


class TestMelFilterbank:
    def test_slaney_properties(self):
        fb = mel_filterbank(16000, 2048, 96, 125.0, 7600.0)
        assert fb.shape == (96, 1025)
        assert (fb >= 0).all()
        # slaney-normalised filters: each filter integrates to ~2/width;
        # peak of each triangle is positive and interior
        assert (fb.max(axis=1) > 0).all()
        # frequencies outside [fmin, fmax] get (almost) no weight
        freqs = np.linspace(0, 8000, 1025)
        outside = (freqs < 100) | (freqs > 7800)
        assert fb[:, outside].max() < 1e-6

    def test_htk_matrix_matches_tensorflow(self):
        tf = pytest.importorskip("tensorflow")
        ours = linear_to_mel_weight_matrix(64, 1025, 16000.0, 0.0, 8000.0)
        theirs = tf.signal.linear_to_mel_weight_matrix(
            num_mel_bins=64, num_spectrogram_bins=1025, sample_rate=16000,
            lower_edge_hertz=0.0, upper_edge_hertz=8000.0).numpy()
        # float32 edge rounding puts a couple of bins on triangle boundaries
        np.testing.assert_allclose(ours, theirs, atol=5e-4)

    def test_db_conversions(self):
        S = jnp.asarray([1e-12, 1.0, 100.0])
        db = power_to_db(S, top_db=None)
        np.testing.assert_allclose(np.asarray(db), [-100.0, 0.0, 20.0],
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(db_to_power(db)),
                                   [1e-10, 1.0, 100.0], rtol=1e-4)
        # top_db clamps relative to max
        db2 = power_to_db(S, top_db=60.0)
        np.testing.assert_allclose(np.asarray(db2), [-40.0, 0.0, 20.0],
                                   atol=1e-4)

    def test_db_limits_to_power(self):
        pmin, pmax = db_limits_to_power(-100.0, 20.0)
        np.testing.assert_allclose([pmin, pmax], [1e-10, 100.0], rtol=1e-6)


class TestMelspectrogram:
    def test_shapes_and_clip(self):
        rng = np.random.RandomState(3)
        audio = rng.randn(5, 32640).astype(np.float32) * 0.1
        m = melspectrogram(jnp.asarray(audio), use_dB=True)
        assert m.shape == (5, 96, 64)
        assert float(m.min()) >= -100.0 - 1e-4
        assert float(m.max()) <= 20.0 + 1e-4

    def test_matches_manual_pipeline(self):
        rng = np.random.RandomState(4)
        audio = rng.randn(2048).astype(np.float32)
        m = melspectrogram(jnp.asarray(audio), sr=16000, n_fft=512,
                           hop_length=128, n_mels=32, fmin=50.0,
                           fmax=7000.0, use_dB=False)
        spec = numpy_librosa_stft(audio, 512, 128)
        power = np.abs(spec) ** 2
        fb = mel_filterbank(16000, 512, 32, 50.0, 7000.0)
        ref = fb @ power
        pmin, pmax = db_limits_to_power(-100.0, 20.0)
        ref = np.clip(ref, pmin, pmax)
        np.testing.assert_allclose(np.asarray(m), ref, rtol=1e-3, atol=1e-5)

    def test_tf_signal_path_matches_tensorflow(self):
        tf = pytest.importorskip("tensorflow")
        rng = np.random.RandomState(5)
        audio = rng.randn(2, 4000).astype(np.float32)
        ours = melspectrogram_tf_signal(jnp.asarray(audio), sr=16000,
                                        frame_length=1024, n_fft=1024,
                                        hop_length=256, n_mels=40)
        s = tf.signal.stft(audio, frame_length=1024, frame_step=256,
                           fft_length=1024,
                           window_fn=tf.signal.hann_window, pad_end=True)
        p = tf.cast(tf.abs(s) ** 2, tf.float32)
        A = tf.signal.linear_to_mel_weight_matrix(
            num_mel_bins=40, num_spectrogram_bins=513, sample_rate=16000,
            lower_edge_hertz=0.0, upper_edge_hertz=8000.0)
        ref = tf.matmul(p, A).numpy()
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=2e-2,
                                   atol=1e-3)


class TestInversion:
    def test_mel_to_stft_nnls_residual(self):
        rng = np.random.RandomState(6)
        mag_true = np.abs(rng.randn(513, 8)).astype(np.float32)
        fb = mel_filterbank(16000, 1024, 64, 125.0, 7600.0)
        mel = jnp.asarray(fb @ (mag_true ** 2))
        mag_rec = mel_to_stft(mel, sr=16000, n_fft=1024, n_iter=400)
        # reprojection should match the observed mel spec closely
        mel_rec = fb @ np.asarray(mag_rec) ** 2
        err = np.linalg.norm(mel_rec - np.asarray(mel)) / np.linalg.norm(
            np.asarray(mel))
        assert err < 0.05, err

    def test_griffin_lim_reconstructs_sinusoid(self):
        t = np.arange(8192) / 16000.0
        x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
        mag = jnp.abs(stft(jnp.asarray(x), n_fft=1024, hop_length=256))
        rec = np.asarray(griffin_lim(mag, jax.random.PRNGKey(0), n_fft=1024,
                                     hop_length=256, n_iter=50, length=8192))
        # compare magnitude spectrograms (phase-invariant criterion)
        mag_rec = np.abs(np.asarray(stft(jnp.asarray(rec), n_fft=1024,
                                         hop_length=256)))
        err = np.linalg.norm(mag_rec - np.asarray(mag)) / np.linalg.norm(
            np.asarray(mag))
        assert err < 0.15, err

    def test_wiener_filter_partition_of_mixture(self):
        rng = np.random.RandomState(7)
        psd = jnp.asarray(np.abs(rng.randn(2, 5, 4)).astype(np.float32))
        mix = jnp.asarray((rng.randn(5, 4) + 1j * rng.randn(5, 4)
                           ).astype(np.complex64))
        est = single_channel_wiener_filter(psd, mix)
        np.testing.assert_allclose(np.asarray(est.sum(axis=0)),
                                   np.asarray(mix), rtol=1e-4, atol=1e-5)

    def test_phase_reuse_preserves_magnitude(self):
        rng = np.random.RandomState(8)
        mag = jnp.asarray(np.abs(rng.randn(5, 4)).astype(np.float32))
        mix = jnp.asarray((rng.randn(5, 4) + 1j * rng.randn(5, 4)
                           ).astype(np.complex64))
        est = phase_reuse(mag, mix)
        np.testing.assert_allclose(np.abs(np.asarray(est)), np.asarray(mag),
                                   rtol=1e-4)


class TestInversionCLI:
    def test_runs_on_the_default_device(self, tmp_path, monkeypatch):
        """melspec_inversion_basis.py leaves the platform alone and hands
        the complex mixture STFT to the default device as one array."""
        import argparse
        import sys
        sys.path.insert(0, ".")
        import melspec_inversion_basis as inv

        rng = np.random.RandomState(0)
        mel = rng.uniform(-80, 0, (1, 96, 64)).astype(np.float32)
        stft_mix = (rng.randn(1, 1025, 64)
                    + 1j * rng.randn(1, 1025, 64)).astype(np.complex64)
        np.savez(tmp_path / "results.npz", x1=mel, x2=mel, gt1=mel,
                 gt2=mel, mixed=mel, stft_mixture=stft_mix)
        seen = []
        real = inv.invert_melspec_reuse_phase

        def spy(mels, stft_mixture, **kw):
            seen.append(stft_mixture)
            return real(mels, stft_mixture, **kw)

        monkeypatch.setattr(inv, "invert_melspec_reuse_phase", spy)
        monkeypatch.chdir(tmp_path)
        platforms = jax.config.jax_platforms
        inv.main(argparse.Namespace(
            basis_results=str(tmp_path), output=None,
            algorithm="reuse_phase", method="frame", scale="dB",
            wiener_filter=True, debug=True, seed=0))
        assert jax.config.jax_platforms == platforms
        assert seen and all(isinstance(a, jax.Array) for a in seen)
        assert all(a.dtype == jnp.complex64 for a in seen)
        assert all(a.devices() == {jax.devices()[0]} for a in seen)
        out = np.load(tmp_path / "inverse_reuse_phase_frame_wiener_filter"
                      / "inverse_spectrograms.npz")
        assert np.isfinite(out["x1_audio"]).all()
