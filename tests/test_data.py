"""Data pipeline tests: wav IO, TFRecord interop with TensorFlow, loaders."""

import os

import numpy as np
import pytest

from audiosourcesep_tpu.data import (ArrayDataset, load_tf_records,
                                     load_wav, masked_crc32c, parse_example,
                                     read_wav, resample, save_tf_records,
                                     serialize_example, write_wav)


class TestWav:
    def test_roundtrip_pcm16(self, tmp_path):
        rng = np.random.RandomState(0)
        x = (rng.rand(16000).astype(np.float32) - 0.5) * 0.9
        p = str(tmp_path / "a.wav")
        write_wav(p, x, 16000)
        y, sr = read_wav(p)
        assert sr == 16000
        np.testing.assert_allclose(y, x, atol=1.0 / 32768)

    def test_roundtrip_float32(self, tmp_path):
        x = np.linspace(-1, 1, 1000).astype(np.float32)
        p = str(tmp_path / "f.wav")
        write_wav(p, x, 8000, subtype="float32")
        y, sr = read_wav(p)
        np.testing.assert_allclose(y, x, atol=1e-7)

    def test_stereo_to_mono(self, tmp_path):
        x = np.stack([np.ones(100), -np.ones(100)], axis=1).astype(
            np.float32) * 0.5
        p = str(tmp_path / "s.wav")
        write_wav(p, x, 8000)
        y, _ = read_wav(p, mono=True)
        np.testing.assert_allclose(y, 0.0, atol=1e-4)

    def test_reads_reference_wav(self):
        ref = ("/root/reference/basis_sep_results/"
               "beethoven_sonata_1_sep_1min/mix.wav")
        if not os.path.exists(ref):
            pytest.skip("reference artifact not available")
        x, sr = read_wav(ref)
        assert sr == 16000
        assert x.shape == (967680,)
        assert np.abs(x).max() <= 1.0

    def _write_extensible(self, path, payload, sub_format, bits, sr=8000):
        """Hand-build a WAVE_FORMAT_EXTENSIBLE mono file."""
        import struct
        guid = struct.pack("<IHH", sub_format, 0, 0x0010) \
            + b"\x80\x00\x00\xAA\x00\x38\x9B\x71"
        ext = struct.pack("<HHI", 22, bits, 0x4) + guid
        fmt_body = struct.pack("<HHIIHH", 0xFFFE, 1, sr, sr * bits // 8,
                               bits // 8, bits) + ext
        with open(path, "wb") as f:
            f.write(b"RIFF")
            f.write(struct.pack("<I", 4 + 8 + len(fmt_body) + 8
                                + len(payload)))
            f.write(b"WAVEfmt ")
            f.write(struct.pack("<I", len(fmt_body)))
            f.write(fmt_body)
            f.write(b"data")
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)

    def test_extensible_int32_pcm(self, tmp_path):
        """32-bit integer PCM in an extensible container must decode via
        the SubFormat GUID, not be misread as float32."""
        x = np.linspace(-0.5, 0.5, 64).astype(np.float64)
        ints = np.round(x * 2147483647).astype("<i4")
        p = str(tmp_path / "ext_i32.wav")
        self._write_extensible(p, ints.tobytes(), sub_format=1, bits=32)
        y, sr = read_wav(p)
        assert sr == 8000
        np.testing.assert_allclose(y, x, atol=1e-6)

    def test_extensible_float32(self, tmp_path):
        x = np.linspace(-1, 1, 32).astype("<f4")
        p = str(tmp_path / "ext_f32.wav")
        self._write_extensible(p, x.tobytes(), sub_format=3, bits=32)
        y, _ = read_wav(p)
        np.testing.assert_allclose(y, x, atol=1e-7)

    def test_extensible_unknown_subformat_raises(self, tmp_path):
        p = str(tmp_path / "ext_bad.wav")
        self._write_extensible(p, b"\x00" * 8, sub_format=6, bits=8)
        with pytest.raises(ValueError, match="sub-format"):
            read_wav(p)

    def test_resample(self):
        t = np.arange(8000) / 8000.0
        x = np.sin(2 * np.pi * 100 * t).astype(np.float32)
        y = resample(x, 8000, 16000)
        assert abs(len(y) - 16000) <= 1
        t2 = np.arange(len(y)) / 16000.0
        expected = np.sin(2 * np.pi * 100 * t2)
        np.testing.assert_allclose(y[100:-100], expected[100:-100],
                                   atol=1e-2)

    def test_load_wav_windows(self, tmp_path):
        x = np.zeros(36000, np.float32)
        p = str(tmp_path / "w.wav")
        write_wav(p, x, 16000)
        windows, rate = load_wav(p, 2.04)
        assert rate == 16000
        assert windows.shape == (1, 32640)


class TestTFRecord:
    def test_crc32c_known_value(self):
        # RFC 3720 test vector: crc32c of 32 zero bytes = 0x8a9136aa;
        # masked = rot15 + 0xa282ead8
        crc = 0x8A9136AA
        masked = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        assert masked_crc32c(b"\x00" * 32) == masked

    def test_roundtrip_shapes(self, tmp_path):
        rng = np.random.RandomState(1)
        arrays = [rng.randn(7).astype(np.float32),
                  rng.randn(5, 3).astype(np.float32),
                  rng.randn(2, 4, 6).astype(np.float32)]
        p = str(tmp_path / "t.tfrecord")
        n = save_tf_records(arrays, p)
        assert n == 3
        out = load_tf_records([p])
        assert len(out) == 3
        for a, b in zip(arrays, out):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6)

    def test_tensorflow_can_read_ours(self, tmp_path):
        tf = pytest.importorskip("tensorflow")
        rng = np.random.RandomState(2)
        arrays = [rng.randn(4, 3).astype(np.float32)]
        p = str(tmp_path / "interop.tfrecord")
        save_tf_records(arrays, p)
        ds = tf.data.TFRecordDataset([p])
        feature_description = {
            "array": tf.io.FixedLenSequenceFeature([], tf.float32,
                                                   allow_missing=True),
            "shape": tf.io.FixedLenSequenceFeature([], tf.int64,
                                                   allow_missing=True),
        }
        for raw in ds:
            ex = tf.io.parse_single_example(raw, feature_description)
            arr = tf.reshape(ex["array"], ex["shape"]).numpy()
            np.testing.assert_allclose(arr, arrays[0], rtol=1e-6)

    def test_we_can_read_tensorflows(self, tmp_path):
        tf = pytest.importorskip("tensorflow")
        rng = np.random.RandomState(3)
        arr = rng.randn(3, 5).astype(np.float32)
        feature = {
            "array": tf.train.Feature(float_list=tf.train.FloatList(
                value=arr.reshape(-1))),
            "shape": tf.train.Feature(int64_list=tf.train.Int64List(
                value=list(arr.shape))),
        }
        ex = tf.train.Example(
            features=tf.train.Features(feature=feature)).SerializeToString()
        p = str(tmp_path / "tf.tfrecord")
        with tf.io.TFRecordWriter(p) as w:
            w.write(ex)
        out = load_tf_records([p])
        np.testing.assert_allclose(out[0], arr, rtol=1e-6)

    def test_parse_serialize_inverse(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        np.testing.assert_allclose(parse_example(serialize_example(a)), a)


class TestArrayDataset:
    def test_batching_drops_remainder(self):
        ds = ArrayDataset(np.arange(10), batch_size=3, shuffle=False)
        batches = list(ds)
        assert len(batches) == 3
        np.testing.assert_array_equal(np.concatenate(batches),
                                      np.arange(9))

    def test_shuffle_deterministic_per_seed(self):
        d1 = list(ArrayDataset(np.arange(10), 5, True, seed=42))
        d2 = list(ArrayDataset(np.arange(10), 5, True, seed=42))
        np.testing.assert_array_equal(d1[0], d2[0])

    def test_host_sharding(self):
        data = np.arange(8)
        s0 = ArrayDataset(data, None, False, num_hosts=2, host_id=0)
        s1 = ArrayDataset(data, None, False, num_hosts=2, host_id=1)
        np.testing.assert_array_equal(np.sort(np.concatenate(
            [s0.data, s1.data])), data)

    def test_n_global_is_preshard_count(self):
        # TB step axes and epoch accounting follow the reference's GLOBAL
        # convention; per-host shards must still report the global count
        data = np.arange(17)
        for h in (0, 1):
            ds = ArrayDataset(data, 4, False, num_hosts=2, host_id=h)
            assert ds.n_global == 17
            assert ds.n_examples == 8
        single = ArrayDataset(data, 4, False)
        assert single.n_global == single.n_examples == 17

    def test_host_shards_truncated_to_equal_size(self):
        # indivisible split (17 examples, 2 hosts): shards differing by one
        # example can give hosts different BATCH counts -> one host enters
        # the SPMD collective alone (distributed deadlock). Every host must
        # therefore see exactly n // num_hosts examples and the same
        # number of batches.
        data = np.arange(17)
        shards = [ArrayDataset(data, 4, False, num_hosts=2, host_id=h)
                  for h in (0, 1)]
        assert [s.n_examples for s in shards] == [8, 8]
        assert len(shards[0]) == len(shards[1]) == 2
        # shards stay disjoint
        assert not set(shards[0].data) & set(shards[1].data)


class TestOverlappingWindows:
    def test_load_wav_hop(self, tmp_path):
        x = np.arange(48000, dtype=np.float32) / 48000
        p = str(tmp_path / "w.wav")
        write_wav(p, x * 0.5, 16000)
        full, _ = load_wav(p, 1.0)
        assert full.shape == (3, 16000)
        overlapped, _ = load_wav(p, 1.0, hop_sec=0.5)
        assert overlapped.shape == (5, 16000)
        # second window starts half-way through the first
        np.testing.assert_allclose(overlapped[1, 0], full[0, 8000],
                                   atol=1e-4)


class TestGetSongExtract:
    def test_db_path_matches_librosa_power_to_db(self, tmp_path):
        """The separation input must reproduce librosa.power_to_db's
        per-window top_db=80 floor before the [dbmin, dbmax] clip
        (reference data_loader.py:161-164)."""
        from audiosourcesep_tpu.data import get_song_extract
        from audiosourcesep_tpu.ops import mel_filterbank
        from tests.test_ops import numpy_librosa_stft

        sr, length_sec = 16000, 0.128
        n_fft, hop, n_mels = 512, 128, 32
        rng = np.random.RandomState(7)
        # a tonal window whose max mel power sits around -7 dB: the top_db
        # floor (window max - 80 dB ~ -87 dB) binds above dbmin=-100
        t = np.arange(int(sr * length_sec * 5)) / sr
        paths = []
        for i, freq in enumerate((440.0, 880.0, 1320.0)):
            x = (0.3 * np.sin(2 * np.pi * freq * t)
                 + 1e-5 * rng.randn(len(t))).astype(np.float32)
            p = str(tmp_path / f"s{i}.wav")
            write_wav(p, x, sr, subtype="float32")
            paths.append(p)

        duration = length_sec * 2  # 2 windows after skip_frames=2
        mel_spec, _, _ = get_song_extract(
            paths[0], paths[1], paths[2], duration, length_sec=length_sec,
            sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
            fmin=50.0, fmax=7000.0, use_dB=True)

        fb = mel_filterbank(sr, n_fft, n_mels, 50.0, 7000.0)
        L = int(sr * length_sec)
        for si, p in enumerate(paths):
            x, _ = read_wav(p)
            for w in range(2):
                window = x[(2 + w) * L:(3 + w) * L]
                spec = numpy_librosa_stft(np.asarray(window, np.float32),
                                          n_fft, hop)
                power = fb @ (np.abs(spec) ** 2)
                # numpy restatement of librosa.power_to_db(ref=1.0,
                # amin=1e-10, top_db=80.0) on one window
                log_spec = 10.0 * np.log10(np.maximum(power, 1e-10))
                log_spec = np.maximum(log_spec, log_spec.max() - 80.0)
                expected = np.clip(log_spec, -100.0, 20.0)
                got = np.asarray(mel_spec[si][w, ..., 0])
                np.testing.assert_allclose(got, expected, rtol=1e-3,
                                           atol=2e-3)
                # the floor must actually bind here — this is the case the
                # round-1 code got wrong (it floored at dbmin=-100)
                assert expected.min() > -99.0
                assert expected.min() == pytest.approx(
                    expected.max() - 80.0, abs=1e-3)


    def test_mixture_stft_is_complex_and_exact(self, tmp_path):
        """The mixture STFT comes back as one complex array, equal to the
        STFT of the mix windows (no real/imag split on the way)."""
        from audiosourcesep_tpu.data import get_song_extract, write_song
        from audiosourcesep_tpu.ops import stft
        song = write_song(str(tmp_path), 10.0, seed=3)
        _, raw, stft_mix = get_song_extract(
            *(os.path.join(song, f"{n}.wav") for n in
              ("mix", "piano", "violin")), 2 * 2.04)
        assert isinstance(stft_mix, np.ndarray)
        assert stft_mix.dtype == np.complex64 and stft_mix.shape[0] == 2
        windows = raw[0].reshape(2, -1)
        np.testing.assert_array_equal(stft_mix, np.asarray(stft(windows)))
        assert np.abs(stft_mix.imag).max() > 0


class TestCorruptionDetection:
    def test_bad_crc_raises(self, tmp_path):
        p = str(tmp_path / "c.tfrecord")
        save_tf_records([np.ones(4, np.float32)], p)
        data = bytearray(open(p, "rb").read())
        data[-6] ^= 0xFF  # flip a payload byte
        open(p, "wb").write(bytes(data))
        with pytest.raises(ValueError, match="corrupt"):
            load_tf_records([p])
