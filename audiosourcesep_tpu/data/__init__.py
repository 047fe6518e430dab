from .wav import read_wav, write_wav, resample, load_audio
from .tfrecord import (serialize_example, parse_example, save_tf_records,
                       load_tf_records, write_records, read_records,
                       masked_crc32c)
from .loaders import (ArrayDataset, load_wav, load_multiple_wav,
                      load_melspec_ds, load_toydata, get_mixture_toydata,
                      get_song_extract, save_mel_spectrograms, load_spec,
                      load_spec_tf)
from .synth import synth_stems, write_song

__all__ = [
    "read_wav", "write_wav", "resample", "load_audio",
    "serialize_example", "parse_example", "save_tf_records",
    "load_tf_records", "write_records", "read_records", "masked_crc32c",
    "ArrayDataset", "load_wav", "load_multiple_wav", "load_melspec_ds",
    "load_toydata", "get_mixture_toydata", "get_song_extract",
    "save_mel_spectrograms", "load_spec", "load_spec_tf",
    "synth_stems", "write_song",
]
