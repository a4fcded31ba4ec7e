"""Audio files (counterpart of ``trackmaker_tpu/io``): 16-bit WAV, JSON
dumps, and FLAC through the port's native runtime."""

from trackmaker_tpu_torch.io.codec import decode_flac_to_f32, load_audio
from trackmaker_tpu_torch.io.dump import AudioData, dump_to_json, dump_to_wav, load_json
from trackmaker_tpu_torch.io.wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav", "AudioData", "dump_to_json",
           "dump_to_wav", "load_json", "decode_flac_to_f32", "load_audio"]
