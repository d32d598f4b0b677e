"""Signal ops: framing, STFT, mel-fbank, resampling (the kernels under
ops/kernels)."""
from .fbank import FbankConfig, apply_cmvn, apply_lfr, log_mel_fbank, mel_filterbank_np
from .frames import frame_signal, num_frames, window
from .resample import resample_linear, resample_poly
from .signal import frame_rms, l2norm, mix_with_gains, peak_limit
from .stft import istft, overlap_add, stft

__all__ = [
    "FbankConfig", "apply_cmvn", "apply_lfr", "log_mel_fbank", "mel_filterbank_np",
    "frame_signal", "num_frames", "window",
    "resample_linear", "resample_poly",
    "frame_rms", "l2norm", "mix_with_gains", "peak_limit",
    "istft", "overlap_add", "stft",
]
