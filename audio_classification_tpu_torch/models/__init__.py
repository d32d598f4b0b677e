"""Model zoo: separation, OSD, speaker embedding, ASR, VAD."""
from .convtasnet import ConvTasNet, ConvTasNetConfig
from .mossformer import MossFormer, MossFormerConfig
from .osd import OSDConfig, OSDNet, probs_to_hop_flags
from .pyannet import BinarizeConfig, PyanNet, PyanNetConfig
from .speaker import SpeakerBank, SpeakerEmbedder, SpeakerEmbedderConfig
from .vad import VADConfig, VADNet, VoiceActivityDetector

__all__ = [
    "BinarizeConfig", "PyanNet", "PyanNetConfig",
    "ConvTasNet", "ConvTasNetConfig",
    "MossFormer", "MossFormerConfig",
    "OSDConfig", "OSDNet", "probs_to_hop_flags",
    "SpeakerBank", "SpeakerEmbedder", "SpeakerEmbedderConfig",
    "VADConfig", "VADNet", "VoiceActivityDetector",
]
