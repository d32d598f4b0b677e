"""PyTorch + CUDA (H100) port of audio_classification_tpu: the flagship
offline 3-source target-speaker path (OSD -> Conv-TasNet-3 separation ->
speaker verification -> SenseVoice CTC ASR), with the JAX package's Pallas
kernels on that path rewritten as CUDA C++ kernels for sm_90a (csrc/)."""
