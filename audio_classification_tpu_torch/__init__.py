"""PyTorch + CUDA (H100) port of audio_classification_tpu: the offline
target-speaker paths (OSD -> Conv-TasNet or MossFormer separation -> speaker
verification -> SenseVoice CTC ASR; the flagship 3-source runner, the
2-source MVP runner, the source evaluator), with the JAX package's Pallas
kernels on those paths rewritten as CUDA C++ kernels for sm_90a (csrc/).
Runs on the GPU unless the caller asks for the CPU."""
