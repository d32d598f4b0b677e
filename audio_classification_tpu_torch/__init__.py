"""PyTorch + CUDA (H100) port of audio_classification_tpu: the
target-speaker paths (OSD -> Conv-TasNet or MossFormer separation -> speaker
verification -> SenseVoice CTC ASR; the flagship 3-source runner, the
2-source MVP runner, the source evaluator, the streaming application and the
multi-session server, in float32 or with ``--quant int8``), with the JAX
package's Pallas kernels on those paths rewritten as CUDA C++ kernels for
sm_90a (csrc/). Runs on the GPU unless the caller asks for the CPU."""

__version__ = "0.1.0"

G_SAMPLE_RATE = 16000
