"""Training: losses, the optimizer and its schedule, the separator and
module trainers, checkpoints and the training CLIs' data plumbing (port of
audio_classification_tpu/train/)."""
