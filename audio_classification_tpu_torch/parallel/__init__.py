"""Sequence parallelism: one long utterance's frame axis cut into shards."""
