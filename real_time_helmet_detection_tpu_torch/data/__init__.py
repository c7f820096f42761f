"""Eval data path: VOC parsing, resize + uint8 batches, synthetic fixture."""
