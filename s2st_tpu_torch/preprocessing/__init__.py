"""Stages 1-2 of the recipe: audio manifests, manifest shards and
grapheme-to-phoneme rewriting (counterpart of ``s2st_tpu/preprocessing/``)."""
