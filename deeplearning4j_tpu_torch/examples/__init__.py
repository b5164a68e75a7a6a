"""Twins of the repository's `examples/` scripts on the port: each module
bears its script's name and has `main(device=None)`, which runs on the
card unless given "cpu", prints what its script prints and returns the
facts it prints as a dict.

Run one as `python -m deeplearning4j_tpu_torch.examples.word2vec_text`.
"""
