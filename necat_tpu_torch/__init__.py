"""necat_tpu_torch — the PyTorch + CUDA port of necat_tpu's correction path.

Candidate detection (overlap.overlapper.find_all_candidates) followed by read
correction (consensus.correct.correct_reads), on the device the caller
names: "cuda", the default, runs the hand-written Hopper kernels of csrc/,
"cpu" their plain PyTorch versions; a list of devices shares the work
(parallel/mesh.py). The JAX package necat_tpu is the reference the port is
tested against; the port imports nothing of it and keeps its own copies of
the host modules it needs (read store, FASTA I/O, options, shape tiers,
config, the native parser and k-mer index build).
"""
