"""Device ops on PyTorch tensors: byte-tensor matching, the NFA/DFA
scans and the literal prefilter (each with a hand-written CUDA kernel
beside its plain version), CIDR/int-set membership and the windowed
correlator. Importing this package builds nothing: the kernels compile
at first use on a CUDA tensor (ops/_build.py)."""
