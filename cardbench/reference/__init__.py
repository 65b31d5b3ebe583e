"""The plain reference the benchmark judges the port against: exact k-NN
in plain PyTorch from the benchmark's own rows, and the comparison that
decides ``correct``. Imports nothing of ``raft_tpu_torch``."""
