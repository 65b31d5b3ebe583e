"""The benchmark of ``raft_tpu_torch`` on one NVIDIA H100: cells taken as
data from ``BENCHMARK.json`` and the files it names (see ``README.md``)."""
