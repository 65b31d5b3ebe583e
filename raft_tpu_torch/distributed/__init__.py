"""Multi-card index families (counterpart of ``raft_tpu/distributed/``);
they arrive with the distributed slice of the port."""
