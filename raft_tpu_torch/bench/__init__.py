"""ANN benchmark harness (counterpart of ``raft_tpu/bench``): config-driven
build/search sweeps reporting QPS, recall, and build time
(``python -m raft_tpu_torch.bench.runner``), the dataset readers and
writers, and the crash-safe progress channel.

``run_benchmark`` is reached lazily: the obs plane writes through
``bench/progress`` (stdlib only), and importing that through this package
must not import every index family the runner drives."""

from raft_tpu_torch._lazy import attach

__getattr__, __dir__ = attach(__name__,
                              {"run_benchmark": ("runner", "run_benchmark")})

__all__ = ["run_benchmark"]
