"""ANN benchmark harness (counterpart of ``raft_tpu/bench``): config-driven
build/search sweeps reporting QPS, recall, and build time
(``python -m raft_tpu_torch.bench.runner``), the dataset readers and
writers, and the crash-safe progress channel.

``run_benchmark`` is reached lazily: the obs plane writes through
``bench/progress`` (stdlib only), and importing that through this package
must not import every index family the runner drives."""

__all__ = ["run_benchmark"]


def __getattr__(name):
    if name == "run_benchmark":
        from raft_tpu_torch.bench.runner import run_benchmark

        return run_benchmark
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
