"""Decision layer over the observability plane (counterpart of
``raft_tpu/tuning``).

``raft_tpu_torch.tuning.autotune`` closes the offline loop: diagnosis-driven
knob moves over a live serving window (no grid search), a Pareto
frontier over the accumulated fingerprinted windows, and an emitted
operating-point JSON that serving entry points consume. The ONLINE half —
the SLO burn-rate controller that nudges knobs under live pressure — lives
with the thing it controls, in ``raft_tpu_torch.serving.controller``.

Like ``obs.report``/``obs.flight``, the heavyweight module is deliberately
NOT imported at package level: ``python -m raft_tpu_torch.tuning.autotune``
stays clean, and importing :mod:`raft_tpu_torch.tuning` costs nothing.
"""
