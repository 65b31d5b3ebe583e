"""Rule catalog — importing this package registers every rule.

Sixteen ids in fifteen modules, as in ``raft_tpu/analysis/rules``. Four are
the JAX package's JAX-idiom rules recast for torch on CUDA (the hazard is
the same: the host stalls the card inside what should be a
device-resident stretch):

* ``tensor-branch``       — Python ``if``/``while``/``assert``/``bool()`` on
  a tensor inside a launch region or a ``@traced`` loop (an implicit
  ``.item()``); JAX's ``tracer-branch``
* ``launch-host-sync``    — a torch sync (``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``, ``int``/``float``/``bool`` of a tensor,
  ``torch.nonzero``, boolean-mask indexing, ``torch.cuda.synchronize``)
  inside a kernel-launch or compiled region; JAX's ``jit-host-sync``
* ``loop-host-transfer``  — the same syncs inside loops of ``@traced`` host
  entry points (the per-iteration sync that serializes the launches)
* ``recompile-hazard``    — ``torch.compile``/``torch.jit``/a kernel build
  constructed inside a loop, f-strings formatting a tensor on the launch
  path

The twelve generic ones are copied, scopes pointed at ``raft_tpu_torch/``:

* ``obs-coverage``        — public build/search/fit entry points in
  neighbors/cluster/distributed/serving (and the obs plane's own) must be
  ``@traced`` or open a ``record_span``
* ``banned-api``          — wall-clock / stdlib-random / datetime reads in
  kernel & ops modules (determinism contract)
* ``swallowed-exception`` — bare ``except:`` and broad except-pass around
  device calls
* ``mutable-default``     — mutable default argument values
* ``bench-io``            — bench results writes bypassing the crash-safe
  ``bench/progress.py`` channel
* ``span-name``           — literal span names breaking the ``module::phase``
  convention, and bench-scope ``export_jsonl``/trace exports bypassing
  ``bench/progress.py``'s fsync'd channel
* ``unclassified-except`` — broad except in bench / distributed / serving /
  obs / resilience paths that neither routes through
  ``resilience.classify()`` nor re-raises
* ``unused-import``       — dead imports (non-``__init__`` modules)

Concurrency-discipline family (interprocedural — these consult the
repo-wide :mod:`~raft_tpu_torch.analysis.projectgraph` built per scan):

* ``guarded-state``       — access to a ``# guarded-by:`` annotated field
  outside its lock and outside any lock-held-on-entry method
* ``lock-order``          — cycles in the repo-wide lock-acquisition graph,
  and non-reentrant self-acquisition
* ``faultpoint-contract`` — library faultpoints no tier-1 test arms, and
  arming strings naming nonexistent sites
* ``env-knob``            — ``RAFT_TPU_*`` knobs missing from the README
  knob table or defaulted in more than one module
"""

from raft_tpu_torch.analysis.rules import (  # noqa: F401  (registration side effect)
    banned_api,
    bench_io,
    env_knob,
    exceptions,
    faultpoint_contract,
    guarded_state,
    host_sync,
    imports,
    lock_order,
    mutable_defaults,
    obs_coverage,
    recompile,
    span_name,
    tracer_control,
    unclassified_except,
)
