"""Sharded-index snapshots: per-shard containers and a manifest
(counterpart of ``raft_tpu/distributed/snapshot.py``, with the same files:
a snapshot written by either package loads in the other).

Directory layout (each file a v2 crash-safe container,
:mod:`raft_tpu_torch.core.serialize`: atomic writes, per-array CRC32s)::

    MANIFEST.json        the commit point, written last (atomic): kind,
                         world, n_total, file list, which arrays exist
    common.raft          replicated quantizers and host-side tables
    shard_0000.raft ...  one file a shard with that shard's slice of
                         every sharded array

A snapshot is valid iff its manifest parses: a crash mid-snapshot leaves
the previous complete snapshot, or shard files with no manifest. Restoring
shard 3 reads ``shard_0003.raft`` only. Each process writes the shard
files of the shards it holds; the process holding rank 0 writes
``common.raft`` and, after a barrier, the manifest.

Kinds: brute_force, ivf_flat, ivf_pq, cagra (the JAX package's four).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.fsio import atomic_write
from raft_tpu_torch.core.serialize import load_arrays, save_arrays

MANIFEST = "MANIFEST.json"
_MANIFEST_VERSION = 1


@dataclass(frozen=True)
class _Spec:
    """What one distributed index kind persists."""

    sharded: Tuple[str, ...]     # one tensor a shard (optional ones ok)
    replicated: Tuple[str, ...]  # replicated tensors
    host: Tuple[str, ...]        # host numpy attrs (lens_max)
    meta: Tuple[str, ...]        # scalar attrs


_SPECS = {
    "brute_force": _Spec(("dataset", "norms"), (), (),
                         ("metric", "metric_arg", "n_total")),
    "ivf_flat": _Spec(("list_data", "list_ids", "bias"), ("centers",),
                      ("lens_max",), ("metric", "n_total")),
    "ivf_pq": _Spec(("list_codes", "list_ids", "bias", "decoded"),
                    ("centers", "rotation", "codebooks"), ("lens_max",),
                    ("decoded_scale", "metric", "pq_bits", "n_total")),
    "cagra": _Spec(("dataset", "graph", "proj", "code_scale", "nbr_codes",
                    "centroids", "centroid_reps", "proj_energy"), (), (),
                   ("n_total",)),
}


def _index_cls(kind: str):
    from raft_tpu_torch.distributed import brute_force, cagra, ivf_flat, ivf_pq

    return {"brute_force": brute_force.ShardedBruteForceIndex,
            "ivf_flat": ivf_flat.ShardedIvfFlatIndex,
            "ivf_pq": ivf_pq.ShardedIvfPqIndex,
            "cagra": cagra.ShardedCagraIndex}[kind]


def _kind_of(index) -> str:
    for kind in _SPECS:
        if isinstance(index, _index_cls(kind)):
            return kind
    raise ValueError(f"not a distributed index: {type(index).__name__}")


def _shard_file(r: int) -> str:
    return f"shard_{r:04d}.raft"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _meta_value(v):
    return v.item() if isinstance(v, np.generic) else v


def save(index, directory) -> str:
    """Snapshot a distributed index into ``directory`` → the manifest path.
    Every file is written atomically; the manifest lands last, so a killed
    snapshot never shadows the previous complete one."""
    kind = _kind_of(index)
    spec = _SPECS[kind]
    comms = index.comms
    world = comms.size
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    present = [n for n in spec.sharded if getattr(index, n) is not None]
    attrs = None
    if obs.enabled():
        obs.add("distributed.snapshot.saves")
        attrs = {"shard": world}
    with obs.record_span("distributed.snapshot::save", attrs=attrs):
        for i, r in enumerate(comms.ranks):
            save_arrays(
                os.path.join(directory, _shard_file(r)),
                {"kind": kind, "snapshot": "shard", "shard": r,
                 "world": world},
                {n: _host(getattr(index, n)[i]) for n in present})
        if 0 in comms.ranks:
            common = {n: _host(getattr(index, n)) for n in spec.replicated}
            common.update({n: np.asarray(getattr(index, n))
                           for n in spec.host})
            meta = {"kind": kind, "snapshot": "common",
                    **{n: _meta_value(getattr(index, n)) for n in spec.meta}}
            save_arrays(os.path.join(directory, "common.raft"), meta, common)
        C.barrier(comms)      # every shard file is down before the commit
        if 0 in comms.ranks:
            manifest = {
                "version": _MANIFEST_VERSION,
                "kind": kind,
                "world": world,
                "n_total": int(index.n_total),
                "common": "common.raft",
                "shards": [_shard_file(r) for r in range(world)],
                "sharded_arrays": present,
            }
            with atomic_write(os.path.join(directory, MANIFEST), "w") as f:
                json.dump(manifest, f, indent=2)
        C.barrier(comms)
    return os.path.join(directory, MANIFEST)


def read_manifest(directory) -> dict:
    """Parse and sanity-check a snapshot manifest."""
    path = os.path.join(os.fspath(directory), MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no snapshot manifest at {path} — the snapshot was never "
            f"committed (or the directory is wrong)")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("version", 0) > _MANIFEST_VERSION:
        raise ValueError(f"unsupported snapshot manifest version "
                         f"{manifest.get('version')}")
    if manifest.get("kind") not in _SPECS:
        raise ValueError(f"snapshot manifest names unknown index kind "
                         f"{manifest.get('kind')!r}")
    return manifest


def _load_shard_arrays(directory, manifest, r: int, kind: str) -> dict:
    meta, arrays = load_arrays(
        os.path.join(os.fspath(directory), manifest["shards"][r]))
    if meta.get("kind") != kind or meta.get("shard") != r:
        raise ValueError(
            f"snapshot shard file {manifest['shards'][r]} is for "
            f"kind={meta.get('kind')!r} shard={meta.get('shard')!r}, "
            f"expected kind={kind!r} shard={r}")
    return arrays


def load(directory, comms: Optional[C.Comms] = None):
    """Rebuild a distributed index from a snapshot directory (the inverse
    of :func:`save`): replicated arrays from ``common.raft`` on the first
    local shard's device, each local shard's slices on its device."""
    manifest = read_manifest(directory)
    kind = manifest["kind"]
    spec = _SPECS[kind]
    comms = comms or C.make_comms()
    if comms.size != manifest["world"]:
        raise ValueError(
            f"snapshot was taken over world={manifest['world']} but the "
            f"communicator has {comms.size} slots — resharding is not "
            f"supported; rebuild instead")
    attrs = None
    if obs.enabled():
        obs.add("distributed.snapshot.loads")
        attrs = {"shard": int(manifest["world"])}
    with obs.record_span("distributed.snapshot::load", attrs=attrs):
        meta, common = load_arrays(
            os.path.join(os.fspath(directory), manifest["common"]))
        if meta.get("kind") != kind:
            raise ValueError(f"snapshot common file is for kind="
                             f"{meta.get('kind')!r}, manifest says {kind!r}")
        dev0 = comms.devices[0]
        kwargs = {n: meta[n] for n in spec.meta}
        kwargs.update({n: torch.from_numpy(np.array(common[n])).to(dev0)
                       for n in spec.replicated})
        kwargs.update({n: np.asarray(common[n]) for n in spec.host})
        present = manifest.get("sharded_arrays", list(spec.sharded))
        for n in spec.sharded:
            if n not in present:
                kwargs[n] = None  # an optional array the build never made
        parts = {n: [] for n in present}
        for r, dev in zip(comms.ranks, comms.devices):
            arrays = _load_shard_arrays(directory, manifest, r, kind)
            for n in present:
                parts[n].append(torch.from_numpy(np.array(arrays[n])).to(dev))
        kwargs.update(parts)
        return _index_cls(kind)(comms=comms, **kwargs)


def restore_shard(index, directory, shard: int):
    """A new index with ONE shard's slice of every sharded array reloaded
    from its snapshot file (the recovery of a LOST shard); reads only
    ``shard_<r>.raft`` and the manifest. On ``process_group`` only the
    process holding the shard reads it."""
    kind = _kind_of(index)
    spec = _SPECS[kind]
    manifest = read_manifest(directory)
    if manifest["kind"] != kind:
        raise ValueError(f"snapshot at {os.fspath(directory)} holds a "
                         f"{manifest['kind']!r} index, not {kind!r}")
    comms = index.comms
    world = comms.size
    if manifest["world"] != world:
        raise ValueError(f"snapshot world {manifest['world']} != index "
                         f"world {world}")
    shard = int(shard)
    if not 0 <= shard < world:
        raise ValueError(f"shard {shard} out of range for world {world}")
    attrs = None
    if obs.enabled():
        obs.add("distributed.snapshot.shard_restores")
        attrs = {"shard": shard}
    updates = {}
    with obs.record_span("distributed.snapshot::restore_shard", attrs=attrs):
        if shard not in comms.ranks:
            return index
        i = comms.ranks.index(shard)
        arrays = _load_shard_arrays(directory, manifest, shard, kind)
        for n in manifest.get("sharded_arrays", list(spec.sharded)):
            cur = getattr(index, n)
            if cur is None:
                continue
            new = list(cur)
            new[i] = torch.from_numpy(np.array(arrays[n])).to(cur[i].device)
            updates[n] = new
    return dataclasses.replace(index, **updates)


def recover(index, directory,
            health: Optional[resilience.ShardHealth] = None):
    """Reload every LOST shard from the snapshot and reinstate it in the
    health registry → ``(index, recovered_shards)``: search again and the
    coverage is back to 1.0."""
    health = health or resilience.shard_health()
    recovered = []
    for shard in health.lost():
        index = restore_shard(index, directory, shard)
        health.mark_recovered(shard)
        recovered.append(shard)
    return index, tuple(recovered)
