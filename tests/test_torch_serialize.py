"""Port parity: the v2 index container round-trips both ways between
raft_tpu.core.serialize and raft_tpu_torch.core.serialize, byte for byte."""

import io

import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu_torch.core import serialize as tser

torch.set_num_threads(2)


def _arrays():
    rng = np.random.default_rng(5)
    return {
        "centers": rng.standard_normal((16, 8)).astype(np.float32),
        "codes": rng.integers(0, 256, (16, 512, 4)).astype(np.uint8),
        "ids": np.arange(16 * 512, dtype=np.int32).reshape(16, 512),
        "b_sum": np.where(rng.random((16, 512)) < 0.1, np.inf,
                          rng.random((16, 512))).astype(np.float32),
        "scale": np.float32(0.25).reshape(()),
    }


META = {"kind": "ivf_pq", "metric": "sqeuclidean", "pq_bits": 8}


def _assert_same(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_jax_save_port_load(tmp_path):
    path = tmp_path / "jax.idx"
    jser.save_arrays(path, META, _arrays())
    meta, arrays = tser.load_arrays(path)
    assert meta["kind"] == "ivf_pq" and meta["pq_bits"] == 8
    _assert_same(arrays, _arrays())


def test_port_save_jax_load(tmp_path):
    path = tmp_path / "port.idx"
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in _arrays().items()}
    tser.save_arrays(path, META, tensors)
    meta, arrays = jser.load_arrays(path)
    assert meta["metric"] == "sqeuclidean"
    _assert_same(arrays, _arrays())


def test_container_bytes_identical():
    a, b = io.BytesIO(), io.BytesIO()
    jser.save_arrays(a, META, _arrays())
    tser.save_arrays(b, META, _arrays())
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("cut", ["flip", "truncate"])
def test_port_load_detects_corruption(cut):
    buf = io.BytesIO()
    jser.save_arrays(buf, META, _arrays())
    raw = bytearray(buf.getvalue())
    if cut == "flip":
        raw[-100] ^= 0xFF
    else:
        raw = raw[:-100]
    with pytest.raises(tser.SnapshotCorruptError):
        tser.load_arrays(io.BytesIO(bytes(raw)))


def test_port_load_rejects_foreign_file():
    with pytest.raises(ValueError, match="magic"):
        tser.load_arrays(io.BytesIO(b"NOTRAFT!" + bytes(32)))
