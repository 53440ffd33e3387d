"""The port's own HDF5 codec (`svcc23_fastsvc_tpu_torch/data/hdf5.py`:
numpy and struct, no h5py) against h5py and the JAX package's
`read_hdf5` / `write_hdf5`, and the scp loaders against the JAX
package's.

Files the port writes are read by h5py and by JAX `read_hdf5`; files h5py
and JAX `write_hdf5` write (a replaced dataset, a group of more members
than one symbol-table node holds, header continuation blocks, a compact
layout) are read by the port; every array bit for bit, over hypothesis
draws of dtype (f4, f8, i4, i8, u1), rank 0-3, shapes and names.
"""

import os
import string
import tempfile

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from svcc23_fastsvc_tpu.bin.common import write_wav
from svcc23_fastsvc_tpu.data import hdf5 as jh5
from svcc23_fastsvc_tpu.data.dataset import AudioSCPDataset as JaxAudioSCP
from svcc23_fastsvc_tpu.data.dataset import FeatsScpDataset as JaxFeatsScp
from svcc23_fastsvc_tpu_torch.data import hdf5 as th5
from svcc23_fastsvc_tpu_torch.data.dataset import (
    AudioSCPDataset,
    FeatsScpDataset,
)

DTYPES = [np.dtype(t) for t in ("<f4", "<f8", "<i4", "<i8", "u1")]
NAMES = st.text(alphabet=string.ascii_letters + string.digits + "_-",
                min_size=1, max_size=12)
ARRAYS = hnp.arrays(dtype=st.sampled_from(DTYPES),
                    shape=hnp.array_shapes(min_dims=0, max_dims=3,
                                           min_side=0, max_side=5))
MEMBERS = st.dictionaries(NAMES, ARRAYS, min_size=1, max_size=12)
SETTINGS = settings(max_examples=50, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def same(got, want):
    """Bit for bit: dtype, shape and bytes (NaNs and -0.0 included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@SETTINGS
@given(members=MEMBERS)
def test_port_files_are_read_by_h5py_and_jax(members):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sub", "utt.h5")
        for name, arr in members.items():  # the file written anew each time
            th5.write_hdf5(path, name, arr)
        with h5py.File(path, "r") as f:
            assert sorted(f.keys()) == sorted(members)
            for name, arr in members.items():
                same(f[name][()], arr)
        for name, arr in members.items():
            same(jh5.read_hdf5(path, name), arr)


@SETTINGS
@given(members=MEMBERS, again=ARRAYS)
def test_h5py_and_jax_files_are_read_by_the_port(members, again):
    """JAX `write_hdf5` (h5py's append mode) writes every member, then
    replaces the first (h5py deletes it and creates it anew)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "utt.h5")
        for name, arr in members.items():
            jh5.write_hdf5(path, name, arr)
        first = next(iter(members))
        jh5.write_hdf5(path, first, again)
        want = {**members, first: again}
        got = th5.read_hdf5_all(path)
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            same(got[name], arr)
            same(th5.read_hdf5(path, name), arr)


def test_groups_past_one_node_both_ways(tmp_path):
    """24 members: h5py spreads them over symbol-table nodes of 8, the
    port writes one node of 24 (group leaf K 12); each reads the other's,
    and h5py appends to and deletes from the port's file."""
    r = np.random.default_rng(0)
    want = {f"spk{i:02d}": r.standard_normal((1, 7)).astype(np.float32)
            for i in range(24)}
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for k, v in want.items():
            f[k] = v
    for path in (tmp_path / "h5py.h5", tmp_path / "port.h5"):
        if path.name == "port.h5":
            for k, v in want.items():
                th5.write_hdf5(str(path), k, v)
            with h5py.File(path, "a") as f:
                assert sorted(f.keys()) == sorted(want)
                f["zz"] = np.arange(3)
                del f["spk05"]
            want_here = {**{k: v for k, v in want.items() if k != "spk05"},
                         "zz": np.arange(3)}
        else:
            want_here = want
        got = th5.read_hdf5_all(str(path))
        assert sorted(got) == sorted(want_here)
        for k, v in want_here.items():
            same(got[k], v)


def test_continuation_blocks_compact_layout_and_big_endian(tmp_path):
    path = tmp_path / "odd.h5"
    with h5py.File(path, "w") as f:
        f["be"] = np.arange(6, dtype=">f8").reshape(2, 3)
        f["att"] = np.arange(5, dtype=np.int64)
        for j in range(30):  # the header outgrows its first chunk
            f["att"].attrs[f"a{j}"] = np.arange(40.0)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_FLOAT,
                             h5py.h5s.create_simple((4,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.array([1, 2, 3, 4], np.float32))
    got = th5.read_hdf5_all(str(path))
    np.testing.assert_array_equal(got["be"], np.arange(6.0).reshape(2, 3))
    assert got["be"].dtype == np.float64 and got["be"].dtype.isnative
    same(got["att"], np.arange(5, dtype=np.int64))
    same(got["compact"], np.array([1, 2, 3, 4], np.float32))


def test_unsupported_layouts_and_types_raise_naming_file_and_dataset(
        tmp_path):
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.arange(100.0), chunks=(10,))
        f.create_dataset("gzip", data=np.arange(100.0), compression="gzip")
        f["flags"] = np.array([True, False])
        f["text"] = "abc"
        f.create_group("grp")
        f["ok"] = np.ones(2)
    same(th5.read_hdf5(str(path), "ok"), np.ones(2))
    for name in ("chunked", "gzip", "flags", "text", "grp"):
        with pytest.raises(ValueError, match=f"{path}: dataset '{name}'"):
            th5.read_hdf5(str(path), name)
    with pytest.raises(KeyError):
        th5.read_hdf5(str(path), "missing")
    with pytest.raises(TypeError, match="dataset 'b'"):
        th5.write_hdf5(str(tmp_path / "w.h5"), "b", np.array([True]))


@pytest.fixture
def scp(tmp_path):
    r = np.random.default_rng(1)
    lines = []
    for i, form in enumerate(("plain", "named", "pair")):
        path = str(tmp_path / f"u{i}.h5")
        for name, width in (("feats", 3), ("a", 2), ("b", 4)):
            jh5.write_hdf5(path, name, r.standard_normal((5 + i, width)))
        entry = {"plain": path, "named": f"{path}:a",
                 "pair": f"{path}:a,b"}[form]
        lines.append(f"utt{i} {entry}")
    (tmp_path / "feats.scp").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "feats.scp")


def test_scp_loader_matches_jax_on_the_three_entry_forms(scp):
    port, ref = th5.HDF5ScpLoader(scp), jh5.HDF5ScpLoader(scp)
    assert list(port) == list(ref) == ["utt0", "utt1", "utt2"]
    assert len(port) == 3 and "utt1" in port and "x" not in port
    for key in ref.keys():
        same(port[key], ref[key])
    assert port["utt2"].shape == (7, 6)  # a and b on the last axis
    for got, want in zip(port.values(), ref.values()):
        same(got, want)
    ds, jds = (FeatsScpDataset(scp, return_utt_id=True),
               JaxFeatsScp(scp, return_utt_id=True))
    assert len(ds) == len(jds) == 3
    for i in range(3):
        assert ds[i][0] == jds[i][0]
        same(ds[i][1], jds[i][1])


def test_audio_scp_dataset_matches_jax(tmp_path):
    lines = []
    for i, sr in enumerate((16000, 24000)):
        x = 0.3 * np.sin(np.arange(800 + 100 * i) / (5 + i))
        write_wav(str(tmp_path / f"w{i}.wav"), x, sr)
        lines.append(f"utt{i} {tmp_path / f'w{i}.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    for kw in ({}, {"return_utt_id": True},
               {"return_sampling_rate": False}):
        port = AudioSCPDataset(str(tmp_path / "wav.scp"), **kw)
        ref = JaxAudioSCP(str(tmp_path / "wav.scp"), **kw)
        assert len(port) == len(ref) == 2
        for i in range(2):
            got, want = port[i], ref[i]
            if kw.get("return_utt_id"):
                assert got[0] == want[0]
                got, want = got[1], want[1]
            if kw.get("return_sampling_rate", True):
                assert got[1] == want[1]
                got, want = got[0], want[0]
            same(got, want)
