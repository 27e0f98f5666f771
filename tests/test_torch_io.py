"""The port's own file readers against the libraries the JAX package uses.

The msgpack reader is held to `flax.serialization.msgpack_restore` on every
checkpoint of the repository, and the flat YAML reader to `yaml.safe_load`
on every args.yaml and metadata.yaml: exact equality, since both only
decode bytes.
"""
import glob
import os
import struct

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from mmd_torch.io.flat_yaml import load_flat_yaml, loads
from mmd_torch.io.msgpack import load_msgpack, unpackb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(ROOT, "data_trained_models*", "*",
                                            "ema_model.msgpack")))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "data_trained_models*", "*", "args.yaml"))
               + glob.glob(os.path.join(ROOT, "data_trajectories*", "*", "metadata.yaml")))


def _rel(p):
    return os.path.relpath(p, ROOT)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_repo_has_the_files_under_test():
    assert len(CHECKPOINTS) == 9
    assert len(YAMLS) == 18


@pytest.mark.parametrize("path", CHECKPOINTS, ids=_rel)
def test_msgpack_reader_matches_flax(path):
    with open(path, "rb") as f:
        data = f.read()
    _assert_tree_equal(unpackb(data), serialization.msgpack_restore(data))


def test_msgpack_reader_scalars_match_flax():
    tree = {"i": 7, "neg": -40, "big": 2**40, "f": 0.25, "s": "x" * 40,
            "none": None, "t": True, "l": [1, 2.5, "a"],
            "arr": np.arange(6, dtype=np.int32).reshape(2, 3)}
    data = serialization.msgpack_serialize(tree)
    got, want = unpackb(data), serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got.pop("arr"), want.pop("arr"))
    assert got == want


@pytest.mark.parametrize("blob", [
    b"\xc1",                                     # never-used type byte
    b"\xd4\x03\x00",                             # fixext1 of ext type 3
    b"\xc7\x01\x02\x00",                         # ext8 of ext type 2
    b"\x01\x02",                                 # trailing bytes
    b"\xdb" + struct.pack(">I", 10) + b"abc",    # truncated str32
])
def test_msgpack_reader_rejects_what_it_does_not_know(blob):
    with pytest.raises(ValueError):
        unpackb(blob)


def test_load_msgpack_reads_a_file(tmp_path):
    p = tmp_path / "t.msgpack"
    p.write_bytes(serialization.msgpack_serialize({"w": np.ones((2, 2), np.float32)}))
    np.testing.assert_array_equal(load_msgpack(str(p))["w"], np.ones((2, 2)))


@pytest.mark.parametrize("path", YAMLS, ids=_rel)
def test_flat_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = load_flat_yaml(path)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_flat_yaml_scalars_match_pyyaml():
    text = ("a: 1\nb: -2.5\nc: 1.0e-05\nd: true\ne: null\nf: hello\ng: '3'\n"
            "h:\n- 1\n- x\n- 2.0\ni: 1e5\nj: .inf\nk: 0.9997899532318115\n")
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",          # nested mapping
    "a: [1, 2]\n",           # flow sequence
    "a: {b: 1}\n",           # flow mapping
    "a: &x 1\n",             # anchor
    "- 1\n",                 # list without a key
    "a: |\n  text\n",        # block scalar
    "a: 1\na: 2\n",          # duplicate key
])
def test_flat_yaml_reader_rejects_other_yaml(text):
    with pytest.raises(ValueError):
        loads(text)
