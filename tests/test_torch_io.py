"""The port's own file readers and writers against the libraries the JAX
package uses.

The msgpack reader is held to `flax.serialization.msgpack_restore` on every
checkpoint of the repository, and the flat YAML reader to `yaml.safe_load`
on every args.yaml and metadata.yaml: exact equality, since both only
decode bytes. The writers are held to the same files: the msgpack writer
must give back each checkpoint's bytes from what the reader read (and
flax's `to_bytes` bytes), and the YAML writer `yaml.safe_dump`'s text.
"""
import glob
import os
import struct

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from mmd_torch.io.flat_yaml import dumps, load_flat_yaml, loads, save_flat_yaml
from mmd_torch.io.msgpack import load_msgpack, packb, save_msgpack, unpackb

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


@pytest.mark.parametrize("path", CHECKPOINTS, ids=_rel)
def test_msgpack_writer_gives_back_each_checkpoint(path):
    with open(path, "rb") as f:
        data = f.read()
    tree = load_msgpack(path)
    assert packb(tree) == data
    assert packb(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129, -2 ** 15 - 1,
    -2 ** 31 - 1, 1.5, -0.0, "x" * 31, "x" * 32, "y" * 300, "z" * 70000, b"q" * 5, [1] * 15,
    [1] * 16, {str(i): i for i in range(20)}, None, True, False, {"a": {}},
    np.asarray(7, np.int32), np.zeros((0, 3), np.float32), np.arange(70000, dtype=np.float32),
    np.ones((2, 3), np.float64)], ids=lambda v: type(v).__name__)
def test_msgpack_writer_matches_flax_on_each_type(value):
    import msgpack

    if isinstance(value, np.ndarray):
        assert packb({"v": value}) == serialization.msgpack_serialize({"v": value})
        np.testing.assert_array_equal(unpackb(packb(value)), value)
    else:
        assert packb(value) == msgpack.packb(value, use_bin_type=True)


@pytest.mark.parametrize("value", [{1: 2}, np.zeros(2, dtype=object), object(), 2 ** 64])
def test_msgpack_writer_refuses_what_flax_would_not_write(value):
    with pytest.raises(ValueError):
        packb(value)


def test_save_msgpack_round_trips_through_flax(tmp_path):
    tree = {"params": {"b": np.arange(6, dtype=np.float32).reshape(2, 3), "a": {}},
            "step": np.asarray(3, np.int32)}
    save_msgpack(str(tmp_path / "t.msgpack"), tree)
    with open(tmp_path / "t.msgpack", "rb") as f:
        back = serialization.msgpack_restore(f.read())
    assert list(back) == ["params", "step"] and int(back["step"]) == 3
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])


@pytest.mark.parametrize("path", YAMLS, ids=_rel)
def test_flat_yaml_writer_matches_pyyaml(path):
    with open(path) as f:
        data = yaml.safe_load(f)
    assert dumps(data) == yaml.safe_dump(data)


def test_flat_yaml_writer_reads_back_as_the_same_dict(tmp_path):
    data = {"a": 1e-5, "b": 1e17, "c": "true", "d": "1.5", "e": "it's", "f": [1.5, -2, "x y"],
            "g": None, "h": False, "i": float("inf"), "j": "null", "k": "EnvX-Robot",
            "l": -0.031116127967834473}
    save_flat_yaml(str(tmp_path / "a.yaml"), data)
    with open(tmp_path / "a.yaml") as f:
        text = f.read()
    assert yaml.safe_load(text) == data and loads(text) == data


@pytest.mark.parametrize("data", [{"a": []}, {"a": {"b": 1}}, {"a": "two\nlines"},
                                  {"not a key": 1}])
def test_flat_yaml_writer_refuses_what_the_reader_cannot_read(data):
    with pytest.raises(ValueError):
        dumps(data)
