"""The port's ``checkpoint`` against the reference: the reference's
serializer and manager cases (``tests/test_substrate.py``) run on the port,
checkpoints cross between the packages both ways (zstd and zlib frames,
f32 and bf16 payloads, ``{kg: Store}`` and nested dict/list trees), the
framed bytes are equal, the built-in msgpack codec writes and reads what
``msgpack`` does, the port imports without ``msgpack``, and a save is a
copy that a later in-place fold cannot reach.
"""
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.checkpoint.serializer as ref_ser
from repro.checkpoint import CheckpointManager as RefManager
from repro.core.store import Store as RefStore
import repro_torch.checkpoint.manager as manager_mod
import repro_torch.checkpoint.serializer as ser
from repro_torch.checkpoint import (CheckpointManager, deserialize_tree,
                                    serialize_tree)
from repro_torch.core.carry import store_from_numpy
from repro_torch.core.store import Store, kv_set_fold
from repro_torch.core.tree import tree_map
from torch_parity import assert_same_store, to_np
from torch_parity import port_lockdep  # noqa: F401  (autouse fixture)

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]


def _tree():
    """``tests/test_substrate.py``'s tree, in torch."""
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def _leaves(tree):
    return [x for _, x in ser._leaves_with_paths(tree)]


# ---------------------------------------------------------------------------
# tests/test_substrate.py's serializer and manager cases, on the port
# ---------------------------------------------------------------------------

def test_serializer_roundtrip():
    t = _tree()
    out = deserialize_tree(serialize_tree(t), t)
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_serializer_integrity_check():
    raw = bytearray(ser.decompress_bytes(serialize_tree(_tree())))
    raw[len(raw) // 2] ^= 0xFF
    with pytest.raises(IOError):
        deserialize_tree(ser.compress_bytes(bytes(raw)), _tree())


def test_serializer_corrupt_magic_raises_ioerror():
    blob = bytearray(serialize_tree(_tree()))
    blob[0] ^= 0xFF
    blob[1] ^= 0xFF
    with pytest.raises(IOError, match="corrupted|zstd"):
        ser.decompress_bytes(bytes(blob))


def test_serializer_truncated_frame_raises_ioerror():
    blob = serialize_tree(_tree())
    with pytest.raises(IOError, match="corrupted|zstd"):
        ser.decompress_bytes(blob[: len(blob) // 2])


@pytest.mark.parametrize("zstd", [True, False])
def test_serializer_zstd_magic_raises_ioerror(zstd, monkeypatch):
    """A frame carrying the zstd magic fails as an IOError either way:
    'zstandard not installed' when the module is absent, frame corruption
    when it is present (the payload here is junk)."""
    if not zstd:
        monkeypatch.setattr(ser, "zstandard", None)
    with pytest.raises(IOError, match="not installed" if not zstd
                       else "corrupted"):
        ser.decompress_bytes(ser._ZSTD_MAGIC + b"\x00\x01junk")


def test_manager_save_restore_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for step in [1, 2, 3, 4]:
        mgr.save(step, {"a": t["a"] + step, "b": t["b"]}, blocking=False)
    mgr.wait()
    assert mgr.steps() == [3, 4], "retention must keep the last 2"
    out = mgr.restore(t)
    assert torch.equal(out["a"], t["a"] + 4)
    assert torch.equal(mgr.restore(t, step=3)["a"], t["a"] + 3)


def test_manager_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_tree())


def test_restore_raises_on_a_shape_mismatch():
    blob = serialize_tree(_tree())
    wrong = _tree()
    wrong["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch at a"):
        deserialize_tree(blob, wrong)


def test_bf16_roundtrip_keeps_every_bit():
    """bf16 travels as its uint16 bit patterns: NaN payloads, infinities,
    signed zeros and subnormals come back bit for bit."""
    bits = np.array([0x7FC1, 0xFF80, 0x7F80, 0x8000, 0x0000, 0x0001, 0x3F80,
                     0xC2F7], np.uint16)
    rng = np.random.default_rng(0)
    bits = np.concatenate([bits, rng.integers(0, 2**16, 56, dtype=np.uint16)])
    t = {"w": torch.from_numpy(bits.view(np.int16).reshape(8, 8).copy())
         .view(torch.bfloat16)}
    out = deserialize_tree(serialize_tree(t), t)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), t["w"].view(torch.int16))


def test_restore_takes_the_template_leaf_dtype_and_device():
    t = _tree()
    tmpl = {"a": torch.zeros(3, 4, dtype=torch.float64),
            "b": {"c": torch.zeros(2, 2, dtype=torch.float32),
                  "d": torch.zeros((), dtype=torch.int64)}}
    out = deserialize_tree(serialize_tree(t), tmpl)
    for got, want, src in zip(_leaves(out), _leaves(tmpl), _leaves(t)):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, src.to(want.dtype))


# ---------------------------------------------------------------------------
# cross-loading between the packages
# ---------------------------------------------------------------------------

def _arenas(seed, bf16):
    """One arena as a reference Store and as a port Store (same leaves)."""
    rng = np.random.default_rng(seed)
    S, V, N = 8, 5, 64
    keys = rng.integers(1, 2**31 - 1, S).astype(np.int32)
    values = rng.normal(size=(S, V)).astype(np.float32)
    lengths = rng.integers(-1, V, S).astype(np.int32)
    versions = rng.integers(0, 2**20, S).astype(np.int32)
    vv = rng.integers(0, 100, N).astype(np.int32)
    ref = RefStore(jnp.asarray(keys),
                   jnp.asarray(values, jnp.bfloat16 if bf16 else jnp.float32),
                   jnp.asarray(lengths), jnp.asarray(versions),
                   jnp.asarray(vv))
    port = store_from_numpy(keys, values, lengths, versions, vv,
                            device="cpu",
                            dtype=torch.bfloat16 if bf16 else None)
    return ref, port


def _trees(bf16):
    """``{kg: Store}`` plus a nested dict/list tree, in both packages."""
    r0, p0 = _arenas(1, bf16)
    r1, p1 = _arenas(2, bf16)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    i = rng.integers(0, 1000, (3,)).astype(np.int32)
    rdt, pdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ref = {"kg": r0, "kg2": r1,
           "nest": {"w": jnp.asarray(w, rdt), "l": [jnp.asarray(i),
                                                   (jnp.asarray(w[0]),)]}}
    port = {"kg": p0, "kg2": p1,
            "nest": {"w": torch.from_numpy(w).to(pdt),
                     "l": [torch.from_numpy(i),
                           (torch.from_numpy(w[0].copy()),)]}}
    return ref, port


def _same_trees(ref, port):
    for kg in ("kg", "kg2"):
        assert isinstance(port[kg], Store)
        assert_same_store(ref[kg], port[kg], kg)
    rl = jax.tree_util.tree_leaves(ref["nest"])
    pl = [x for _, x in ser._leaves_with_paths(port["nest"])]
    assert len(rl) == len(pl)
    for a, b in zip(rl, pl):
        np.testing.assert_array_equal(to_np(a), to_np(b))


@pytest.fixture(params=["zstd", "zlib"])
def codec(request, monkeypatch):
    if request.param == "zlib":
        monkeypatch.setattr(ser, "zstandard", None)
        monkeypatch.setattr(ref_ser, "zstandard", None)
    else:
        assert ser.zstandard is not None and ref_ser.zstandard is not None
    return request.param


@pytest.mark.parametrize("bf16", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, codec, bf16):
    ref, port = _trees(bf16)
    RefManager(str(tmp_path)).save(5, ref, blocking=True)
    blob = (tmp_path / "ckpt_0000000005.msgpack.zst").read_bytes()
    assert (blob[:4] == ser._ZSTD_MAGIC) == (codec == "zstd")
    template = tree_map(torch.zeros_like, port)
    got = CheckpointManager(str(tmp_path)).restore(template)
    _same_trees(ref, got)
    for x, y in zip(_leaves(got), _leaves(template)):
        assert x.dtype == y.dtype


@pytest.mark.parametrize("bf16", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, codec, bf16):
    ref, port = _trees(bf16)
    CheckpointManager(str(tmp_path)).save(5, port, blocking=True)
    blob = (tmp_path / "ckpt_0000000005.msgpack.zst").read_bytes()
    assert (blob[:4] == ser._ZSTD_MAGIC) == (codec == "zstd")
    got = RefManager(str(tmp_path)).restore(ref)
    _same_trees(got, port)
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert x.dtype == y.dtype


@pytest.mark.parametrize("bf16", [False, True])
def test_framed_bytes_equal_in_both_packages(bf16):
    """Before compression the two packages write the same bytes for the
    same tree: paths, walk order, records and footer."""
    ref, port = _trees(bf16)
    a = ref_ser.decompress_bytes(ref_ser.serialize_tree(ref))
    b = ser.decompress_bytes(serialize_tree(port))
    assert a == b
    flat = msgpack.unpackb(msgpack.unpackb(b, raw=False)["payload"],
                           raw=False)
    assert list(flat)[:5] == ["kg/.keys", "kg/.values", "kg/.lengths",
                              "kg/.versions", "kg/.vv"]
    assert flat["kg/.keys"]["dtype"] == "<i4"
    assert flat["kg/.values"]["dtype"] == ("bfloat16" if bf16 else "<f4")
    assert "nest/l/1/0" in flat


# ---------------------------------------------------------------------------
# the built-in msgpack codec
# ---------------------------------------------------------------------------

_scalars = st.one_of(
    st.text(max_size=300), st.binary(max_size=300),
    st.integers(0, 2**64 - 1),
    st.lists(st.integers(0, 2**64 - 1), max_size=20))
_values = st.recursive(
    _scalars,
    lambda inner: st.one_of(st.lists(inner, max_size=5),
                            st.dictionaries(st.text(max_size=40), inner,
                                            max_size=5)),
    max_leaves=20)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.text(max_size=40), _values, max_size=20))
def test_codec_matches_msgpack(obj):
    packed = msgpack.packb(obj, use_bin_type=True)
    assert ser.pack(obj) == packed
    assert ser.unpack(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_boundaries(n):
    for obj in ({"s": "x" * n}, {"b": b"y" * n}, {"a": [1] * min(n, 70000)},
                {str(i): i for i in range(min(n, 70000))},
                {"i": [n, n * 257, n * 65537, 2**32 + n, 2**64 - 1 - n]}):
        packed = msgpack.packb(obj, use_bin_type=True)
        assert ser.pack(obj) == packed
        assert ser.unpack(packed) == msgpack.unpackb(packed, raw=False)


def test_codec_refuses_what_it_does_not_cover():
    for bad in ({"n": -1}, {"f": 1.5}, {"t": True}, {1: 2}, {"x": None}):
        with pytest.raises((TypeError, ValueError)):
            ser.pack(bad)
    with pytest.raises(ValueError):
        ser.unpack(msgpack.packb({"f": 1.5}))
    with pytest.raises(ValueError):
        ser.unpack(ser.pack({"s": "abc"})[:-1])


def test_port_checkpoint_imports_without_msgpack():
    code = ("import sys\n"
            "sys.modules['msgpack'] = None\n"
            "import torch\n"
            "import repro_torch.checkpoint as ck\n"
            "import repro_torch.runtime\n"
            "t = {'a': torch.arange(6.0)}\n"
            "out = ck.deserialize_tree(ck.serialize_tree(t), t)\n"
            "assert torch.equal(out['a'], t['a'])\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


# ---------------------------------------------------------------------------
# a save is a copy
# ---------------------------------------------------------------------------

def test_nonblocking_save_is_not_reached_by_a_later_fold(tmp_path,
                                                         monkeypatch):
    """``Tensor.cpu()`` of a CPU tensor is the same tensor: the manager
    must copy, or the writer thread serializes whatever the in-place fold
    wrote after ``save`` returned.  The writer is held until the fold is
    done, so the order is fixed."""
    gate = threading.Event()

    def gated(tree, *args, **kwargs):
        assert gate.wait(timeout=60)
        return serialize_tree(tree, *args, **kwargs)

    monkeypatch.setattr(manager_mod, "serialize_tree", gated)
    _, arena = _arenas(4, False)
    before = tuple(t.clone() for t in arena)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"kg": arena}, blocking=False)
    hashes = torch.tensor([int(arena.keys[0]), int(arena.keys[1])],
                          dtype=torch.int32)
    rows = torch.full((2, arena.value_width), 99.0)
    kv_set_fold(arena, hashes, rows, torch.tensor([5, 5], dtype=torch.int32),
                torch.tensor(2**22, dtype=torch.int32), 3)
    assert not torch.equal(arena.values, before[1]), "the fold wrote nothing"
    gate.set()
    mgr.wait()
    got = mgr.restore({"kg": tree_map(torch.zeros_like, arena)})["kg"]
    for x, y in zip(got, before):
        assert torch.equal(x, y)
