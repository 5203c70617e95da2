"""``paddle.save`` / ``paddle.load`` of the port against the JAX package,
on the CPU: round trips of nested containers (fp32, bf16, int64 and bool
tensors and ``Parameter``s) bit for bit with their dtypes, names and
classes, at every pickle protocol; the protocol and missing-path errors;
files that ``paddle_tpu.save`` wrote (a layer's ``.pdparams`` and an
optimizer's ``.pdopt``) loading to the same values; and the payload's
fields equal to the reference's for the same tensors."""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.framework import io as jfio
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.framework import io as tfio

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "bf": rng.standard_normal((2, 5)).astype(np.float32),
            "ids": rng.integers(-5, 1 << 40, (6,)).astype(np.int64),
            "mask": rng.integers(0, 2, (3, 3)).astype(bool),
            "bias": rng.standard_normal((3,)).astype(np.float32)}


def _port_obj(v):
    bf = torch.tensor(v["bf"]).to(torch.bfloat16)
    return {"model": {"w": T.Parameter(torch.tensor(v["w"]), name="fc.w_0"),
                      "bias": T.Parameter(torch.tensor(v["bias"]),
                                          name="fc.b_0")},
            "extra": [torch.tensor(v["ids"]), (bf, torch.tensor(v["mask"]))],
            "step": 7, "nested": {"lr": 0.1, "name": "run"}}


def _check_port_obj(back, v):
    m = back["model"]
    for k, name in (("w", "fc.w_0"), ("bias", "fc.b_0")):
        assert isinstance(m[k], T.Parameter) and m[k].name == name
        assert m[k].dtype == torch.float32 and m[k].requires_grad
        np.testing.assert_array_equal(m[k].detach().numpy(), v[k])
    ids, (bf, mask) = back["extra"][0], back["extra"][1]
    assert isinstance(back["extra"], list) and isinstance(back["extra"][1],
                                                          tuple)
    assert not isinstance(ids, torch.nn.Parameter)
    assert ids.dtype == torch.int64 and mask.dtype == torch.bool
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(ids.numpy(), v["ids"])
    np.testing.assert_array_equal(mask.numpy(), v["mask"])
    want_bf = torch.tensor(v["bf"]).to(torch.bfloat16)
    assert torch.equal(bf.view(torch.int16), want_bf.view(torch.int16))
    assert back["step"] == 7 and back["nested"] == {"lr": 0.1, "name": "run"}


@pytest.mark.parametrize("protocol", [2, 3, 4, 5])
def test_round_trip_bit_for_bit(tmp_path, protocol):
    v = _values()
    path = str(tmp_path / "sub" / "ckpt.pdparams")
    T.save(_port_obj(v), path, protocol=protocol)
    _check_port_obj(T.load(path), v)


def test_return_numpy(tmp_path):
    v = _values(1)
    path = str(tmp_path / "t.pd")
    T.save(_port_obj(v), path)
    back = T.load(path, return_numpy=True)
    assert isinstance(back["model"]["w"], np.ndarray)
    np.testing.assert_array_equal(back["model"]["w"], v["w"])
    assert back["extra"][0].dtype == np.int64
    # bfloat16 comes back as its float32 store
    assert back["extra"][1][0].dtype == np.float32
    np.testing.assert_array_equal(
        back["extra"][1][0],
        torch.tensor(v["bf"]).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("protocol", [0, 1, 6])
def test_protocol_out_of_range_raises(tmp_path, protocol):
    with pytest.raises(ValueError, match="protocol"):
        T.save({"a": 1}, str(tmp_path / "x"), protocol=protocol)
    with pytest.raises(ValueError, match="protocol"):
        P.save({"a": 1}, str(tmp_path / "y"), protocol=protocol)


def test_missing_path_raises(tmp_path):
    missing = str(tmp_path / "nope.pdparams")
    with pytest.raises(ValueError, match="does not exist"):
        T.load(missing)
    with pytest.raises(ValueError, match="does not exist"):
        P.load(missing)


def test_reference_files_load_to_the_same_values(tmp_path):
    """A ``.pdparams`` and a ``.pdopt`` written by ``paddle_tpu.save``
    (a layer's state after one Adam step, and the optimizer's state with
    its lr schedule), and a bf16 tensor, load in the port to the same
    values, dtypes, names and classes."""
    P.seed(0)
    net = jnn.Sequential(jnn.Linear(4, 3), jnn.Linear(3, 2))
    sched = jopt.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    opt = jopt.Adam(sched, parameters=net.parameters())
    rng = np.random.default_rng(3)
    for p in net.parameters():
        p.grad = JT(rng.standard_normal(p.shape).astype(np.float32))
    opt.step()
    sched.step()
    P.save(net.state_dict(), str(tmp_path / "m.pdparams"))
    P.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    bf = JT(rng.standard_normal((3, 4)).astype(np.float32)).astype(
        "bfloat16")
    P.save({"bf": bf, "i": JT(np.arange(5, dtype=np.int64))},
           str(tmp_path / "bf.pd"))

    params = T.load(str(tmp_path / "m.pdparams"))
    want = net.state_dict()
    assert list(params) == list(want)
    for k, w in want.items():
        assert isinstance(params[k], T.Parameter)
        assert params[k].name == w.name
        np.testing.assert_array_equal(params[k].detach().numpy(),
                                      np.asarray(w._data))
    state = T.load(str(tmp_path / "m.pdopt"))
    jstate = opt.state_dict()
    assert set(state) == set(jstate)
    for k, w in jstate.items():
        if hasattr(w, "_data"):
            assert torch.is_tensor(state[k])
            np.testing.assert_array_equal(state[k].numpy(),
                                          np.asarray(w._data))
        else:
            assert state[k] == w
    back = T.load(str(tmp_path / "bf.pd"))
    assert back["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["bf"].float().numpy(), np.asarray(bf._data, np.float32))
    np.testing.assert_array_equal(back["i"].numpy(), np.arange(5))
    # the reference state into a port layer of the same structure
    tnet = T.nn.Sequential(T.nn.Linear(4, 3), T.nn.Linear(3, 2))
    missing, unexpected = tnet.set_state_dict(params)
    assert missing == [] and unexpected == []


def test_other_reference_classes_are_refused(tmp_path):
    path = tmp_path / "sched.pd"
    with open(path, "wb") as f:
        pickle.dump({"s": jopt.lr.StepDecay(0.1, step_size=1)}, f)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        T.load(str(path))


def test_payload_fields_equal_the_reference(tmp_path):
    """For the same tensors the port's ``_TensorPayload`` holds the
    reference's fields: the npy bytes, dtype name (bfloat16 stored as
    float32 under "bfloat16"), shape, whether it is a Parameter and (for a
    Parameter) its name."""
    v = _values(2)
    pairs = [
        (JParam(v["w"], name="fc.w_0"),
         T.Parameter(torch.tensor(v["w"]), name="fc.w_0")),
        (JT(v["bf"]).astype("bfloat16"),
         torch.tensor(v["bf"]).to(torch.bfloat16)),
        (JT(v["ids"]), torch.tensor(v["ids"])),
        (JT(v["mask"]), torch.tensor(v["mask"]))]
    for j, t in pairs:
        a, b = jfio._TensorPayload(j), tfio._TensorPayload(t)
        assert type(a).__slots__ == type(b).__slots__
        for f in ("buf", "dtype", "shape", "is_param"):
            assert getattr(a, f) == getattr(b, f), f
        if b.is_param:
            assert a.name == b.name
