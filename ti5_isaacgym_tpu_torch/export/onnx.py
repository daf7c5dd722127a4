"""Dependency-free ONNX export of the DH policy (port of
``ti5_isaacgym_tpu/export/onnx.py``).

Neither ``onnx`` nor ``onnxruntime`` is installed, so the ModelProto is
emitted directly in protobuf wire format (the message subset a feed-forward
Gemm/Conv/Elu/Relu/Concat/Reshape/Transpose/Slice graph needs).  The graph
reproduces ``ActorCriticDH.act_inference``: obs[1,3102] -> (action_mean[1,12],
est_vel[1,3]), opset 11.  From the same weights the bytes equal the JAX
exporter's: the port's params go through :func:`..algo.convert.flat_from_params`
into flax's layouts first.

:func:`parse_model_summary` re-parses the emitted bytes;
:mod:`.onnx_runtime` executes them.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..algo.convert import flat_from_params, nest_flat

# --- protobuf wire-format primitives ---


def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


# --- ONNX message builders (field numbers from onnx.proto3) ---


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _f_varint(1, d)                       # dims
    if arr.dtype == np.int64:
        out += _f_varint(2, 7)                       # data_type INT64
    else:
        arr = arr.astype(np.float32)
        out += _f_varint(2, 1)                       # data_type FLOAT
    out += _f_str(8, name)                           # name
    out += _f_bytes(9, arr.tobytes())                # raw_data
    return out


def _attr_int(name: str, v: int) -> bytes:
    return _f_str(1, name) + _f_varint(3, v) + _f_varint(20, 2)      # i, type=INT


def _attr_float(name: str, v: float) -> bytes:
    return _f_str(1, name) + _f_float(2, v) + _f_varint(20, 1)       # f, type=FLOAT


def _attr_ints(name: str, vals: Sequence[int]) -> bytes:
    out = _f_str(1, name)
    for v in vals:
        out += _f_varint(8, v)                                       # ints
    return out + _f_varint(20, 7)                                    # type=INTS


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    out = b""
    for i in inputs:
        out += _f_str(1, i)
    for o in outputs:
        out += _f_str(2, o)
    out += _f_str(3, name or f"{op}_{outputs[0]}")
    out += _f_str(4, op)
    for a in attrs:
        out += _f_bytes(5, a)
    return out


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(_f_bytes(1, _f_varint(1, d)) for d in shape)     # Dimension.dim_value
    tshape = _f_bytes(2, dims) if dims else _f_bytes(2, b"")         # TensorShapeProto
    ttype = _f_varint(1, 1) + tshape                                 # elem_type FLOAT + shape
    type_proto = _f_bytes(1, ttype)                                  # TypeProto.tensor_type
    return _f_str(1, name) + _f_bytes(2, type_proto)


def export_onnx_dh(params: Dict, path: str, batch: int = 1,
                   frame_stack: int = 66, frame_dim: int = 47,
                   num_short_obs: int = 235) -> str:
    """Emit the ActorCriticDH inference graph as an ONNX (opset 11) file.

    ``params`` is the port's params (a ``state_dict`` of ``ActorCriticDH``).
    """
    p = nest_flat(flat_from_params(params))
    obs_dim = frame_stack * frame_dim
    init: List[bytes] = []
    nodes: List[bytes] = []

    def add_init(name, arr):
        init.append(_tensor(name, np.asarray(arr)))
        return name

    def mlp(prefix: str, x: str, out: str) -> str:
        """Gemm(+Elu) chain from a flax MLP submodule."""
        i = 0
        cur = x
        while f"Dense_{i}" in p[prefix]:
            k = np.asarray(p[prefix][f"Dense_{i}"]["kernel"])
            b = np.asarray(p[prefix][f"Dense_{i}"]["bias"])
            last = f"Dense_{i+1}" not in p[prefix]
            y = out if last else f"{prefix}_h{i}"
            add_init(f"{prefix}_W{i}", k)
            add_init(f"{prefix}_b{i}", b)
            nodes.append(_node("Gemm", [cur, f"{prefix}_W{i}", f"{prefix}_b{i}"],
                               [y if last else y + "_pre"]))
            if not last:
                nodes.append(_node("Elu", [y + "_pre"], [y],
                                   attrs=[_attr_float("alpha", 1.0)]))
            cur = y
            i += 1
        return cur

    # short history = obs[:, obs_dim-num_short_obs:]
    add_init("slice_starts", np.asarray([obs_dim - num_short_obs], np.int64))
    add_init("slice_ends", np.asarray([obs_dim], np.int64))
    add_init("slice_axes", np.asarray([1], np.int64))
    nodes.append(_node("Slice", ["obs", "slice_starts", "slice_ends", "slice_axes"],
                       ["short"]))

    mlp("state_estimator", "short", "est_vel")

    # long-history CNN: obs -> [N, 66, 47] (frames as channels)
    add_init("reshape_ch", np.asarray([batch, frame_stack, frame_dim], np.int64))
    nodes.append(_node("Reshape", ["obs", "reshape_ch"], ["lh_in"]))
    lh = p["long_history"]
    cur = "lh_in"
    ci = 0
    strides = {0: 3, 1: 2}
    while f"Conv_{ci}" in lh:
        k = np.asarray(lh[f"Conv_{ci}"]["kernel"])        # (k, cin, cout)
        b = np.asarray(lh[f"Conv_{ci}"]["bias"])
        w_onnx = np.transpose(k, (2, 1, 0))               # (cout, cin, k)
        add_init(f"lh_W{ci}", w_onnx)
        add_init(f"lh_b{ci}", b)
        nodes.append(_node("Conv", [cur, f"lh_W{ci}", f"lh_b{ci}"],
                           [f"lh_c{ci}_pre"],
                           attrs=[_attr_ints("kernel_shape", [k.shape[0]]),
                                  _attr_ints("strides", [strides[ci]])]))
        nodes.append(_node("Relu", [f"lh_c{ci}_pre"], [f"lh_c{ci}"]))
        cur = f"lh_c{ci}"
        ci += 1
    # [N, C, L] -> [N, L, C] -> flatten matches the flax length-major layout
    nodes.append(_node("Transpose", [cur], ["lh_t"],
                       attrs=[_attr_ints("perm", [0, 2, 1])]))
    flat_dim = int(np.asarray(lh["Dense_0"]["kernel"]).shape[0])
    add_init("reshape_flat", np.asarray([batch, flat_dim], np.int64))
    nodes.append(_node("Reshape", ["lh_t", "reshape_flat"], ["lh_flat"]))
    mlp("long_history", "lh_flat", "lh_emb")

    nodes.append(_node("Concat", ["short", "est_vel", "lh_emb"], ["actor_in"],
                       attrs=[_attr_int("axis", 1)]))
    mlp("actor", "actor_in", "action_mean")

    graph = b""
    for n in nodes:
        graph += _f_bytes(1, n)
    graph += _f_str(2, "ti5_dh_policy")
    for t in init:
        graph += _f_bytes(5, t)
    graph += _f_bytes(11, _value_info("obs", [batch, obs_dim]))
    graph += _f_bytes(12, _value_info("action_mean", [batch, 12]))
    graph += _f_bytes(12, _value_info("est_vel", [batch, 3]))

    opset = _f_str(1, "") + _f_varint(2, 11)
    model = (_f_varint(1, 7)                # ir_version 7
             + _f_str(2, "ti5_isaacgym_tpu")
             + _f_bytes(7, graph)
             + _f_bytes(8, opset))
    with open(path, "wb") as f:
        f.write(model)
    return path


# --- structural re-parse (self-check) ---


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        val |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return val, i
        shift += 7


def parse_model_summary(path: str) -> Dict:
    """Minimal decoder: checks the file parses as protobuf and extracts the
    graph's node ops, initializer names, and IO names."""
    buf = open(path, "rb").read()

    def walk(buf):
        i, fields = 0, []
        while i < len(buf):
            key, i = _read_varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, i = _read_varint(buf, i)
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                v = buf[i:i + ln]
                i += ln
            elif wire == 5:
                v = buf[i:i + 4]
                i += 4
            else:
                raise ValueError(f"bad wire type {wire}")
            fields.append((field, wire, v))
        return fields

    top = walk(buf)
    graph = next(v for f, w, v in top if f == 7)
    g = walk(graph)
    ops, inits, ios = [], [], []
    for f, w, v in g:
        if f == 1:
            ops.append(next(x.decode() for ff, ww, x in walk(v) if ff == 4))
        elif f == 5:
            inits.append(next(x.decode() for ff, ww, x in walk(v) if ff == 8))
        elif f in (11, 12):
            ios.append(next(x.decode() for ff, ww, x in walk(v) if ff == 1))
    return {"ops": ops, "initializers": inits, "io": ios,
            "ir_version": next(v for f, w, v in top if f == 1),
            "opset": next(
                vv for f, w, v in top if f == 8
                for ff, ww, vv in walk(v) if ff == 2)}
