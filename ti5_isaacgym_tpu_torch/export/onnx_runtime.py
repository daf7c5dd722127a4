"""Minimal numpy ONNX executor for the exported DH policy graph (port of
``ti5_isaacgym_tpu/export/onnx_runtime.py``).

Decodes the full ModelProto (initializers, node attributes, graph IO) and
interprets the 8 ops the exporter emits (Gemm, Elu, Relu, Conv, Concat,
Reshape, Transpose, Slice) with numpy, following the ONNX opset-11 operator
semantics, so that an exported file can be run and held against the torch
forward without ``onnxruntime``.
"""
from __future__ import annotations

import struct as _struct
from typing import Dict, List, Tuple

import numpy as np

from .onnx import _read_varint


def _walk(buf: bytes) -> List[Tuple[int, int, object]]:
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
        elif wire == 1:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"bad wire type {wire}")
        fields.append((field, wire, v))
    return fields


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, dtype, name, raw = [], 1, "", b""
    for f, w, v in _walk(buf):
        if f == 1:
            dims.append(v)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    np_dtype = {1: np.float32, 7: np.int64}[dtype]
    arr = np.frombuffer(raw, np_dtype).reshape(dims)
    return name, arr


def _decode_attr(buf: bytes) -> Tuple[str, object]:
    name, atype = "", None
    f_val, i_val, ints = None, None, []
    for f, w, v in _walk(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            f_val = _struct.unpack("<f", v)[0]
        elif f == 3:
            i_val = v
        elif f == 8:
            if w == 0:
                ints.append(v)
            else:  # packed repeated varint
                j = 0
                while j < len(v):
                    x, j = _read_varint(v, j)
                    ints.append(x)
        elif f == 20:
            atype = v
    if atype == 1:
        return name, f_val
    if atype == 2:
        return name, i_val
    if atype == 7:
        return name, ints
    return name, (f_val if f_val is not None else (i_val if i_val is not None else ints))


def _decode_node(buf: bytes) -> Dict:
    node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    for f, w, v in _walk(buf):
        if f == 1:
            node["inputs"].append(v.decode())
        elif f == 2:
            node["outputs"].append(v.decode())
        elif f == 4:
            node["op"] = v.decode()
        elif f == 5:
            k, val = _decode_attr(v)
            node["attrs"][k] = val
    return node


def load_model(path: str) -> Dict:
    """Decode a ModelProto into {nodes, initializers, inputs, outputs}."""
    top = _walk(open(path, "rb").read())
    graph = next(v for f, w, v in top if f == 7)
    nodes, inits, inputs, outputs = [], {}, [], []
    for f, w, v in _walk(graph):
        if f == 1:
            nodes.append(_decode_node(v))
        elif f == 5:
            name, arr = _decode_tensor(v)
            inits[name] = arr
        elif f == 11:
            inputs.append(next(x.decode() for ff, ww, x in _walk(v) if ff == 1))
        elif f == 12:
            outputs.append(next(x.decode() for ff, ww, x in _walk(v) if ff == 1))
    return {"nodes": nodes, "initializers": inits,
            "inputs": inputs, "outputs": outputs}


def _conv1d(x: np.ndarray, w: np.ndarray, b: np.ndarray, stride: int) -> np.ndarray:
    """[N, Cin, L] * [Cout, Cin, k] -> [N, Cout, Lout] (VALID, dilation 1)."""
    n, cin, L = x.shape
    cout, _, k = w.shape
    lout = (L - k) // stride + 1
    # windows: [N, Cin, Lout, k]
    idx = (np.arange(lout) * stride)[:, None] + np.arange(k)[None, :]
    win = x[:, :, idx]                                   # [N, Cin, Lout, k]
    y = np.einsum("nclk,ock->nol", win, w) + b[None, :, None]
    return y


def run_model(model: Dict, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute the decoded graph on numpy inputs; returns the output dict."""
    env: Dict[str, np.ndarray] = dict(model["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    for node in model["nodes"]:
        op = node["op"]
        ins = [env[i] for i in node["inputs"]]
        a = node["attrs"]
        if op == "Gemm":
            A, B = ins[0], ins[1]
            if a.get("transA", 0):
                A = A.T
            if a.get("transB", 0):
                B = B.T
            y = a.get("alpha", 1.0) * (A @ B)
            if len(ins) > 2:
                y = y + a.get("beta", 1.0) * ins[2]
        elif op == "Elu":
            alpha = a.get("alpha", 1.0)
            x = ins[0]
            y = np.where(x > 0, x, alpha * (np.exp(np.minimum(x, 0.0)) - 1.0))
        elif op == "Relu":
            y = np.maximum(ins[0], 0.0)
        elif op == "Conv":
            y = _conv1d(ins[0], ins[1], ins[2], a.get("strides", [1])[0])
        elif op == "Concat":
            y = np.concatenate(ins, axis=a["axis"])
        elif op == "Reshape":
            y = ins[0].reshape([int(d) for d in ins[1]])
        elif op == "Transpose":
            y = np.transpose(ins[0], a["perm"])
        elif op == "Slice":
            data, starts, ends = ins[0], ins[1], ins[2]
            axes = ins[3] if len(ins) > 3 else np.arange(len(starts))
            steps = ins[4] if len(ins) > 4 else np.ones(len(starts), np.int64)
            sl = [slice(None)] * data.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                sl[int(ax)] = slice(int(s), int(e), int(st))
            y = data[tuple(sl)]
        else:
            raise NotImplementedError(f"op {op}")
        env[node["outputs"][0]] = np.asarray(y, np.float32)
    return {name: env[name] for name in model["outputs"]}


def run_file(path: str, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return run_model(load_model(path), feeds)
