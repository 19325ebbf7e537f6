"""One-time converter: Caffe ``.caffemodel`` -> framework weight pytree.

The reference ships its trained model as ``learned_weights.caffemodel``
(protobuf ``NetParameter``, see the reference's network_definition.prototxt
and SURVEY.md C7): conv0 (32x3x1x1 + bias 32), conv1..conv4 (32x32x1x1 + 32),
fuse_skip_layers (1x160x1x1 + 1) — 4,513 float32 values total.

Rather than depending on caffe's generated protobuf classes, this module
implements a minimal protobuf *wire format* reader (varint / length-delimited
/ fixed32) sufficient to walk NetParameter -> LayerParameter -> BlobProto.
Field numbers used (from caffe.proto, stable public schema):

  NetParameter.layer        = 100 (LayerParameter, new format)
  NetParameter.layers       = 2   (V1LayerParameter, old format)
  LayerParameter.name       = 1
  LayerParameter.type       = 2
  LayerParameter.blobs      = 7
  V1LayerParameter.name     = 4  (field 1 is the embedded V0LayerParameter)
  V1LayerParameter.blobs    = 6
  BlobProto.shape           = 7  (BlobShape, .dim = 1)
  BlobProto.data            = 5  (packed float)
  BlobProto.{num,channels,height,width} = 1..4 (legacy shape)

Weights are converted once to the device layout used throughout this
framework: convolution kernels are stored HWIO (height, width, in, out) for
``lax.conv_general_dilated`` with NHWC feature maps, biases as 1-D arrays.

The trained file is looked up at ``learned_weights.caffemodel`` in the
checkout's root, where the reference keeps it beside its script.  Where it
is absent, :func:`write_seeded_caffemodel` writes stand-in weights of the
same shapes, drawn from a seed, in the same wire format — so the parser
runs on every path that loads weights.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_WIRE_VARINT = 0
_WIRE_F64 = 1
_WIRE_LEN = 2
_WIRE_F32 = 5


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == _WIRE_VARINT:
            val, i = _read_varint(buf, i)
        elif wtype == _WIRE_LEN:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == _WIRE_F32:
            val = buf[i:i + 4]
            i += 4
        elif wtype == _WIRE_F64:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError("Unsupported protobuf wire type {}".format(wtype))
        yield fnum, wtype, val


def _parse_blob(buf: bytes) -> np.ndarray:
    """Parse a BlobProto into a float32 ndarray with its declared shape."""
    dims: List[int] = []
    legacy = {}
    chunks: List[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 7 and wtype == _WIRE_LEN:  # BlobShape
            for sf, swt, sval in _iter_fields(val):
                if sf == 1 and swt == _WIRE_VARINT:
                    dims.append(sval)
                elif sf == 1 and swt == _WIRE_LEN:
                    # packed repeated int64
                    i = 0
                    while i < len(sval):
                        d, i = _read_varint(sval, i)
                        dims.append(d)
        elif fnum == 5:
            if wtype == _WIRE_LEN:  # packed floats
                chunks.append(val)
            elif wtype == _WIRE_F32:  # unpacked float
                chunks.append(val)
        elif fnum in (1, 2, 3, 4) and wtype == _WIRE_VARINT:
            legacy[fnum] = val
    data = np.frombuffer(b"".join(chunks), dtype="<f4")
    if not dims and legacy:
        dims = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if dims:
        data = data.reshape(dims)
    return np.array(data, dtype=np.float32)


def parse_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel file into {layer_name: [blob, ...]}."""
    with open(path, "rb") as f:
        buf = f.read()
    layers: Dict[str, List[np.ndarray]] = {}
    for fnum, wtype, val in _iter_fields(buf):
        if fnum in (100, 2) and wtype == _WIRE_LEN:  # layer / layers
            name = None
            blobs: List[np.ndarray] = []
            blob_field = 7 if fnum == 100 else 6
            name_field = 1 if fnum == 100 else 4
            for lf, lwt, lval in _iter_fields(val):
                if lf == name_field and lwt == _WIRE_LEN:
                    name = lval.decode("utf-8", errors="replace")
                elif lf == blob_field and lwt == _WIRE_LEN:
                    blobs.append(_parse_blob(lval))
            if name is not None and blobs:
                layers[name] = blobs
    return layers


def _caffe_kernel_to_hwio(kernel_oihw: np.ndarray) -> np.ndarray:
    """Caffe conv kernel OIHW -> HWIO (NHWC device convention)."""
    return np.ascontiguousarray(np.transpose(kernel_oihw, (2, 3, 1, 0)))


def load_caffemodel_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Load any caffemodel's convolution weights as {layer: {kernel, bias}}.

    Kernels come out HWIO float32, biases 1-D float32.
    """
    raw = parse_caffemodel(path)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, blobs in raw.items():
        if not blobs or blobs[0].ndim != 4:
            continue
        entry = {"kernel": _caffe_kernel_to_hwio(blobs[0])}
        if len(blobs) > 1:
            entry["bias"] = blobs[1].reshape(-1).astype(np.float32)
        out[name] = entry
    return out


DEFAULT_CAFFEMODEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "learned_weights.caffemodel")

_EXPECTED_LAYERS = ("conv0", "conv1", "conv2", "conv3", "conv4",
                    "fuse_skip_layers")

# caffe OIHW blob shapes of the shipped model (network_definition.prototxt)
REFERENCE_BLOB_SHAPES = {
    "conv0": [(32, 3, 1, 1), (32,)],
    "conv1": [(32, 32, 1, 1), (32,)],
    "conv2": [(32, 32, 1, 1), (32,)],
    "conv3": [(32, 32, 1, 1), (32,)],
    "conv4": [(32, 32, 1, 1), (32,)],
    "fuse_skip_layers": [(1, 160, 1, 1), (1,)],
}


def load_reference_weights(path: str = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Load the shipped trained model (convStaticSkipLayers n5 f32 k1).

    Validates the exact parameter inventory documented in SURVEY.md C7
    (4,513 floats). Returns {conv0..conv4, fuse_skip_layers} with HWIO
    kernels (all 1x1) and biases.  ``path`` defaults to
    :data:`DEFAULT_CAFFEMODEL`.
    """
    if path is None:
        path = DEFAULT_CAFFEMODEL
    if not os.path.isfile(path):
        raise FileNotFoundError(
            "no caffemodel at {}: copy the reference's trained "
            "learned_weights.caffemodel there or pass its path, or write "
            "seeded stand-in weights of the same shapes with "
            "reflectance_filtering.models.caffe_io.write_seeded_caffemodel"
            "(path, seed)".format(path))
    weights = load_caffemodel_weights(path)
    missing = [l for l in _EXPECTED_LAYERS if l not in weights]
    if missing:
        raise ValueError(
            "caffemodel at {} is missing expected layers: {}".format(
                path, missing))
    total = sum(w["kernel"].size + w.get("bias", np.empty(0)).size
                for w in weights.values())
    if total != 4513:
        raise ValueError(
            "expected 4,513 parameters in the reference model, got {}".format(
                total))
    return {l: weights[l] for l in _EXPECTED_LAYERS}


# ---------------------------------------------------------------------------
# Writer: seeded stand-in weights in the caffemodel wire format
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _varint(fnum << 3 | _WIRE_LEN) + _varint(len(payload)) + payload


def _blob_bytes(blob: np.ndarray) -> bytes:
    dims = b"".join(_varint(d) for d in blob.shape)
    return (_len_field(7, _len_field(1, dims))            # BlobShape.dim
            + _len_field(5, np.ascontiguousarray(
                blob, dtype="<f4").tobytes()))             # packed data


def write_caffemodel(path: str, layers: Dict[str, List[np.ndarray]]) -> str:
    """Write {layer_name: [blob, ...]} (caffe layouts) as a NetParameter
    with new-format layers (field 100), each a Convolution LayerParameter
    whose blobs carry a BlobShape and packed float data."""
    net = b"".join(
        _len_field(100, _len_field(1, name.encode("utf-8"))
                   + _len_field(2, b"Convolution")
                   + b"".join(_len_field(7, _blob_bytes(np.asarray(b)))
                              for b in blobs))
        for name, blobs in layers.items())
    with open(path, "wb") as f:
        f.write(net)
    return path


def seeded_reference_blobs(seed: int = 0) -> Dict[str, List[np.ndarray]]:
    """Stand-in weights at the reference shapes: kernels from caffe's
    xavier filler (U(-a, a), a = sqrt(3 / fan_in)), biases U(-0.1, 0.1)."""
    rng = np.random.RandomState(seed)
    blobs = {}
    for name, (kshape, bshape) in REFERENCE_BLOB_SHAPES.items():
        a = np.sqrt(3.0 / int(np.prod(kshape[1:])))
        blobs[name] = [rng.uniform(-a, a, kshape).astype(np.float32),
                       rng.uniform(-0.1, 0.1, bshape).astype(np.float32)]
    return blobs


def write_seeded_caffemodel(path: str, seed: int = 0) -> str:
    """Write seeded stand-in weights of the reference model to ``path``
    (a real caffemodel that :func:`load_reference_weights` accepts)."""
    return write_caffemodel(path, seeded_reference_blobs(seed))
