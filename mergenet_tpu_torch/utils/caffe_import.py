"""Caffemodel import without caffe or generated protobuf code (a copy of
`mergenet_tpu.utils.caffe_import`, which is pure numpy; the port imports
nothing of the JAX package).

Capability parity with the original caffemodel interop
(`models/pspnet_caffe.py:340-490` + the 6532-line generated
`models/caffe_pb2.py`): extract each layer's name, type, and weight blobs
from a binary `.caffemodel` (a serialized caffe NetParameter protobuf).

Instead of depending on caffe or protoc output, this module walks the
protobuf *wire format* directly — the needed subset is tiny:

    NetParameter: layer = 100 (repeated LayerParameter, V2)
                  layers = 2 (repeated V1LayerParameter)
    LayerParameter:   name = 1 (string), type = 2 (string),
                      blobs = 7 (repeated BlobProto),
                      convolution_param = 106 (ConvolutionParameter)
    V1LayerParameter: name = 4, type = 5 (enum), blobs = 6
    BlobProto:  num/channels/height/width = 1/2/3/4 (legacy dims),
                data = 5 (repeated float, packed), shape = 7 (BlobShape)
    BlobShape:  dim = 1 (repeated int64)
    ConvolutionParameter: bias_term = 2 (bool)

Returns numpy arrays; `caffemodel_to_npz` is the CLI-facing converter.
Its archive keeps the JAX package's layout (conv weights HWIO), so one
converted file serves both packages: `utils.weight_import.
apply_caffe_weights` turns the convs back to torch's OIHW.
"""

import numpy as np


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not (b & 0x80):
            return result, pos
        shift += 7


def _skip_field(buf, pos, wire_type):
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError("unsupported wire type {}".format(wire_type))
    return pos


def _iter_fields(buf):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field = key >> 3
        wt = key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError("unsupported wire type {}".format(wt))


def _parse_blob(buf):
    """BlobProto -> numpy array with its shape."""
    dims = []
    legacy = {}
    data_chunks = []
    for field, wt, val in _iter_fields(buf):
        if field in (1, 2, 3, 4) and wt == 0:
            legacy[field] = val
        elif field == 5:
            if wt == 2:  # packed floats
                data_chunks.append(np.frombuffer(val, dtype="<f4"))
            elif wt == 5:  # unpacked single float
                data_chunks.append(np.frombuffer(val, dtype="<f4"))
        elif field == 7 and wt == 2:  # BlobShape
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 0:
                        dims.append(v2)
                    elif w2 == 2:  # packed int64 varints
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            dims.append(d)
    data = (np.concatenate(data_chunks) if data_chunks
            else np.zeros((0,), np.float32))
    if not dims and legacy:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if dims and int(np.prod(dims)) == data.size:
        data = data.reshape(dims)
    return data


def _parse_conv_param(buf):
    out = {"bias_term": True}
    for field, wt, val in _iter_fields(buf):
        if field == 2 and wt == 0:  # bias_term
            out["bias_term"] = bool(val)
    return out


def _parse_layer(buf, v1=False):
    name = None
    ltype = None
    blobs = []
    conv_param = None
    name_field = 4 if v1 else 1
    type_field = 5 if v1 else 2
    blob_field = 6 if v1 else 7
    for field, wt, val in _iter_fields(buf):
        if field == name_field and wt == 2:
            name = val.decode("utf-8", "replace")
        elif field == type_field:
            if v1 and wt == 0:
                ltype = int(val)  # V1 enum
            elif not v1 and wt == 2:
                ltype = val.decode("utf-8", "replace")
        elif field == blob_field and wt == 2:
            blobs.append(_parse_blob(val))
        elif field == 106 and wt == 2 and not v1:
            conv_param = _parse_conv_param(val)
    return {"name": name, "type": ltype, "blobs": blobs,
            "convolution_param": conv_param}


def load_caffemodel(path):
    """Parse a .caffemodel into a list of layer dicts
    {name, type, blobs: [np arrays], convolution_param}."""
    with open(path, "rb") as f:
        buf = f.read()
    layers = []
    for field, wt, val in _iter_fields(buf):
        if field == 100 and wt == 2:      # V2 layer
            layers.append(_parse_layer(val, v1=False))
        elif field == 2 and wt == 2:      # V1 layers
            layers.append(_parse_layer(val, v1=True))
    return layers


def extract_weights(layers, ltypes=("BNData", "ConvolutionData",
                                    "HoleConvolutionData", "Convolution",
                                    "BatchNorm", "Scale")):
    """Flatten layers into {name: {'type': t, 'blobs': [...]}} keeping only
    weight-bearing types (reference pspnet_caffe.py:348,383-390)."""
    out = {}
    for layer in layers:
        if layer["type"] in ltypes and layer["blobs"]:
            out[layer["name"]] = {"type": layer["type"],
                                  "blobs": layer["blobs"],
                                  "convolution_param":
                                      layer["convolution_param"]}
    return out


def caffemodel_to_npz(caffemodel_path, npz_path):
    """Convert a caffemodel to an .npz of '<layer>.<i>' arrays; conv
    weights transposed OIHW -> HWIO (the JAX package's Flax layout, kept
    so the archive is the same file for both packages)."""
    layers = load_caffemodel(caffemodel_path)
    weights = extract_weights(layers)
    flat = {}
    for name, rec in weights.items():
        for i, blob in enumerate(rec["blobs"]):
            a = np.asarray(blob, np.float32)
            if a.ndim == 4:  # conv OIHW -> HWIO
                a = np.transpose(a, (2, 3, 1, 0))
            flat["{}.{}".format(name, i)] = a
    np.savez(npz_path, **flat)
    return sorted(flat)
