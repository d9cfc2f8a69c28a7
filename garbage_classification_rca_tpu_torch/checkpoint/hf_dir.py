"""Read a Hugging Face model directory without ``transformers`` or
``safetensors`` (neither is on the card's machine).

A directory as ``save_pretrained`` writes it: ``config.json``,
``generation_config.json`` (optional) and the weights, either one
``model.safetensors`` or the shards that ``model.safetensors.index.json``
names in its ``weight_map``. A safetensors file is an 8-byte
little-endian header length, a JSON header of each tensor's ``dtype``,
``shape`` and ``data_offsets`` (from the end of the header), then the raw
bytes. The file is mapped copy-on-write and each tensor is a
``torch.frombuffer`` view of it: nothing is read until a tensor is used.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Tuple

import torch

# the dtypes a transformers Llama checkpoint stores its weights in
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
SINGLE = "model.safetensors"
INDEX = "model.safetensors.index.json"


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as views of its mapping."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} is {info['dtype']}; the "
                             f"reader takes {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = end - begin
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, offset=8 + n + begin,
                             count=count // dtype.itemsize)
        out[name] = t.reshape(shape)
    return out


def read_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of `model_dir`: ``model.safetensors``, or every shard
    the index names."""
    index = os.path.join(model_dir, INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out = {}
        for shard in sorted(set(weight_map.values())):
            out.update(read_safetensors(os.path.join(model_dir, shard)))
        missing = set(weight_map) - set(out)
        if missing:
            raise ValueError(f"{index} names tensors its shards lack: "
                             f"{sorted(missing)[:5]}")
        return out
    single = os.path.join(model_dir, SINGLE)
    if os.path.isfile(single):
        return read_safetensors(single)
    raise FileNotFoundError(f"{model_dir} holds neither {SINGLE} nor {INDEX}")


def read_json(model_dir: str, name: str, required: bool = True) -> Dict:
    path = os.path.join(model_dir, name)
    if not os.path.isfile(path):
        if required:
            raise FileNotFoundError(f"{path} does not exist")
        return {}
    with open(path) as f:
        return json.load(f)


def read_model_dir(model_dir: str) -> Tuple[Dict, Dict,
                                            Dict[str, torch.Tensor]]:
    """(config, generation config or {}, state dict) of `model_dir`;
    a path that is no directory raises, as ``from_pretrained`` does."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"{model_dir} is not a model directory")
    return (read_json(model_dir, "config.json"),
            read_json(model_dir, "generation_config.json", required=False),
            read_weights(model_dir))
